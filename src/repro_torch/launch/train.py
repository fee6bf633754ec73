"""Training launcher of the PyTorch port, with the JAX package's flags.

Examples:
  # SAFE-aggregated training steps at the smoke size, on the card
  python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \\
      --steps 50 --learners 4 --aggregator safe

  # federated (FedAvg, weighted SAFE delta aggregation)
  ... --federated --local-steps 4

  # on the CPU
  ... --device cpu

The learners are dim 0 of one device, so the model axis is 1:
``--model-shards`` is accepted, so the reference's command lines run, and
does nothing. Every aggregation round takes fresh counter space from
``SecureAggregator.reserve_round``: ``padded_size + 2`` words a train step
and ``P + 1`` a weighted FedAvg round, where the reference launcher gives
``(step % 2000) * (padded_size + 2)`` and ``r * 2**20`` and so reuses pads.
When the 2^32-word space of the keys runs out the launcher stops with the
allocator's refusal (a key rotation is then due). A checkpoint records the
next free counter word in its ``extra`` map, so a resumed run continues
the counters of the run it resumes.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch-per-learner", type=int, default=2)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--model-shards", type=int, default=2,
                    help="accepted for the reference's command lines; one card has "
                         "no model axis")
    ap.add_argument("--aggregator", default="safe",
                    choices=["safe", "saf", "insec", "bon"])
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--subgroups", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--federated", action="store_true")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--fail-learners", default="",
                    help="comma-separated learner ranks to mark dead (failover demo)")
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train as ``args`` say; returns {"losses", "counters", "params",
    "state"} (``state`` None for ``--federated``), the losses and the
    counters of the steps this run took."""
    import numpy as np
    import torch

    from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    from repro_torch.train import (MetricsLogger, make_federated_round,
                                   make_train_step, tree_size)

    dev = torch.device(args.device)
    print(f"repro_torch.launch.train: {args.arch}{' (smoke)' if args.smoke else ''} on "
          f"{dev}; {args.learners} learners as dim 0 of one device, so the model axis "
          f"is 1 on one card (--model-shards {args.model_shards} not used)", flush=True)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(args.seed))
    agg = make_aggregator(args.aggregator, args.learners, axis="data",
                          pipelined=args.pipelined, subgroups=args.subgroups,
                          weighted=args.federated, device=dev)
    stream = make_federated_batches(cfg, args.learners, args.batch_per_learner,
                                    args.seq_len, seed=args.seed)
    log = MetricsLogger(args.metrics or None)
    dead = {int(x) for x in args.fail_learners.split(",") if x}

    def alive_at(step):
        alive = np.ones(args.learners, np.float32)
        if dead and (args.fail_at_step < 0 or step >= args.fail_at_step):
            alive[list(dead)] = 0.0
        return alive

    losses, counters, state = [], [], None

    def reserve(words):
        """The next round's counter range; stops at the allocator's refusal
        (never wrap, never reuse a pad)."""
        try:
            return agg.reserve_round(words)
        except OverflowError as e:
            raise SystemExit(f"stopped after {len(counters)} rounds of this run: {e}") from e

    t0 = time.time()
    try:
        if args.federated:
            bundle = make_federated_round(model, agg, local_steps=args.local_steps,
                                          local_lr=args.lr)
            params = model.tree()
            words = tree_size(params) + 1  # counter words of a weighted round
            for r in range(args.steps):
                toks = np.stack([
                    np.stack([stream.learner_batch(l, r * args.local_steps + k)
                              ["tokens"] for k in range(args.local_steps)])
                    for l in range(args.learners)])
                gb = stream.global_batch(r)
                counters.append(reserve(words))
                params, m = bundle.round_fn(params, torch.from_numpy(toks).to(dev),
                                            weights=gb["weights"], counter=counters[-1],
                                            alive=alive_at(r))
                losses.append(float(m["local_loss"]))
                log.log(r, **{k: float(v) for k, v in m.items()})
        else:
            bundle = make_train_step(model, agg, lr=args.lr)
            words = bundle.padded_size + 2  # counter words of one step
            state = bundle.init_state_fn(model.tree())
            start = 0
            if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
                state, extra = restore_checkpoint(args.ckpt_dir, s, state)
                start = int(extra.get("step", s))
                # continue the counters of the run that wrote the checkpoint
                reserve(int(extra.get("counter", start * words)))
                print(f"resumed from step {start}", flush=True)
            for step in range(start, args.steps):
                gb = stream.global_batch(step)
                counters.append(reserve(words))
                state, m = bundle.step_fn(state, torch.from_numpy(gb["tokens"]).to(dev),
                                          counter=counters[-1], alive=alive_at(step))
                losses.append(float(m["loss"]))
                log.log(step, loss=losses[-1], grad_scale=float(m["grad_scale"]))
                if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                    save_checkpoint(args.ckpt_dir, step + 1, state,
                                    extra={"step": step + 1,
                                           "counter": counters[-1] + words})
            params = state["params"]
    finally:
        log.close()
    print(f"done in {time.time() - t0:.1f}s", flush=True)
    return {"losses": losses, "counters": counters, "params": params, "state": state}


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
