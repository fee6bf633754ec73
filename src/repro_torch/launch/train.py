"""Training launcher of the PyTorch port, with the JAX package's flags.

Examples:
  # SAFE-aggregated training steps at the smoke size, on the card
  python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \\
      --steps 50 --learners 4 --aggregator safe

  # federated (FedAvg, weighted SAFE delta aggregation)
  ... --federated --local-steps 4

  # on the CPU
  ... --device cpu

  # across processes: W ranks, a card each (nccl), or on the CPU (gloo);
  # the reference's default layout, 4 learners x 2 model shards
  python -m torch.distributed.run --nproc-per-node 8 -m repro_torch.launch.train \
      --arch internlm2-1.8b --smoke --steps 50 --learners 4 --model-shards 2
  ... --model-shards 1              # one learner a rank
  ... --device cpu                  # gloo

On one process the learners are dim 0 of one device, so the model axis is
1: ``--model-shards`` is accepted, so the reference's command lines run,
and does nothing. Under ``torch.distributed.run`` (``RANK`` and
``WORLD_SIZE`` in the environment) the ranks form the reference's
('data', 'model') grid: ``WORLD_SIZE`` must be learners · m (m =
``--model-shards``, the reference's default 2) and is refused otherwise;
the learners are ``WORLD_SIZE / m`` (``--learners``, given, must say so),
and rank l·m + j is learner l's model shard j. With m = 1 each rank is
one learner. With m > 1 each learner's model is split over its m ranks
by Megatron tensor parallelism (``Model(cfg, tp_world=...)``; every block
kind: the attention kinds and the MLP, the MoE's expert-ff and shared
experts, Mamba2 and RWKV6 by head, zamba2's shared block) and SAFE runs
one ring per model shard over its chunk of the gradient (the reference's
``chain_model_sharded``). Each rank makes only its own learner's
batches, steps with the per-rank train step (ZeRO-1: it holds its part
of the master vector and moments) or FedAvg round, and prints the same
lines with its rank; rank 0 writes the checkpoint, its parts gathered
from every rank into the one-process format (full leaves, whole
vectors), and a resume gives each rank its part back, so a checkpoint
restores across m = 2 and one process. Every aggregation round takes fresh counter space from
``SecureAggregator.reserve_round``, given the round's words:
``padded_size + 2`` a train step and ``P + 1`` a weighted FedAvg round
(half as many Threefry counters: each counter pads two words), where the
reference launcher gives ``(step % 2000) * (padded_size + 2)`` and
``r * 2**20`` and so reuses pads. When the 2^32 counters of the keys run
out the launcher stops with the allocator's refusal (a key rotation is
then due). A checkpoint records the next free counter in its ``extra``
map, so a resumed run continues the counters of the run it resumes.

A configuration with expert leaves (MoE) trains its experts by expert
parallelism over the learners (``ep_axis="data"``, ``ep_ranks`` the
learner count), as the reference's dry run sets it for the giant MoEs;
the train step refuses a MoE without it. FedAvg needs none. Across ranks
each rank holds its E/n experts (``Model(cfg, ep_world=world)``) and
exchanges tokens with the others; rank 0 gathers the expert shards and
their ``ep_opt`` moments into host memory, a rank at a time, so the
checkpoint has the one-process (the reference's full-E) layout, and a
resume gives each rank its experts back. With model shards a MoE's ring
j spreads the experts over the learners and each rank holds [E/n, d,
f/m] of every expert matrix (``Model(cfg, ep_world=ring, tp_world=...)``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the configuration to this many layers (a whole number of its "
                         "pattern; the dry run's --per-rank sizes what fits a card a rank)")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch-per-learner", type=int, default=2)
    ap.add_argument("--learners", type=int, default=None,
                    help="learners (default 4; the world size under torch.distributed.run)")
    ap.add_argument("--model-shards", type=int, default=2,
                    help="model ranks a learner under torch.distributed.run (WORLD_SIZE = "
                         "learners x model shards); accepted and unused in one process")
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


def _distributed() -> bool:
    """True under torch.distributed.run (a rank a learner's model shard)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def run(args: argparse.Namespace) -> dict:
    """Train as ``args`` say; returns {"losses", "counters", "params",
    "state"} (``state`` None for ``--federated``), the losses and the
    counters of the steps this run took."""
    import numpy as np
    import torch

    from repro_torch.ckpt import latest_step
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import make_aggregator
    from repro_torch.data import make_federated_batches
    from repro_torch.models import Model
    from repro_torch.train import (MetricsLogger, make_federated_round,
                                   make_train_step, tree_size)

    world = grid = tp = None
    if _distributed():
        from repro_torch.dist import grid_worlds, init_world
        m = args.model_shards
        size = int(os.environ["WORLD_SIZE"])
        if m < 1 or size % m or args.learners not in (None, size // m):
            raise SystemExit(
                f"WORLD_SIZE {size} with --model-shards {m}"
                + (f" and --learners {args.learners}" if args.learners else "")
                + ": under torch.distributed.run WORLD_SIZE must be learners x model shards")
        grid = init_world(device=args.device)
        world, tp = grid_worlds(grid, m)
        args.learners = world.size
        dev = grid.device
        print(f"repro_torch.launch.train: {args.arch}{' (smoke)' if args.smoke else ''}; "
              f"rank {grid.rank} of {grid.describe()}; learner {world.rank} of "
              f"{world.size} (WORLD_SIZE {size} / {m} model shards), model shard "
              f"{0 if tp is None else tp.rank} of {m}, on {dev}", flush=True)
    else:
        args.learners = 4 if args.learners is None else args.learners
        dev = torch.device(args.device)
        print(f"repro_torch.launch.train: {args.arch}{' (smoke)' if args.smoke else ''} on "
              f"{dev}; {args.learners} learners as dim 0 of one device, so the model axis "
              f"is 1 on one card (--model-shards {args.model_shards} not used)", flush=True)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if cfg.uses_moe and cfg.ep_axis is None and not args.federated:
        cfg = dataclasses.replace(cfg, ep_axis="data", ep_ranks=args.learners)
    ep_world = world if cfg.ep_axis is not None else None  # a rank holds its E/n experts
    cuda = dev.type == "cuda"
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    model = Model(cfg, device=dev, ep_world=ep_world, tp_world=tp,
                  generator=torch.Generator(device=dev).manual_seed(args.seed))
    agg = make_aggregator(args.aggregator, args.learners, axis="data",
                          pipelined=args.pipelined, subgroups=args.subgroups,
                          weighted=args.federated, device=dev)
    stream = make_federated_batches(cfg, args.learners, args.batch_per_learner,
                                    args.seq_len, seed=args.seed)
    lead = grid is None or grid.rank == 0  # logs the metrics, writes checkpoints
    log = MetricsLogger((args.metrics or None) if lead else None)
    log_step = log.log if lead else (lambda step, **metrics: None)
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
            bundle = make_federated_round(model, agg, world, local_steps=args.local_steps,
                                          local_lr=args.lr)
            params = model.tree()
            # the words a weighted round pads
            words = (bundle.padded_size or tree_size(params)) + 1
            mine = range(args.learners) if world is None else [world.rank]
            if cuda:  # the rounds' peak, after the set-up's
                torch.cuda.reset_peak_memory_stats(dev)
            for r in range(args.steps):
                toks = np.stack([
                    np.stack([stream.learner_batch(l, r * args.local_steps + k)
                              ["tokens"] for k in range(args.local_steps)])
                    for l in mine])
                weights = np.asarray([stream.learner_batch(l, r)["weight"]
                                      for l in range(args.learners)], np.float32)
                counters.append(reserve(words))
                params, m = bundle.round_fn(
                    params, torch.from_numpy(toks if world is None else toks[0]).to(dev),
                    weights=weights, counter=counters[-1], alive=alive_at(r))
                losses.append(float(m["local_loss"]))
                log_step(r, **{k: float(v) for k, v in m.items()})
        else:
            bundle = make_train_step(model, agg, world, lr=args.lr)
            words = bundle.padded_size + 2  # the words a step pads
            state = bundle.init_state_fn(model.tree())
            start = 0
            if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
                state, extra = _restore(args.ckpt_dir, s, state, bundle, world,
                                        model.ep_world, grid, model)
                start = int(extra.get("step", s))
                # continue the counters of the run that wrote the checkpoint
                agg.reserve_counters(int(extra.get("counter",
                                                   start * agg.round_counters(words))))
                print(f"resumed from step {start}", flush=True)
            if cuda:  # the steps' peak, after the set-up's
                torch.cuda.reset_peak_memory_stats(dev)
            for step in range(start, args.steps):
                toks = (stream.global_batch(step)["tokens"] if world is None
                        else stream.learner_batch(world.rank, step)["tokens"])
                counters.append(reserve(words))
                state, m = bundle.step_fn(state, torch.from_numpy(toks).to(dev),
                                          counter=counters[-1], alive=alive_at(step))
                losses.append(float(m["loss"]))
                log_step(step, loss=losses[-1], grad_scale=float(m["grad_scale"]))
                if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                    _save(args.ckpt_dir, step + 1, state, bundle, world, model.ep_world,
                          grid, model, extra={"step": step + 1,
                                 "counter": counters[-1] + agg.round_counters(words)})
            params = state["params"]
    finally:
        log.close()
        if world is not None:
            from repro_torch.dist import close_world
            close_world()
    # the steps' (or rounds') peak above what the process held before the
    # model: what the dry run's --per-rank record sizes
    peak = (f"; peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, the steps' "
            f"peak {(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.3f} GB" if cuda else "")
    print(f"done in {time.time() - t0:.1f}s{peak}", flush=True)
    return {"losses": losses, "counters": counters, "params": params, "state": state}


_SLICED = ("master", "fm", "fv")  # the ZeRO-1 state a rank holds a slice of


def _save(directory: str, step: int, state: dict, bundle, world, ep_world, grid, model,
          extra: dict) -> None:
    """One process writes its state. Across ranks, rank 0 gathers the
    slices, (with ``ep_world``) the expert shards and their moments, and
    (with model shards) the leaves' shards into host memory, a rank's at a
    time, and writes the one-process state (the reference's format and
    full-E layout); the others wait until it has."""
    from repro_torch.ckpt import save_checkpoint
    if world is None:
        save_checkpoint(directory, step, state, extra=extra)
        return
    import torch.distributed as dist

    from repro_torch.dist import collectives
    if model.tp_world is not None:
        from repro_torch.ckpt.checkpoint import gather_tp_state
        full = gather_tp_state(state, model.shard_layout(), bundle.sec_size, world,
                               model.tp_world, grid, ep=ep_world is not None)
        if grid.rank == 0:
            save_checkpoint(directory, step, full, extra=extra)
        del full
        dist.barrier()
        return
    from repro_torch.train.flatten import is_expert_path, leaves_with_paths, tree_unflatten
    full = dict(state)
    if not bundle.leafwise:
        for k in _SLICED:
            full[k] = collectives.gather_to_host(state[k], 0, world)
    if ep_world is not None:  # every rank walks the same leaves in the same order
        full = tree_unflatten(full, [
            collectives.gather_to_host(leaf, 0, ep_world, axis=1) if is_expert_path(path)
            else leaf for path, leaf in leaves_with_paths(full)])
    if world.rank == 0:
        save_checkpoint(directory, step, full, extra=extra)
    del full
    dist.barrier()


def _restore(directory: str, step: int, state: dict, bundle, world, ep_world, grid,
             model) -> tuple:
    """Restore a checkpoint; across ranks each rank reads the one-process
    state into host memory and moves its slices (its experts, its shards)
    to its device."""
    from repro_torch.ckpt import restore_checkpoint
    if model.tp_world is not None:
        from repro_torch.ckpt.checkpoint import shard_tp_state, tp_skeleton
        layout, ep = model.shard_layout(), ep_world is not None
        full, extra = restore_checkpoint(directory, step, tp_skeleton(
            state, layout, bundle.sec_size, world, ep))
        return shard_tp_state(full, state, layout, bundle.sec_size, bundle.padded_size,
                              world, model.tp_world, ep), extra
    if world is None or (bundle.leafwise and ep_world is None):
        return restore_checkpoint(directory, step, state)
    import torch

    from repro_torch.convert import shard_experts
    from repro_torch.train.flatten import (is_expert_path, leaves, leaves_with_paths,
                                           tree_unflatten)
    skeleton = dict(state)
    if not bundle.leafwise:
        for k in _SLICED:
            skeleton[k] = torch.zeros(bundle.padded_size, dtype=state[k].dtype)
    if ep_world is not None:  # the full-E expert leaves, on the host
        skeleton = tree_unflatten(skeleton, [
            torch.zeros((t.shape[0], t.shape[1] * ep_world.size) + tuple(t.shape[2:]),
                        dtype=t.dtype) if is_expert_path(path) else t
            for path, t in leaves_with_paths(skeleton)])
    full, extra = restore_checkpoint(directory, step, skeleton)
    if not bundle.leafwise:
        n = bundle.padded_size // world.size
        for k in _SLICED:
            full[k] = full[k][world.rank * n:(world.rank + 1) * n].to(state[k].device,
                                                                      copy=True)
    if ep_world is not None:
        full = shard_experts(full, ep_world.rank, ep_world.size)
        full = tree_unflatten(full, [
            t.to(like.device, copy=True) if is_expert_path(path) else t
            for (path, t), like in zip(leaves_with_paths(full), leaves(state))])
    return full, extra


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
