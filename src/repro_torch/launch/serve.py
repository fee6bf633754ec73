"""Serving launcher of the PyTorch port: batched decode over a smoke-size
model, with the JAX package's flags and its report line.

  python -m repro_torch.launch.serve --arch qwen3-14b --requests 8 --max-new 32

  # on the CPU
  ... --device cpu

The model is the configuration's smoke size, its weights random from
``--seed``; prompts are ``RandomState(seed).randint(4, 32)`` tokens long,
as the reference draws them.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Serve as ``args`` say and print the report line; returns {"engine",
    "requests", "seconds"}."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.serve import Request, ServeEngine

    dev = torch.device(args.device)
    cfg = get_smoke_config(args.arch)
    model = Model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))
    eng = ServeEngine(model, model.tree(), batch_slots=args.slots, max_seq=args.max_seq,
                      temperature=args.temperature, seed=args.seed)
    rng = np.random.RandomState(args.seed)
    reqs = []
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.randint(4, 32))
        reqs.append(Request(rid=i, prompt=rng.randint(0, cfg.vocab, plen).astype(np.int32),
                            max_new=args.max_new))
        eng.submit(reqs[-1])
    eng.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    total_tokens = args.requests * args.max_new
    print(f"served {args.requests} requests / {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens/dt:.1f} tok/s, {eng.steps} decode steps, "
          f"batch efficiency {total_tokens/max(eng.steps*args.slots,1):.2f})", flush=True)
    return {"engine": eng, "requests": reqs, "seconds": dt}


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
