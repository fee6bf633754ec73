"""The JAX package's five examples on the port, each run as ``python -m
repro_torch.examples.<name>``: ``quickstart``, ``failover_demo``,
``federated_training``, ``serving`` and ``kernels_demo``. Each module's
``main(argv=None)`` runs it on the card, or on the CPU with ``--device
cpu``; ``SAFE_SMOKE=1`` shrinks the run as the reference's scripts do. An
example that finds no card stops; it never goes on on the CPU.
"""
from __future__ import annotations

import argparse
import os

import torch


def smoke() -> bool:
    """Whether ``SAFE_SMOKE`` asks for the short run."""
    return bool(os.environ.get("SAFE_SMOKE"))


def device_arg(description: str, argv=None) -> torch.device:
    """The ``--device`` an example was given (``cuda`` by default); with
    ``cuda`` and no card, the example stops."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the example runs (default: the card)")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device; --device cpu runs the example on the CPU")
    return device
