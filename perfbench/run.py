#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch`` (the PyTorch
and CUDA package under test) and ``BENCHMARK.json``. It needs an NVIDIA
GPU: without one, or with fewer than the cell asks for, it exits 2 and
prints no result. See ``perfbench/harness.py``.
"""
import os
import sys
import time

T0 = time.perf_counter()  # set-up is timed from here: the imports count

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # Build and kernel caches at fixed paths inside the checkout, so that
    # only a checkout's first run of a cell builds (the CUDA kernels
    # themselves go to src/repro_torch/_build/<digest>/, which the program
    # fixes).
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from perfbench.harness import main
    sys.exit(main(sys.argv[1:], T0))
