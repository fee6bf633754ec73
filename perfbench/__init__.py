"""The benchmark of repro_torch, the PyTorch and CUDA port of SAFE.

``BENCHMARK.json`` at the repository's root names its cells and metrics;
``harness.py`` finds each by name in the files of this folder.
"""
