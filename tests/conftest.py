import os
import sys

# make `from helpers import run_multidevice` work regardless of rootdir
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    # container without hypothesis: register the deterministic fallback
    import _hypothesis_fallback

    sys.modules["hypothesis"] = _hypothesis_fallback
    sys.modules["hypothesis.strategies"] = _hypothesis_fallback.strategies



def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


# Do NOT set XLA device-count flags here: the main test process must see
# exactly one device (multi-device tests spawn subprocesses — helpers.py).
