"""pytest settings of the benchmark's own tests (``test_perfbench_*.py``)."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


@pytest.fixture
def cuda_device():
    """The card, for a test marked ``cuda``; skips where there is none (decided
    here, when the test runs, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs in several worker
    processes at once, and PyTorch's default of one thread a core each
    makes them contend."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)
