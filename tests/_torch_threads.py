"""The intra-op threads of a port test module: ``from _torch_threads
import _few_threads`` makes the fixture autouse in the importing module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs test files in parallel
    processes, and several processes' full sets of spinning OpenMP threads
    on the same cores slow every file down many times over (the blockwise
    attention at 4097 tokens took 117 s of one whole run at the default)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
