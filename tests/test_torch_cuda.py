"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where torch sees no GPU. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bon_mask as bm
from repro_torch.kernels import build, ref
from repro_torch.kernels import chain_combine as cc
from repro_torch.kernels import threefry_mask_add as tma


def _u32(rng, shape):
    return rng.randint(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1, 2, 5, 129, 100_001])
@pytest.mark.parametrize("base", [0, 2**32 - 5])
def test_cuda_kernels_equal_plain(cuda, V, base):
    g = torch.Generator(device=cuda).manual_seed(V)
    x = torch.rand(V + 1, generator=g, device=cuda) * 200 - 100
    c = torch.randint(-2**31, 2**31, (V + 1,), generator=g, device=cuda,
                      dtype=torch.int32).view(torch.uint32)
    key, kin, kout = [5, 6], [11, 22], [33, 44]
    for xs, cs in [(x[:V], c[:V]), (x[1:], c[1:])]:  # 8-byte aligned, then not
        assert torch.equal(tma.mask_add(xs, key, base), ref.mask_add_ref(xs, key, base))
        assert torch.equal(cc.chain_combine(cs, xs, kin, kout, base),
                           ref.chain_combine_ref(cs, xs, kin, kout, base))


@pytest.mark.cuda
@pytest.mark.parametrize("S,V", [(1, 1), (8, 129), (8, 100_001), (130, 129)])
def test_cuda_batched_equal_plain(cuda, S, V):
    rng = np.random.RandomState(S + V)
    cipher = torch.from_numpy(_u32(rng, (S, V))).to(cuda)
    x = torch.from_numpy(rng.uniform(-50, 50, (S, V)).astype(np.float32)).to(cuda)
    kin, kout, bases = _u32(rng, (S, 2)), _u32(rng, (S, 2)), _u32(rng, (S,))
    bases[0] = 2**32 - 5
    before = build.launches["chain_combine_batched"]
    got = cc.chain_combine_batched(cipher, x, kin, kout, bases)
    assert build.launches["chain_combine_batched"] == before + -(-S // cc.MAX_ROWS)
    assert torch.equal(got, ref.chain_combine_batched_ref(cipher, x, kin, kout, bases))


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1, 2, 5, 129, 100_001])
@pytest.mark.parametrize("offset", [1, 2, 5, 466_035])
def test_cuda_mask_add_at_a_word_offset(cuda, V, offset):
    """Pads that start mid-block (odd offset) or on a block, on aligned and
    odd-word views."""
    g = torch.Generator(device=cuda).manual_seed(V + offset)
    x = torch.rand(V + 1, generator=g, device=cuda) * 200 - 100
    for xs in (x[:V], x[1:]):
        for base in (0, 2**32 - 5):
            assert torch.equal(tma.mask_add(xs, [5, 6], base, offset=offset),
                               ref.mask_add_ref(xs, [5, 6], base, offset=offset))


@pytest.mark.cuda
@pytest.mark.parametrize("S,V,seg", [(8, 5, 5), (36, 129, 129), (36, 100_001, 100_001),
                                     (130, 7, 3)])
def test_cuda_batched_rows_at_start_words(cuda, S, V, seg):
    """The pipelined step: row s's pads start at word s·seg."""
    rng = np.random.RandomState(S + V)
    cipher = torch.from_numpy(_u32(rng, (S, V))).to(cuda)
    x = torch.from_numpy(rng.uniform(-50, 50, (S, V)).astype(np.float32)).to(cuda)
    kin, kout = _u32(rng, (S, 2)), _u32(rng, (S, 2))
    bases, starts = np.full(S, 2**32 - 5, np.uint32), np.arange(S) * seg
    got = cc.chain_combine_batched(cipher, x, kin, kout, bases, starts=starts)
    assert torch.equal(got, ref.chain_combine_batched_ref(cipher, x, kin, kout, bases,
                                                          starts=starts))


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1, 5, 129, 100_001])
@pytest.mark.parametrize("m", [0, 1, 2, 36, 1100])
def test_cuda_bon_mask_equal_plain(cuda, V, m):
    """Any m: 1100 keys take two passes through the kernel's shared-memory
    key tile."""
    rng = np.random.RandomState(V + m)
    keys, signs = _u32(rng, (m, 2)), rng.choice([-1, 1], m)
    g = torch.Generator(device=cuda).manual_seed(V)
    x = torch.rand(V + 1, generator=g, device=cuda) * 200 - 100
    before = build.launches["bon_mask"]
    for xs in (x[:V], x[1:]):
        for base in (0, 2**32 - 5):
            assert torch.equal(bm.bon_mask(xs, keys, signs, base),
                               ref.bon_mask_ref(xs, keys, signs, base))
    assert build.launches["bon_mask"] == before + 4
