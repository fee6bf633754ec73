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


def _smoke_models(cuda, dtype="float32"):
    """The f32 smoke model on the CPU and the same weights on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype=dtype)
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.cuda
def test_cuda_local_update_matches_cpu(cuda):
    """The FedAvg local update (2 AdamW steps) at the smoke size on the
    card against the CPU, f32 (TF32 off): relative L2 of the delta within
    1e-4, the bound the CPU tests hold the port to against the JAX
    package; the mean loss within 1e-5 relative."""
    from repro_torch.train import make_local_update
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, card = _smoke_models(cuda)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (2, 2, 32)))
    d_cpu, l_cpu = make_local_update(cpu, local_steps=2)(cpu.tree(), toks)
    d_card, l_card = make_local_update(card, local_steps=2)(card.tree(), toks.to(cuda))
    assert d_card.is_cuda and d_card.dtype == torch.float32
    d_card = d_card.cpu().double()
    assert float((d_card - d_cpu.double()).norm() / d_cpu.double().norm()) <= 1e-4
    np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("alive", [[1, 1, 1, 1], [1, 0, 1, 1], [0, 1, 1, 1]])
def test_cuda_fedavg_aggregation_equal_cpu(cuda, alive):
    """The weighted round of four learners' deltas at the smoke model's
    size (P + 1 words, odd, so rows 1 and 3 of the payload start on an odd
    word) launches the kernels and is torch.equal to the CPU path."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import tree_size
    _, cpu, _ = _smoke_models(cuda)
    P = tree_size(cpu.tree())
    deltas = torch.from_numpy(np.random.RandomState(1).normal(0, 1e-3, (4, P)).astype(np.float32))
    w = np.array([1000, 1500, 2000, 2500], np.float32)
    before = dict(build.launches)
    got = make_aggregator("safe", 4, weighted=True).aggregate(
        deltas.to(cuda), 3 * (P + 1), alive=alive, weights=w)
    assert build.launches["mask_add"] == before["mask_add"] + 3
    # a dead learner keeps its place on the ring: n - 1 hops whatever dies
    assert build.launches["chain_combine"] == before["chain_combine"] + 3
    want = make_aggregator("safe", 4, weighted=True, device="cpu").aggregate(
        deltas, 3 * (P + 1), alive=alive, weights=w)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_federated_round_matches_cpu(cuda):
    """One whole weighted FedAvg round on the card against the CPU, f32:
    the published delta within 1e-4 relative L2, new parameters finite."""
    from repro_torch.core import make_aggregator
    from repro_torch.train import make_federated_round, tree_to_flat
    cfg, cpu, card = _smoke_models(cuda)
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab, (4, 2, 2, 32)))
    w = np.array([1000, 1500, 2000, 2500], np.float32)
    out = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        bundle = make_federated_round(model, make_aggregator("safe", 4, weighted=True,
                                                             device=dev),
                                      local_steps=2, return_delta=True)
        params, m = bundle.round_fn(model.tree(), toks, weights=w, counter=0)
        assert bool(torch.isfinite(tree_to_flat(params)).all())
        out.append(m["avg_delta"].cpu().double())
    assert float((out[1] - out[0]).norm() / out[0].norm()) <= 1e-4
