"""The PyTorch port on the card: its CUDA kernels against their plain
versions, and FedAvg, FlatAdamW, the train step and serving against the
CPU path.

Every test here is marked ``cuda`` and skips where torch sees no GPU. The
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bon_mask as bm
from repro_torch.kernels import build, ops, ref  # ops: defines torch.ops.repro_torch
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
@pytest.mark.parametrize("V", [1, 5, 129, 100_001])
@pytest.mark.parametrize("start", [2, 466_036, 2**31 + 2])
def test_cuda_chunk_at_an_even_start_word(cuda, V, start):
    """A model-sharded ring's chunk of odd length V from an even start word
    s (``aggregate_rank(model_world=)``): the counter base moved by s/2 is
    the pad from word s of the whole vector, for mask_add, chain_combine and
    bon_mask, each equal to its plain version (the counter wrapping 2^32)."""
    g = torch.Generator(device=cuda).manual_seed(V + start % 1000)
    x = torch.rand(V, generator=g, device=cuda) * 200 - 100
    c = torch.randint(-2**31, 2**31, (V,), generator=g, device=cuda,
                      dtype=torch.int32).view(torch.uint32)
    for base in (0, 2**32 - 5):
        moved = (base + start // 2) & 0xFFFFFFFF
        want = ref.mask_add_ref(x, [5, 6], base, offset=start)
        assert torch.equal(tma.mask_add(x, [5, 6], moved), want)
        assert torch.equal(tma.mask_add(x, [5, 6], base, offset=start), want)
        assert torch.equal(cc.chain_combine(c, x, [11, 22], [33, 44], moved),
                           ref.chain_combine_ref(c, x, [11, 22], [33, 44], base, offset=start))
        keys, signs = [[1, 2], [3, 4], [5, 6]], [1, -1, 1]
        assert torch.equal(bm.bon_mask(x, keys, signs, moved),
                           ref.bon_mask_ref(x, keys, signs, moved))


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


@pytest.mark.cuda
def test_cuda_flat_adamw_equals_cpu(cuda):
    """FlatAdamW on the card, three steps on 2^20 random words (gradients
    from 1e-6 to 10, some exactly zero): the parameters and both moments
    equal the CPU path's — which equals the JAX package's
    (tests/test_torch_launch.py) — on every word, in place and not. This
    rests on CUDA's f32 square root and division being correctly rounded,
    as PyTorch builds them (no fast math)."""
    from repro_torch.optim import FlatAdamW
    rng = np.random.RandomState(0)
    n = 1 << 20
    param = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32)
             * 10.0 ** rng.uniform(-6, 1, n).astype(np.float32) for _ in range(3)]
    grads[1][:100] = 0.0
    opt = FlatAdamW(lr=1e-3, weight_decay=0.1)
    cs, cp = opt.init(n, device="cpu"), torch.from_numpy(param.copy())
    gs, gp = opt.init(n, device=cuda), torch.from_numpy(param.copy()).to(cuda)
    i_s, ip = opt.init(n, device=cuda), torch.from_numpy(param.copy()).to(cuda)
    for g in grads:
        cp, cs = opt.update(torch.from_numpy(g), cs, cp)
        gp, gs = opt.update(torch.from_numpy(g).to(cuda), gs, gp)
        ip, i_s = opt.update(torch.from_numpy(g).to(cuda), i_s, ip, inplace=True)
        for a, b in ((gp, cp), (gs.m, cs.m), (gs.v, cs.v), (ip, cp), (i_s.m, cs.m)):
            assert torch.equal(a.cpu(), b)


class _Watched:
    """An aggregator that keeps the gradient matrix it was handed and the
    mean it published."""

    def __init__(self, agg):
        self.agg, self.cfg, self.seen = agg, agg.cfg, None

    def aggregate(self, values, counter_base=0, alive=None, weights=None, domain=0, rotate=0):
        out = self.agg.aggregate(values, counter_base, alive=alive, weights=weights,
                                 domain=domain, rotate=rotate)
        self.seen = (values.clone(), counter_base, alive, rotate, out)
        return out


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.cpu().double(), want.cpu().double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


# Bounds of the card's f32 train step against the CPU's. Measured on an
# NVIDIA H100 80GB HBM3 at 700 W, worst of the four models: the loss 7.6e-8
# relative, the gradient matrix 1.1e-5 relative L2 (rwkv6; 1.4e-6 to 2.0e-6
# for the others), the published mean 5.7e-5 (a gradient word that differs
# in rounding can land one fixed-point step away), the parameters' change
# 1.8e-3 (a first AdamW step moves a word by about ±lr whatever the size of
# its gradient, so a near-zero gradient that differs by an ulp moves its
# word the other way), the MoE's ep_opt m and v 1.9e-6. The bounds sit 4x
# to 13x above.
CARD_LOSS_RTOL = 1e-6
CARD_REL_GRADS = 5e-5     # the gradient matrix the SAFE call was handed
CARD_REL_MEAN = 2.5e-4    # the published mean
CARD_REL_DELTA = 1e-2     # the parameters' change
CARD_REL_EP = 1e-5        # the MoE's ep_opt m and v (v tells a sum from a mean)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-235b-a22b", "zamba2-2.7b",
                                  "rwkv6-1.6b"])
def test_cuda_train_step_matches_cpu(cuda, arch):
    """One SAFE train step of the f32 smoke model on the card against the
    same step on the CPU (the MoE by expert parallelism): the SAFE call on
    the card's own gradient matrix, rerun on the CPU path, is bit-identical
    to what the card published; the loss agrees within CARD_LOSS_RTOL; the
    gradient matrix, the published mean and the parameters' change agree
    within their relative-L2 bounds, and for the MoE so do the expert
    update's moments, which a mean instead of the sum would move 16-fold
    (v); every parameter within 2·lr besides."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import make_aggregator
    from repro_torch.models import Model
    from repro_torch.train import make_train_step, tree_to_flat
    lr = 1e-3
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.uses_moe:
        cfg = dataclasses.replace(cfg, ep_axis="data", ep_ranks=4)
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    init = tree_to_flat(cpu.tree()).clone()
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab, (4, 2, 64)))
    out = {}
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        agg = _Watched(make_aggregator("safe", 4, device=dev))
        bundle = make_train_step(model, agg, lr=lr)
        state, m = bundle.step_fn(bundle.init_state_fn(model.tree()), toks, counter=12345)
        ep = state["ep_opt"]
        out["cpu" if dev == "cpu" else "card"] = dict(
            loss=float(m["loss"]), params=tree_to_flat(state["params"]).cpu(), seen=agg.seen,
            ep=None if ep is None else (tree_to_flat(ep.m).cpu(), tree_to_flat(ep.v).cpu()))
    c, g = out["cpu"], out["card"]
    values, counter, alive, rotate, published = g["seen"]
    assert values.is_cuda and published.is_cuda
    again = make_aggregator("safe", 4, device="cpu").aggregate(values.cpu(), counter,
                                                              alive=alive, rotate=rotate)
    assert torch.equal(again, published.cpu())
    readings = {"loss": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
                "grads": _rel_l2(values, c["seen"][0]),
                "mean": _rel_l2(published, c["seen"][4]),
                "delta": _rel_l2(g["params"] - init, c["params"] - init)}
    if cfg.uses_moe:
        readings["ep_m"] = _rel_l2(g["ep"][0], c["ep"][0])
        readings["ep_v"] = _rel_l2(g["ep"][1], c["ep"][1])
    print(f"card vs cpu, {arch}: {readings}")
    assert readings["loss"] <= CARD_LOSS_RTOL
    assert readings["grads"] <= CARD_REL_GRADS
    assert readings["mean"] <= CARD_REL_MEAN
    assert readings["delta"] <= CARD_REL_DELTA
    if cfg.uses_moe:
        assert max(readings["ep_m"], readings["ep_v"]) <= CARD_REL_EP
    assert float((g["params"] - c["params"]).abs().max()) <= 2 * lr


# Serving, card against CPU in f32: logits within this share of the CPU's
# max |logit|, the bound the CPU tests hold the port to against the JAX
# package (tests/test_torch_serve.py).
CARD_SERVE_TOL = 1e-3
SERVE_ARCHS = {"internlm2-1.8b": {}, "gemma3-12b": {"window": 8, "chunk": 8},
               "zamba2-2.7b": {}, "qwen3-moe-235b-a22b": {}}


def _serve_models(cuda, arch, **kw):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(SERVE_ARCHS))
def test_cuda_prefill_then_decode_matches_cpu(cuda, arch):
    """f32 smoke models (gemma3 with window = chunk = 8, so its local
    layer's ring buffer wraps twice): prefill 8 tokens, decode to 24; each
    step's logits within CARD_SERVE_TOL x max |logit| of the CPU's, and the
    last cache's leaves of the CPU's dtypes, pos equal."""
    cfg, cpu, card = _serve_models(cuda, arch, **SERVE_ARCHS[arch])
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab, (2, 24)))
    out = {}
    with torch.inference_mode():
        for name, m in (("cpu", cpu), ("card", card)):
            t = toks.to(m.embed.device)
            logits, cache = m.prefill(m.tree(), t[:, :8], cache=m.init_cache(2, 24, False))
            rows = [logits.cpu()]
            for i in range(8, 24):
                logits, cache = m.decode_step(m.tree(), t[:, i], cache)
                rows.append(logits.cpu())
            out[name] = (torch.stack(rows), cache)
    (lc, cc), (lg, cg) = out["cpu"], out["card"]
    scale = float(lc.abs().max())
    err = float((lg - lc).abs().max())
    print(f"card vs cpu serving, {arch}: max |err| {err} of max |logit| {scale}")
    assert bool(torch.isfinite(lg).all()) and err <= CARD_SERVE_TOL * scale
    for a, b in zip(cc, cg):
        for k in a:
            assert b[k].is_cuda and b[k].dtype == a[k].dtype and b[k].shape == a[k].shape
        assert torch.equal(a["pos"], b["pos"].cpu())


@pytest.mark.cuda
def test_cuda_serve_engine_matches_cpu(cuda):
    """ServeEngine on the card and on the CPU, smoke internlm2 in f32, 4
    slots, 6 requests, greedy: the same decode steps and, request by
    request, the same tokens up to a step where the CPU's top two logits lie
    within CARD_SERVE_TOL x max |logit| (there either may win; that request
    is compared no further)."""
    from repro_torch.serve import Request, ServeEngine
    cfg, cpu, card = _serve_models(cuda, "internlm2-1.8b")
    rows = {}

    def recorded(eng):
        decode, prefill = eng.model.decode_step, eng.model.prefill

        def rec_prefill(*a, **kw):
            logits, c = prefill(*a, **kw)
            rid = next(r.rid for r in eng.slot_req if r is not None and (r.rid, 0) not in rows)
            rows[(rid, 0)] = logits[0].cpu()
            return logits, c

        def rec_decode(params, tokens, cache):
            logits, c = decode(params, tokens, cache)
            for i, r in enumerate(eng.slot_req):
                if r is not None:
                    rows[(r.rid, len(r.generated))] = logits[i].cpu()
            return logits, c

        eng.model.decode_step, eng.model.prefill = rec_decode, rec_prefill

    engines, reqs = [], []
    for m in (cpu, card):
        eng = ServeEngine(m, m.tree(), batch_slots=4, max_seq=64)
        rng = np.random.RandomState(5)
        reqs.append([Request(rid=i, prompt=rng.randint(0, cfg.vocab, int(rng.randint(4, 32)))
                             .astype(np.int32), max_new=12) for i in range(6)])
        for r in reqs[-1]:
            eng.submit(r)
        engines.append(eng)
    recorded(engines[0])
    for eng in engines:
        eng.run_until_done()
    assert engines[0].steps == engines[1].steps
    assert all(v.is_cuda for c in engines[1].cache for v in c.values())
    for a, b in zip(*reqs):
        assert len(a.generated) == len(b.generated) == 12
        for t, (x, y) in enumerate(zip(a.generated, b.generated)):
            if x != y:
                row = rows[(a.rid, t)]
                top2 = torch.sort(row.flatten()).values[-2:]
                assert float(top2[1] - top2[0]) <= CARD_SERVE_TOL * float(row.abs().max())
                break


def _op_cases(dev):
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.uniform(-9, 9, 100_001).astype(np.float32)).to(dev)
    cipher = torch.from_numpy(_u32(rng, 100_001)).to(dev)
    rows = torch.from_numpy(rng.uniform(-9, 9, (3, 4097)).astype(np.float32)).to(dev)
    crow = torch.from_numpy(_u32(rng, (3, 4097))).to(dev)
    keys = [int(k) for k in _u32(rng, 6)]
    return {
        "mask_add": (x, keys[0], keys[1], 2**32 - 5, 3, 16),
        "chain_combine": (cipher, x, keys[:2], keys[2:4], 2**32 - 5, 16),
        "chain_combine_batched": (crow, rows, keys, keys[::-1], [0, 7, 2**32 - 5], [0, 1, 6],
                                  16),
        "bon_mask": (x, keys, [1, -1, 1], 2**31, 16),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mask_add", "chain_combine", "chain_combine_batched",
                                  "bon_mask"])
def test_cuda_custom_op_opcheck_and_route(cuda, name):
    """On the card each custom op passes opcheck's schema and fake-tensor
    checks, launches its kernel (counted once) and equals the CPU route
    word for word; a CUDA failure raises, with no fallback."""
    op = getattr(torch.ops.repro_torch, name)
    args = _op_cases(cuda)[name]
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    before = build.launches[name]
    got = op(*args)
    assert build.launches[name] == before + 1
    cpu = op(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
    assert got.is_cuda and torch.equal(got.cpu(), cpu)
    strided = [a[..., ::2] if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="contiguous"):  # the kernel refuses, no fallback
        op(*strided)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_cuda_dry_run_peak_matches_the_allocator(cuda, shape_name):
    """The dry run's peak (meta tensors) against max_memory_allocated over
    the same call run for real on the card, at a small size."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.input_specs import build_spec

    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), n_layers=4)
    shape = {"train_4k": dict(seq_len=256, global_batch=8, kind="train"),
             "decode_32k": dict(seq_len=1024, global_batch=8, kind="decode")}[shape_name]
    kw = dict(learners=4) if shape_name == "train_4k" else {}
    pred = dryrun.measure(cfg, shape_name, shape=shape, **kw)

    def real():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        spec = build_spec(cfg, None, shape_name, shape=shape, device=cuda, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        spec.fn(*spec.args, **spec.kwargs)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    # a process's first matrix product allocates cuBLAS's workspace (64 MiB
    # on the H100), which stays allocated and which the dry run does not count
    real()
    got = real()
    assert abs(pred["peak_bytes"] - got) <= 0.10 * got, (pred["peak_bytes"], got)


# ---- one learner a process: ranks sharing the card -------------------------------

# learners -> {round: (mode, aggregator kwargs, round kwargs)}; SAFE needs 3
# learners a ring, so two ranks run BON and INSEC and three the chain.
RANK_ROUNDS = {
    2: {"bon": ("bon", {}, {}), "insec": ("insec", {}, {"alive": [1, 0]})},
    3: {"safe": ("safe", {}, {"rotate": 2, "alive": [1, 1, 0]}),
        "pipelined": ("safe", {"pipelined": True}, {}),
        "weighted": ("safe", {"weighted": True}, {"weights": [2.0, 3.0, 5.0]})},
}
RANK_V = 100_003


def _rank_rows(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    return torch.rand((n, RANK_V), generator=g, device=dev) * 4 - 2


def _rank_rounds(world):
    from repro_torch.core import make_aggregator
    rows = _rank_rows(world.device, world.size)
    out = {}
    for name, (mode, akw, kw) in RANK_ROUNDS[world.size].items():
        kw = dict(kw)
        w = kw.pop("weights", None)
        out[name] = make_aggregator(mode, world.size, **akw).aggregate_rank(
            rows[world.rank], 77, weights=None if w is None else w[world.rank],
            world=world, **kw)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted(RANK_ROUNDS))
def test_cuda_ranks_sharing_the_card_equal_one_process(cuda, n):
    """n spawned ranks on the one card (``transport="host"``: gloo through
    pinned host buffers), one learner each: every rank's mean equals one
    process's ``aggregate`` of the stacked rows on the card, and the
    ranks launched the kernels."""
    from repro_torch.core import make_aggregator
    from repro_torch.dist import spawn
    build.build()  # once here, not in every rank
    ranks = spawn(_rank_rounds, n, "cuda", transport="host")
    rows = _rank_rows(cuda, n)
    for name, (mode, akw, kw) in RANK_ROUNDS[n].items():
        want = make_aggregator(mode, n, **akw).aggregate(rows, 77, **kw).cpu()
        for r, res in enumerate(ranks):
            assert torch.equal(res["result"][name], want), (name, r)
    kernels = ("bon_mask",) if n == 2 else ("mask_add", "chain_combine",
                                            "chain_combine_batched")
    for k in kernels:
        assert sum(res["launches"][k] for res in ranks) > 0, k


A2A_N = 4


def _exchange_rank(world):
    """The tiled all-to-all on the card, there and back, in three dtypes,
    and its gradient under autograd."""
    from repro_torch.dist import collectives
    dev, r = world.device, world.rank
    x = torch.arange(A2A_N * 6 * 5, dtype=torch.float32, device=dev).reshape(-1, 5) + 1000 * r
    out = {}
    for name, t in (("f32", x), ("bf16", x.to(torch.bfloat16)),
                    ("u32", x.to(torch.int32).view(torch.uint32))):
        y = collectives.all_to_all(t, world)
        out[name] = (y.cpu(), collectives.all_to_all(y, world).cpu())
    xg = x.clone().requires_grad_(True)
    c = torch.arange(x.numel(), dtype=torch.float32, device=dev).reshape(x.shape) * (r + 1)
    (collectives.all_to_all(xg, world) * c).sum().backward()
    out["grad"] = xg.grad.cpu()
    return out


@pytest.mark.cuda
def test_cuda_all_to_all_round_trip_on_the_card(cuda):
    """Four ranks sharing the card (``transport="host"``): the exchange of
    f32, bf16 and uint32 tensors equals the exchange written in one process
    (rank r's output: every rank's chunk r, in rank order), a second
    exchange brings each tensor back, and the gradient is the exchange of
    the cotangents."""
    from repro_torch.dist import spawn
    ranks = [r["result"] for r in spawn(_exchange_rank, A2A_N, "cuda", transport="host")]
    xs = [torch.arange(A2A_N * 6 * 5, dtype=torch.float32).reshape(-1, 5) + 1000 * r
          for r in range(A2A_N)]
    cs = [torch.arange(xs[0].numel(), dtype=torch.float32).reshape(xs[0].shape) * (r + 1)
          for r in range(A2A_N)]
    for r, res in enumerate(ranks):
        for name, cast in (("f32", lambda t: t), ("bf16", lambda t: t.to(torch.bfloat16)),
                           ("u32", lambda t: t.to(torch.int32).view(torch.uint32))):
            y, back = res[name]
            want = torch.cat([cast(x).chunk(A2A_N)[r] for x in xs])
            assert torch.equal(y.view(torch.int8), want.view(torch.int8)), (r, name)
            assert torch.equal(back.view(torch.int8), cast(xs[r]).view(torch.int8)), (r, name)
        assert torch.equal(res["grad"], torch.cat([c.chunk(A2A_N)[r] for c in cs])), r


ENGINE_N, ENGINE_V, ENGINE_SLOTS = 3, 1000, 2


def _engine_sessions():
    rng = np.random.RandomState(5)
    return [(rng.uniform(-2, 2, (ENGINE_N, ENGINE_V)).astype(np.float32),
             [1, 0, 1] if s == 1 else None, 2 if s == 0 else 1, s) for s in range(3)]


def _run_engine(dev, world=None):
    from repro_torch.core import ChainConfig
    from repro_torch.serve.agg_engine import AggregationEngine
    eng = AggregationEngine(ChainConfig(num_learners=ENGINE_N, mode="safe"), ENGINE_SLOTS,
                            ENGINE_V, device=dev, world=world)
    sess = [eng.submit(v if world is None else v[world.rank], rounds=rounds, alive=alive,
                       rotate0=rot) for v, alive, rounds, rot in _engine_sessions()]
    eng.run_until_done()
    return [torch.stack(s.results).cpu() for s in sess]


def _engine_rank(world):
    return _run_engine(world.device, world)


@pytest.mark.cuda
def test_cuda_rank_engine_equals_cpu(cuda):
    """The multi-session engine one learner a rank on the card (three ranks
    sharing it): every session-round equals the learner-major engine's on
    the CPU, and the ranks launched the batched hop."""
    from repro_torch.dist import spawn
    build.build()
    ranks = spawn(_engine_rank, ENGINE_N, "cuda", transport="host")
    want = _run_engine("cpu")
    for r, res in enumerate(ranks):
        for got, w in zip(res["result"], want):
            assert torch.equal(got, w), r
    assert sum(res["launches"]["chain_combine_batched"] for res in ranks) > 0
