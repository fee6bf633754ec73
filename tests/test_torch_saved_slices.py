"""Each block's saved input split over the model ranks
(``models/transformer.py::sliced_checkpoint``) against the whole input
``torch.utils.checkpoint`` keeps, and the dry run's bytes of it.

One ``RankPool`` of 6 gloo ranks at one intra-op thread runs the train
step (``make_train_step`` on the rank's ``Grid``) twice a case from
the same weights and tokens: as the port runs it (the block's input saved
as this rank's share of the B·S token rows), and in the parent's form,
``torch.utils.checkpoint`` of the whole block, put back here by replacing
``transformer.sliced_checkpoint``. The loss, the gradient chunk the rank
hands to ``aggregate_rank``, the published mean it gets back, the
gradient's norm and every new parameter (the experts' too) must be the
same words (``torch.equal``): x has the same bits on every rank of a model
group, so the gathered shares are x, and the recomputed block is
``checkpoint``'s. The learners' mean is the plain one (INSEC): the
aggregator meets only the chunk, which the two forms hand it alike, and
the SAFE round of the TP step is held in tests/test_torch_dist_tp.py.
Cases (``CASES``): the model group of m = 2 (3 learners; B·S = 32 rows
split 16/16) and of m = 3 (2 learners; 11/11/10 rows, padded to 11), for
the smoke internlm2-1.8b (dense), qwen3-moe (its experts by expert
parallelism over the ring and their ff over the model group; 6 experts,
which 2 and 3 learners divide), zamba2 (one unit: Mamba2 and the shared
attention block) and rwkv6 (one layer); and the pod grid, 2 pods x 1
learner x 3 model shards.

In process: the dry run (``launch/dryrun.py::measure``, meta tensors on a
fake group) of rank 0 of a 3 x 2 grid of the smoke internlm2-1.8b at one
and two layers, with a sequence long enough that the blocks' saved inputs
set the peak: the slope of the peak over a layer falls by (1 − 1/m)·B·S·d
times the element size against the parent's form, as the saved input does.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import get_smoke_config
from repro_torch.core import make_aggregator
from repro_torch.dist import RankPool, grid
from repro_torch.models import Model, transformer
from repro_torch.train import make_train_step
from repro_torch.train.flatten import leaves

RANKS, B, S, LR, SEED = 6, 2, 16, 1e-3, 0
ARCHS = {"dense": "internlm2-1.8b", "moe": "qwen3-moe-235b-a22b", "zamba2": "zamba2-2.7b",
         "rwkv6": "rwkv6-1.6b"}
# (model shards m, pods) of each layout over the RANKS ranks
LAYOUTS = {"m2": (2, 1), "m3": (3, 1), "pod": (3, 2)}
CASES = [(layout, kind) for layout in ("m2", "m3") for kind in ARCHS] + [("pod", "dense")]
MOE_EXPERTS = 6


def _cfg(kind, n):
    """The smoke configuration of ``kind`` at its pattern's length (one unit
    of zamba2, one layer of rwkv6, two of the dense model and the MoE), in
    f32, each block checkpointed (``remat``, which the smoke configurations
    leave off); the MoE's experts over the n learners' ring."""
    cfg = get_smoke_config(ARCHS[kind])
    cfg = dataclasses.replace(cfg, dtype="float32", remat=True,
                              n_layers=2 if kind in ("dense", "moe") else len(cfg.pattern))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=MOE_EXPERTS),
                                  ep_axis="data", ep_ranks=n)
    return cfg


def _parent_form(fn, x, positions, bp, world):
    return checkpoint(fn, x, positions, bp, use_reentrant=False)


def _step(g, kind, layout):
    """One train step of ``kind`` on grid ``g``: (loss, grad_scale, the
    gradient chunk, the published mean, the new parameters)."""
    m, pods = LAYOUTS[layout]
    n = g.data.size
    cfg = _cfg(kind, n)
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED),
                  tp_world=g.model, ep_world=g.data if cfg.moe is not None else None)
    pod = {} if pods == 1 else dict(pod_axis="pod")
    agg = make_aggregator("insec", n, device="cpu", **pod)
    seen = []
    aggregate_rank = agg.aggregate_rank

    def record(chunk, *args, **kw):
        mean = aggregate_rank(chunk, *args, **kw)
        seen.append((chunk.clone(), mean.clone()))
        return mean

    agg.aggregate_rank = record
    bundle = make_train_step(model, agg, g, lr=LR, **pod)
    state = bundle.init_state_fn(model.tree())
    learner = (g.pod.rank if g.pod is not None else 0) * n + g.data.rank
    toks = np.random.RandomState(SEED + learner).randint(0, cfg.vocab, (B, S))
    state, met = bundle.step_fn(state, torch.from_numpy(toks.astype(np.int32)),
                                counter=agg.reserve_round(bundle.padded_size + 2))
    (chunk, mean), = seen
    return [met["loss"], met["grad_scale"], chunk, mean] + list(leaves(state["params"]))


def _rank(world):
    """Every case on this rank: {case: (each output equal to the parent
    form's, the sliced saves made)}."""
    out = {}
    for layout, kind in CASES:
        m, pods = LAYOUTS[layout]
        g = grid(world, m, pods)
        calls = []
        sliced = transformer.sliced_checkpoint

        def counted(*args):
            calls.append(1)
            return sliced(*args)

        transformer.sliced_checkpoint = counted
        try:
            got = _step(g, kind, layout)
            transformer.sliced_checkpoint = _parent_form
            want = _step(g, kind, layout)
        finally:
            transformer.sliced_checkpoint = sliced
        out[(layout, kind)] = ([torch.equal(a, b) for a, b in zip(got, want)], len(calls))
    return out


@pytest.fixture(scope="module")
def ranks():
    with RankPool(RANKS, "cpu", threads=1) as pool:
        return [r["result"] for r in pool.run(_rank)]


@pytest.mark.parametrize("layout,kind", CASES)
def test_sliced_saves_are_the_parent_steps_words(ranks, layout, kind):
    n_layers = _cfg(kind, 1).n_layers
    for r, res in enumerate(ranks):
        same, calls = res[(layout, kind)]
        assert calls == n_layers, f"rank {r}: {calls} sliced blocks of {n_layers}"
        assert all(same), (f"rank {r}: loss, grad_scale, chunk, mean, leaves equal to the "
                           f"parent form's: {same}")


# ---- the dry run ---------------------------------------------------------------------------

DRY_B, DRY_S, DRY_N, DRY_M = 2, 4096, 3, 2


def _dry_peak(layers):
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), n_layers=layers, remat=True)
    rec = dryrun.measure(cfg, "train_4k", shape=dict(seq_len=DRY_S,
                                                      global_batch=DRY_N * DRY_B, kind="train"),
                         learners=DRY_N, batch=DRY_B, per_rank=True, model_shards=DRY_M)
    return rec["peak_bytes"]


def test_dry_run_slope_falls_by_the_saved_share(monkeypatch):
    """Rank 0's peak a layer on meta tensors: the parent form's slope
    less the sliced form's is (1 − 1/m)·B·S·d·2 bytes (bf16), the part of
    each block's saved input this rank no longer holds."""
    import torch.distributed as dist
    try:
        sliced = [_dry_peak(1), _dry_peak(2)]
        monkeypatch.setattr(transformer, "sliced_checkpoint", _parent_form)
        parent = [_dry_peak(1), _dry_peak(2)]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    d = get_smoke_config("internlm2-1.8b").d_model
    saved = DRY_B * DRY_S * d * 2
    assert (parent[1] - parent[0]) - (sliced[1] - sliced[0]) == saved - saved // DRY_M, (
        parent, sliced)
