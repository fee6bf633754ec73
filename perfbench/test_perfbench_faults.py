"""A run with the timed path broken underneath comes out not correct.

Each cell runs here on the CPU at a small size (the harness's look for a
card is skipped: ``run_cell`` is called directly), once sound and once
with each fault the cell can have planted in the program:
- the state returned unchanged: a round that publishes its previous
  result, a train step that leaves its state as it was;
- half of the batch left out, the mean taken over the rest;
- an answer altered where it is produced: one word of the published mean;
- the ring skipped: the exact mean published with no pad made, which
  only the count of the round's kernel launches can tell.
The exchange between chips does not exist in these one-card cells. The
plain CPU path launches no kernel, so here each call of a masking op
counts as the launch its CUDA kernel would make.
"""
import copy
import time

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.reference.fixedpoint import fixed_point_mean

SPEC = harness.load_spec()
SMALL = {"agg-n36-round": ({}, {"payload_words": 512}),
         "agg-n36-engine": ({}, {"payload_words": 256, "slots": 2, "pool": 3}),
         "train-internlm2-1.8b-safe": ({"n_layers": 2, "d_model": 64, "n_heads": 4,
                                        "n_kv_heads": 2, "head_dim": 16, "d_ff": 96,
                                        "vocab": 128}, {"seq": 16})}


def _run(cell_name, seed=2**31 + 17):
    cell = harness.find_cell(SPEC, cell_name)
    over_cfg, over_tr = SMALL[cell_name]
    config = dict(harness.load_config(SPEC, cell["config"]), **over_cfg)
    traffic = dict(harness.load_traffic(cell["traffic"]), **over_tr)
    return harness.run_cell(cell, config, traffic, seed, 0.3, False, "cpu",
                            time.perf_counter(), SPEC)


@pytest.fixture(autouse=True)
def count_cpu_launches(monkeypatch):
    """Each masking op called on the CPU adds one to the program's launch
    counter, as its CUDA kernel's wrapper does on the card."""
    from repro_torch.kernels import build, ops
    for name in ("mask_add", "chain_combine", "chain_combine_batched"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            build.launches[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)


def _alive_rows(alive, n):
    return [r for r in range(n) if alive is None or alive[r] > 0]


def _half(alive, n):
    a = np.ones(n, np.float32) if alive is None else np.asarray(alive, np.float32).copy()
    a[n // 2:] = 0.0
    return a


def plant_round(monkeypatch, fault, amount=2.0 ** -16):
    from repro_torch.core.aggregators import SecureAggregator
    real = SecureAggregator.aggregate
    last = []

    def broken(self, values, counter_base=0, alive=None, *a, **kw):
        if fault == "unmasked":
            n = self.cfg.num_learners
            return fixed_point_mean(values, _alive_rows(alive, n), self.cfg.scale_bits)
        if fault == "half_batch":
            return real(self, values, counter_base, _half(alive, self.cfg.num_learners), *a, **kw)
        out = real(self, values, counter_base, alive, *a, **kw)
        if fault == "altered":
            out = out.clone()
            out[0] += amount
        if fault == "unchanged":
            prev = last[0] if last else out
            last[:] = [out]
            return prev
        return out

    monkeypatch.setattr(SecureAggregator, "aggregate", broken)


def plant_engine(monkeypatch, fault):
    import repro_torch.serve.agg_engine as eng
    real = eng.chain_aggregate_batched
    last = []

    def broken(values, prov, learners, bases, cfg, alive, **kw):
        if fault == "unmasked":
            return torch.stack([fixed_point_mean(v, _alive_rows(a, cfg.num_learners),
                                                 cfg.scale_bits)
                                for v, a in zip(values, alive)])
        if fault == "half_batch":
            alive = np.stack([_half(a, cfg.num_learners) for a in alive])
        out = real(values, prov, learners, bases, cfg, alive, **kw)
        if fault == "altered":
            out = out.clone()
            out[0, 0] += 2.0 ** -16
        if fault == "unchanged":
            prev = last[0] if last else out
            last[:] = [out]
            return prev
        return out

    monkeypatch.setattr(eng, "chain_aggregate_batched", broken)


def plant_train(monkeypatch, fault):
    import repro_torch.train as train
    if fault == "unchanged":
        real = train.make_train_step

        def make(*a, **kw):
            bundle = real(*a, **kw)
            step = bundle.step_fn

            def unchanged(state, *sa, **skw):
                copied = {k: (v.clone() if isinstance(v, torch.Tensor) else copy.deepcopy(v))
                          for k, v in state.items()}
                copied["params"] = {k: copy.deepcopy(v) for k, v in state["params"].items()}
                _, metrics = step(copied, *sa, **skw)
                return state, metrics
            bundle.step_fn = unchanged
            return bundle
        monkeypatch.setattr(train, "make_train_step", make)
    else:  # the step's SAFE round: half the learners, a gradient word off by 1, no ring
        plant_round(monkeypatch, fault, amount=1.0)


PLANT = {"agg-n36-round": plant_round, "agg-n36-engine": plant_engine,
         "train-internlm2-1.8b-safe": plant_train}


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "unmasked"])
@pytest.mark.parametrize("cell", list(SMALL))
def test_fault_makes_the_run_incorrect(monkeypatch, cell, fault):
    PLANT[cell](monkeypatch, fault)
    r = _run(cell)
    assert r["correct"] is False, r["checks"]
    if fault == "unmasked":  # the published values are right: the launches tell
        assert r["checks"]["short_rounds"]["value"] > r["checks"]["short_rounds"]["limit"]
