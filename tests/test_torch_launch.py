"""The PyTorch port's training launcher, counters and FlatAdamW.

* ``repro_torch.launch.train`` at the smoke size on the CPU: the train
  step (SAFE, BON, a failing learner), ``--federated``, and the command
  line in a subprocess.
* Resume from ``--ckpt-dir`` gives the losses and parameters of an
  uninterrupted run, bit for bit.
* Counters: every round's range is fresh, a resumed run continues the
  ranges, ``reserve_round`` refuses at the step the arithmetic predicts
  for full-width internlm2-1.8b, and the launcher stops with that refusal.
* ``FlatAdamW`` against the JAX package's.
"""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import REPO
from repro.optim.adamw import FlatAdamW as RefFlatAdamW
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import make_aggregator
from repro_torch.crypto.prf import RoundCounter
from repro_torch.launch.train import parse_args, run
from repro_torch.models import Model
from repro_torch.optim import AdamState, FlatAdamW
from repro_torch.train import make_train_step, tree_to_flat

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs test files in parallel
    processes, and several processes' full sets of spinning OpenMP threads
    on the same cores slow every file down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


BASE = ["--arch", "internlm2-1.8b", "--smoke", "--learners", "4", "--seq-len", "32",
        "--device", "cpu"]


def _run(*extra):
    return run(parse_args(BASE + list(extra)))


def _flat(out):
    return tree_to_flat(out["params"]).numpy()


@pytest.mark.parametrize("extra", [
    ("--aggregator", "safe"),
    ("--aggregator", "bon"),
    ("--aggregator", "saf"),
    ("--aggregator", "safe", "--pipelined"),
    ("--aggregator", "safe", "--fail-learners", "2", "--fail-at-step", "1"),
    ("--aggregator", "safe", "--fail-learners", "0"),
], ids=["safe", "bon", "saf", "pipelined", "fail-learner-2-at-1", "fail-initiator"])
def test_train_step_launcher_runs(extra):
    out = _run("--steps", "2", *extra)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    assert np.isfinite(_flat(out)).all()
    W = out["state"]["master"].numel() + 2
    assert out["counters"] == [0, W]


def test_failing_learner_changes_the_step():
    """--fail-at-step 1 leaves step 0 alone and changes later steps."""
    clean = _run("--steps", "2")
    failed = _run("--steps", "2", "--fail-learners", "2", "--fail-at-step", "1")
    assert clean["losses"][0] == failed["losses"][0]
    assert not np.array_equal(_flat(clean), _flat(failed))


def test_federated_launcher_runs():
    out = _run("--federated", "--steps", "2", "--local-steps", "2")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    P = _flat(out).size
    assert out["counters"] == [0, P + 1]  # a weighted round's words


def test_resume_is_bit_exact(tmp_path):
    """3 steps at once against 2, then 1 resumed from the checkpoint:
    the same losses, parameters and optimizer state, bit for bit, and the
    resumed run continues the counters."""
    whole = _run("--steps", "3")
    ck = str(tmp_path / "ck")
    first = _run("--steps", "2", "--ckpt-dir", ck, "--ckpt-every", "2")
    assert latest_step(ck) == 2
    second = _run("--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "3")
    assert latest_step(ck) == 3
    assert first["losses"] + second["losses"] == whole["losses"]
    assert first["counters"] + second["counters"] == whole["counters"]
    for key in ("master", "fm", "fv", "fstep"):
        assert torch.equal(second["state"][key], whole["state"][key]), key
    np.testing.assert_array_equal(_flat(second).view(np.uint32), _flat(whole).view(np.uint32))
    assert second["state"]["step"] == whole["state"]["step"] == 3


def test_counters_never_overlap(tmp_path):
    """Every round of a run, and of a run resumed from it, takes a range
    no other round touches; a checkpoint records where the next starts."""
    ck = str(tmp_path / "ck")
    a = _run("--steps", "2", "--ckpt-dir", ck, "--ckpt-every", "2")
    b = _run("--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "3")
    W = a["state"]["master"].numel() + 2
    spans = sorted((c, c + W) for c in a["counters"] + b["counters"])
    assert len(spans) == 3 and all(hi <= lo for (_, hi), (lo, _) in zip(spans, spans[1:]))
    _, extra = restore_checkpoint(ck, 3, b["state"])
    assert extra == {"step": 3, "counter": 3 * W}


@pytest.mark.parametrize("layers,steps", [(12, 4), (24, 2)])
def test_full_width_counter_space(layers, steps):
    """internlm2-1.8b at full width: a step reserves padded_size + 2 words
    of the keys' 2^32, so 2^32 // (padded_size + 2) steps fit (4 at 12
    layers, 2 at 24) and the next reservation is refused, before it
    wraps."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=layers)
    agg = make_aggregator("safe", 4, device="cpu")
    bundle = make_train_step(Model(cfg, device="meta"), agg)
    W = bundle.padded_size + 2
    assert 2**32 // W == steps
    for i in range(steps):
        assert agg.reserve_round(W) == i * W
    with pytest.raises(OverflowError, match="counter space exhausted"):
        agg.reserve_round(W)
    assert agg._counters.remaining == 2**32 - steps * W  # the refusal changed nothing
    assert agg.reserve_round(2**32 - steps * W) == steps * W  # what is left still serves


def test_launcher_stops_with_the_refusal(tmp_path):
    """A checkpoint whose next counter leaves less than one step's words:
    the resumed launcher refuses its first step instead of wrapping."""
    ck = str(tmp_path / "ck")
    out = _run("--steps", "1", "--ckpt-dir", ck, "--ckpt-every", "1")
    W = out["state"]["master"].numel() + 2
    save_checkpoint(ck, 1, out["state"], extra={"step": 1, "counter": RoundCounter.LIMIT - W + 1})
    with pytest.raises(SystemExit, match="counter space exhausted"):
        _run("--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "1")
    assert latest_step(ck) == 1


def test_command_line(tmp_path):
    """``python -m repro_torch.launch.train``: its first line says the
    model axis is 1, and the metrics go to the JSONL file."""
    metrics = tmp_path / "m.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *BASE, "--steps", "2",
         "--model-shards", "2", "--metrics", str(metrics)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "model axis is 1 on one card" in lines[0]
    assert lines[-1].startswith("done in")
    recs = [line for line in metrics.read_text().splitlines() if line]
    assert len(recs) == 2 and '"loss"' in recs[0] and '"grad_scale"' in recs[0]


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_flat_adamw_matches_reference(weight_decay):
    """FlatAdamW, five steps on the same f32 vectors (gradients from 1e-6
    to 10, some exactly zero): the parameters and both moments equal the
    reference's on every word, in place and not. (Measured: 0 ulps; with
    PyTorch's own f32 sqrt on the CPU it was 8.)"""
    rng = np.random.RandomState(0)
    n = 100_003
    param = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32) * 10.0 ** rng.uniform(-6, 1, n)
             .astype(np.float32) for _ in range(5)]
    grads[1][:100] = 0.0  # exact zeros: u = 0 / (0 + eps)
    ref, mine = RefFlatAdamW(lr=1e-3, weight_decay=weight_decay), \
        FlatAdamW(lr=1e-3, weight_decay=weight_decay)
    rs, rp = ref.init(n), jnp.asarray(param)
    ms, mp = mine.init(n, device="cpu"), torch.from_numpy(param.copy())
    ip_s, ip_p = mine.init(n, device="cpu"), torch.from_numpy(param.copy())
    worst = 0
    for g in grads:
        rp, rs = ref.update(jnp.asarray(g), rs, rp)
        mp, ms = mine.update(torch.from_numpy(g), ms, mp)
        ip_p, ip_s = mine.update(torch.from_numpy(g), ip_s, ip_p, inplace=True)
        for a, b in ((mp, rp), (ms.m, rs.m), (ms.v, rs.v)):
            ulps = np.abs(a.numpy().view(np.int32).astype(np.int64)
                          - np.asarray(b).view(np.int32).astype(np.int64))
            worst = max(worst, int(ulps.max()))
        assert torch.equal(ip_p, mp) and torch.equal(ip_s.m, ms.m) and torch.equal(ip_s.v, ms.v)
        assert ms.step == int(rs.step)
    assert worst == 0


def test_flat_adamw_leaves_inputs_alone():
    opt = FlatAdamW(lr=1e-2)
    s = AdamState(3, torch.ones(5), torch.full((5,), 2.0))
    p, g = torch.arange(5.0), torch.ones(5)
    new, s2 = opt.update(g, s, p)
    assert torch.equal(p, torch.arange(5.0)) and torch.equal(s.m, torch.ones(5))
    assert s2.step == 4 and not torch.equal(new, p)
