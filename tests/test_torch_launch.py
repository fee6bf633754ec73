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
from repro_torch.configs import ALIASES, get_config, get_smoke_config
from repro_torch.core import make_aggregator
from repro_torch.crypto.prf import RoundCounter
from repro_torch.launch.train import parse_args, run
from repro_torch.models import Model
from repro_torch.optim import AdamState, FlatAdamW
from repro_torch.train import leaf_paths, make_train_step, tree_to_flat
from repro_torch.train.flatten import leaves

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
    m = 4 if "--pipelined" in extra else 1  # the pipelined round pads 4 equal segments
    assert out["counters"] == [0, -(-(m * -(-W // m)) // 2)]  # two words to a counter


@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_every_config_takes_safe_steps(arch):
    """Each of the ten configurations at the smoke size takes two SAFE
    steps on the CPU in f32: a MoE by expert parallelism over the four learners
    (``ep_axis``, as the launcher sets it), Mamba2 with the shared
    attention block, RWKV6, the dense kinds, four codebooks and a prefix of
    frontend embeddings; finite losses, fresh counters, every parameter
    leaf but the unused ones moved."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")  # a step moves every word
    if cfg.uses_moe:
        cfg = dataclasses.replace(cfg, ep_axis="data", ep_ranks=4)
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    agg = make_aggregator("safe", 4, device="cpu")
    bundle = make_train_step(model, agg, lr=1e-3)
    state = bundle.init_state_fn(model.tree())
    init = [t.clone() for t in leaves(state["params"])]
    rng = np.random.RandomState(0)
    shape = (4, 1, 32) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    prefix = (torch.from_numpy(rng.standard_normal((4, 1, cfg.prefix_embeds, cfg.d_model))
                               .astype(np.float32)) if cfg.prefix_embeds else None)
    counters, losses = [], []
    for _ in range(2):
        counters.append(agg.reserve_round(bundle.padded_size + 2))
        state, m = bundle.step_fn(state, rng.randint(0, cfg.vocab, shape), prefix=prefix,
                                  counter=counters[-1])
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and counters == [0, -(-(bundle.padded_size + 2) // 2)]
    assert (state["ep_opt"] is not None) == cfg.uses_moe
    for path, a, b in zip(leaf_paths(state["params"]), leaves(state["params"]), init):
        assert bool(torch.isfinite(a.float()).all()), path
        unused = path.endswith("_shared") or (cfg.recurrent_mlp is False and "ln2" in path
                                              and not path.startswith("shared_attn"))
        assert unused or not torch.equal(a, b), path


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
    assert out["counters"] == [0, -(-(P + 1) // 2)]  # a weighted round's P + 1 words


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
    C = -(-(a["state"]["master"].numel() + 2) // 2)  # counters of a step
    spans = sorted((c, c + C) for c in a["counters"] + b["counters"])
    assert len(spans) == 3 and all(hi <= lo for (_, hi), (lo, _) in zip(spans, spans[1:]))
    _, extra = restore_checkpoint(ck, 3, b["state"])
    assert extra == {"step": 3, "counter": 3 * C}


@pytest.mark.parametrize("layers,steps", [(12, 9), (24, 5)])
def test_full_width_counter_space(layers, steps):
    """internlm2-1.8b at full width: a step of padded_size + 2 words draws
    C = ceil((padded_size + 2) / 2) of the keys' 2^32 Threefry counters
    (each counter pads two words), so 2^32 // C steps fit (9 at 12 layers,
    5 at 24) and the next reservation is refused, before it wraps."""
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=layers)
    agg = make_aggregator("safe", 4, device="cpu")
    bundle = make_train_step(Model(cfg, device="meta"), agg)
    W = bundle.padded_size + 2
    C = -(-W // 2)
    assert agg.round_counters(W) == C and 2**32 // C == steps
    for i in range(steps):
        assert agg.reserve_round(W) == i * C
    with pytest.raises(OverflowError, match="counter space exhausted"):
        agg.reserve_round(W)
    assert agg._counters.remaining == 2**32 - steps * C  # the refusal changed nothing
    # what is left still serves
    assert agg.reserve_round(2 * (2**32 - steps * C)) == steps * C


def test_launcher_stops_with_the_refusal(tmp_path):
    """A checkpoint whose next counter leaves less than one step's words:
    the resumed launcher refuses its first step instead of wrapping."""
    ck = str(tmp_path / "ck")
    out = _run("--steps", "1", "--ckpt-dir", ck, "--ckpt-every", "1")
    C = -(-(out["state"]["master"].numel() + 2) // 2)  # counters of a step
    save_checkpoint(ck, 1, out["state"], extra={"step": 1, "counter": RoundCounter.LIMIT - C + 1})
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


# ---- consecutive reserved rounds draw disjoint counters under every key ----------

COUNTER_N, COUNTER_V = 6, 997    # pipelined segments of 167 (333 in subgroups) words: odd starts
COUNTER_MODES = {
    "sequential": dict(mode="safe"),
    "pipelined": dict(mode="safe", pipelined=True),
    "pipelined-subgroups": dict(mode="safe", pipelined=True, subgroups=2),
    "bon": dict(mode="bon"),
    "subgroups": dict(mode="safe", subgroups=2),
    "pods": dict(mode="safe", pod_axis="pod"),
    "weighted": dict(mode="safe", weighted=True),
    "weighted-pipelined": dict(mode="safe", weighted=True, pipelined=True),
    "leafwise": dict(mode="safe"),
}


@pytest.mark.parametrize("case", list(COUNTER_MODES))
def test_reserved_rounds_draw_disjoint_counters(monkeypatch, case):
    """Every Threefry block a pad evaluates is recorded (key, counter) by
    wrapping ``crypto.prf._threefry_lanes``, which every pad of the CPU path
    evaluates (``keystream_pair_lanes``, and through it the plain kernel
    versions of ``kernels/ref.py``). Two consecutive rounds whose counters
    come from ``reserve_round(words)`` — the words the caller's payload
    has: V, V + 1 weighted, the train step's padded_size + 2 for the
    leafwise domains — touch disjoint counters under every key, each
    round inside its own reserved range, clean and with a dead learner."""
    from repro_torch.crypto import prf
    seen = {}
    real = prf._threefry_lanes

    def record(k0, k1, x0, x1):
        pads = x1 == 0  # key derivations fold a nonzero tag into lane 1
        if bool(pads.any()):
            seen.setdefault((k0, k1), set()).update(x0[pads].reshape(-1).tolist())
        return real(k0, k1, x0, x1)

    monkeypatch.setattr(prf, "_threefry_lanes", record)
    kw = dict(COUNTER_MODES[case])
    n, V = COUNTER_N, COUNTER_V
    agg = make_aggregator(kw.pop("mode"), n, device="cpu", **kw)
    rng = np.random.RandomState(0)
    pods = 2 if kw.get("pod_axis") else 1
    vals = torch.from_numpy(rng.uniform(-1, 1, (pods, n, V)).astype(np.float32))
    vals = vals if pods > 1 else vals[0]
    weights = np.arange(1.0, n + 1, dtype=np.float32) if kw.get("weighted") else None
    sizes = [300, 701]  # leafwise: two leaves, domains 1 and 2
    words = (sum(sizes) + (-sum(sizes)) % n + 2 if case == "leafwise"
             else V + (1 if kw.get("weighted") else 0))
    rounds = []
    for alive in ([1] * n, [1, 0] + [1] * (n - 2)):
        for _ in range(2):
            seen.clear()
            base = agg.reserve_round(words)
            rotate = base % (2 * n + 1)
            if case == "leafwise":
                off = 0
                for idx, size in enumerate(sizes):
                    agg.aggregate(vals[:, off:off + size], base, alive=alive,
                                  domain=idx + 1, rotate=rotate)
                    off += size
            else:
                agg.aggregate(vals, base, alive=alive, weights=weights, rotate=rotate)
            hi = base + agg.round_counters(words)
            for key, ctrs in seen.items():
                assert base <= min(ctrs) and max(ctrs) < hi, (case, key, base, hi)
            rounds.append({k: set(v) for k, v in seen.items()})
    assert all(rounds)
    for a, b in zip(rounds, rounds[1:]):
        for key in a.keys() & b.keys():
            assert not a[key] & b[key], (case, key)
    if case.startswith("pipelined") or case == "weighted-pipelined":
        # the segments pad m equal parts: more than ceil(words / 2) counters
        assert agg.round_counters(words) > -(-words // 2)


def test_serve_launcher(capsys):
    """``repro_torch.launch.serve`` at the smoke size on the CPU prints the
    reference launcher's line, with the same request, token and decode-step
    counts and batch efficiency as ``python -m repro.launch.serve`` given
    the same flags (its times aside); its device defaults to the card."""
    import re

    from repro_torch.launch import serve
    flags = ["--arch", "zamba2-2.7b", "--requests", "5", "--max-new", "6", "--slots", "2"]
    out = serve.run(serve.parse_args(flags + ["--device", "cpu"]))
    assert all(len(r.generated) == 6 for r in out["requests"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    pattern = (r"served 5 requests / 30 tokens in [0-9.]+s \([0-9.]+ tok/s, "
               r"(\d+) decode steps, batch efficiency ([0-9.]+)\)")
    got = re.fullmatch(pattern, line)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "repro.launch.serve", *flags],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = re.fullmatch(pattern, proc.stdout.strip().splitlines()[-1])
    assert got and want and got.groups() == want.groups()
    assert int(got.group(1)) == out["engine"].steps
    assert serve.parse_args(["--arch", "internlm2-1.8b"]).device == "cuda"
