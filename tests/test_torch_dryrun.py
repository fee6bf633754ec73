"""The port's dry run (``repro_torch.launch.{input_specs,dryrun}``).

On a (4, 2) test mesh, ``build_spec`` gives every argument of every
(smoke arch × input shape) the reference's global shape, dtype and
per-device shape (the reference's ``build_spec`` runs in an 8-device
subprocess), the train bundles the reference's padded size and leafwise
choice, and skips long_500k for the same archs; on the production mesh
(a 512-device subprocess) so do the train steps of llama4 (expert
parallelism) and gemma2-27b (leafwise) at their published widths, and on
pod512 the train, prefill and decode specs that take the pod axis. On one card, the dry run
(meta tensors) sweeps all 40 smoke combinations through its CLI in a
second subprocess; on a real CPU run of the same calls its matrix-product
FLOPs equal ``FlopCounterMode``'s and, for prefill and decode (no kernel
on their path), its peak equals ``MemTracker``'s. The decode step takes
its cache as donated, so the dry run counts the cache once.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
from helpers import REPO
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import all_arch_ids, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.input_specs import INPUT_SHAPES, build_spec
from repro_torch.launch.mesh import make_test_mesh, start_fake_world
from repro_torch.models import Model
from repro_torch.train.flatten import leaves

SHAPES = list(INPUT_SHAPES)
LEARNERS = 4                # the smoke MoEs' 4 experts shard over 4 learners
SMALL = {"train_4k": dict(seq_len=64, global_batch=4, kind="train"),
         "prefill_32k": dict(seq_len=128, global_batch=2, kind="prefill"),
         "decode_32k": dict(seq_len=128, global_batch=2, kind="decode"),
         "long_500k": dict(seq_len=256, global_batch=1, kind="decode")}

_REFERENCE = """
import json, jax, repro
from repro.configs import all_arch_ids, get_smoke_config
from repro.launch.input_specs import INPUT_SHAPES, build_spec
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh(4, 2)
out = {}
for arch in all_arch_ids():
    for shape in INPUT_SHAPES:
        spec = build_spec(get_smoke_config(arch), mesh, shape)
        if spec is None:
            out[f"{arch} {shape}"] = None
            continue
        args = [[list(x.shape), str(x.dtype),
                 list(x.sharding.shard_shape(x.shape) if x.sharding is not None else x.shape)]
                for x in jax.tree.leaves(spec.args)]
        rec = {"args": args}
        if shape == "train_4k":
            leafwise = not isinstance(spec.args[6], jax.ShapeDtypeStruct)
            rec.update(leafwise=leafwise, flat=spec.args[1].shape[0])
        out[f"{arch} {shape}"] = rec
print("JSON" + json.dumps(out))
"""


_REFERENCE_POD = """
import json, jax, repro
from repro.configs import get_config
from repro.launch.input_specs import build_spec
from repro.launch.mesh import make_production_mesh
out = {}
for arch, shape, multi_pod in CASES:
    spec = build_spec(get_config(arch), make_production_mesh(multi_pod=multi_pod), shape)
    out[f"{arch} {shape} {multi_pod}"] = [
        [list(x.shape), str(x.dtype),
         list(x.sharding.shard_shape(x.shape) if x.sharding is not None else x.shape)]
        for x in jax.tree.leaves(spec.args)]
print("JSON" + json.dumps(out))
"""
# published widths on the production meshes: llama4's experts ride 'data'
# with their AdamW state (expert parallelism), gemma2-27b's step is
# leafwise, and on pod512 the batch axes and the decode cache take 'pod'
POD_CASES = [("llama4-maverick-400b-a17b", "train_4k", False), ("gemma2-27b", "train_4k", False),
             ("internlm2-1.8b", "train_4k", True), ("internlm2-1.8b", "prefill_32k", True),
             ("internlm2-1.8b", "decode_32k", True), ("zamba2-2.7b", "decode_32k", True),
             ("llama4-maverick-400b-a17b", "prefill_32k", True)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs test files in parallel
    processes, and this file's subprocesses run beside its tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _start(code, devices=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"rc={proc.returncode}\n{out[-3000:]}\n{err[-3000:]}"
    return out


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The two subprocesses, started together: the reference's specs on an
    8-device test mesh, and the port's dry-run sweep of the smoke configs
    on one card through its CLI."""
    out_dir = str(tmp_path_factory.mktemp("dryrun_torch"))
    ref = _start(_REFERENCE, devices=8)
    pod = _start(_REFERENCE_POD.replace("CASES", repr(POD_CASES)), devices=512)
    sweep = _start(f"""
        import sys
        from repro_torch.launch.dryrun import main
        sys.exit(main(["--all", "--smoke", "--learners", "{LEARNERS}", "--batch", "1",
                       "--out", {out_dir!r}]))
        """)
    yield {"ref": ref, "pod": pod, "sweep": sweep, "out_dir": out_dir}
    for proc in (ref, pod, sweep):  # a test that failed early leaves them running
        proc.kill()
        proc.communicate()


def test_build_spec_matches_reference_on_a_test_mesh(background):
    ref = json.loads(_finish(background["ref"]).split("JSON", 1)[1])
    start_fake_world(512)
    mesh = make_test_mesh(4, 2)
    skipped = set()
    for arch in all_arch_ids():
        for shape in SHAPES:
            want = ref[f"{arch} {shape}"]
            spec = build_spec(get_smoke_config(arch), mesh, shape, device="meta")
            if want is None:
                assert spec is None, (arch, shape)
                skipped.add(arch)
                continue
            args = [[list(a.shape), str(a.dtype).removeprefix("torch."),
                     list(a.local_shape(mesh))] for a in leaves(spec.args)]
            assert args == want["args"], (arch, shape)
            if shape == "train_4k":
                assert spec.bundle.leafwise == want["leafwise"]
                assert spec.bundle.padded_size == want["flat"]
    assert skipped == {a for a in all_arch_ids() if not get_smoke_config(a).subquadratic}
    assert 0 < len(skipped) < len(all_arch_ids())


def test_build_spec_matches_reference_on_the_production_meshes(background):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    ref = json.loads(_finish(background["pod"]).split("JSON", 1)[1])
    start_fake_world(512)
    for arch, shape, multi_pod in POD_CASES:
        mesh = make_production_mesh(multi_pod=multi_pod)
        spec = build_spec(get_config(arch), mesh, shape, device="meta")
        args = [[list(a.shape), str(a.dtype).removeprefix("torch."),
                 list(a.local_shape(mesh))] for a in leaves(spec.args)]
        assert args == ref[f"{arch} {shape} {multi_pod}"], (arch, shape, multi_pod)
        if arch == "gemma2-27b":
            assert spec.bundle.leafwise  # 27 G f32 words > 8 GB


def _real_cpu(cfg, shape_name, **kw):
    """The spec built on the CPU, ready to run for real."""
    torch.manual_seed(0)
    return build_spec(cfg, None, shape_name, shape=SMALL[shape_name], device="cpu", **kw)


@pytest.mark.parametrize("arch", all_arch_ids())
def test_matmul_flops_equal_flop_counter_on_a_real_cpu_run(arch):
    cfg = get_smoke_config(arch)
    for shape in SHAPES:
        kw = dict(learners=LEARNERS) if shape == "train_4k" else {}
        m = dryrun.measure(cfg, shape, shape=SMALL[shape], **kw)
        spec = _real_cpu(cfg, shape, **kw)
        if spec is None:
            assert m is None and not cfg.subquadratic
            continue
        with FlopCounterMode(display=False) as flops:
            spec.fn(*spec.args, **spec.kwargs)
        assert m["matmul_flops"] == flops.get_total_flops() > 0, shape


@pytest.mark.parametrize("arch", all_arch_ids())
def test_serving_peak_equals_mem_tracker_on_a_real_cpu_run(arch):
    cfg = get_smoke_config(arch)
    for shape in ("prefill_32k", "decode_32k"):
        m = dryrun.measure(cfg, shape, shape=SMALL[shape], block=1)  # the CPU's rounding
        spec = _real_cpu(cfg, shape)
        tracker = MemTracker()
        tracker.track_external(*[t for t in leaves(spec.args) if isinstance(t, torch.Tensor)])
        with tracker:
            spec.fn(*spec.args)
        want = tracker.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
        assert abs(m["peak_bytes"] - want) <= 0.01 * want, shape
        assert m["kernels"] == {}


def test_decode_takes_its_cache_as_donated_and_the_dry_run_counts_it_once():
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), n_layers=8)
    assert cfg.dtype == "bfloat16"
    model = Model(cfg, device="cpu")
    cache = model.init_cache(2, 32, prefilled=False)
    with torch.no_grad():
        _, cache = model.prefill(model.tree(), torch.zeros((2, 5), dtype=torch.int32),
                                 cache=cache)
        _, new = model.decode_step(model.tree(), torch.zeros(2, dtype=torch.int32), cache)
    for old, now in zip(cache, new):
        for k in ("k", "v"):
            assert now[k] is old[k]
            assert now[k].untyped_storage().data_ptr() == old[k].untyped_storage().data_ptr()
    m = dryrun.measure(cfg, "decode_32k", shape=dict(seq_len=1024, global_batch=8,
                                                     kind="decode"))
    kv = sum(t.numel() * t.element_size() for c in model.init_cache(8, 1024, device="meta")
             for k, t in c.items() if k in ("k", "v"))
    by = m["peak_by_category"]
    assert by["cache"] >= kv
    # one layer's f32 view of k and v at a time, not a second cache
    assert by["temporaries"] < 0.5 * kv


def test_dry_run_imports_neither_jax_nor_the_reference():
    code = """
        import sys
        import repro_torch.launch.dryrun, repro_torch.launch.input_specs
        import repro_torch.launch.mesh, repro_torch.models.sharding, repro_torch.compat
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("clean")
        """
    assert "clean" in _finish(_start(code), timeout=120)


@pytest.mark.parametrize("shape_name,units,fit", [("train_4k", 4, 2), ("decode_32k", 8, 7)])
def test_max_units_that_fit_predicts_then_confirms(shape_name, units, fit):
    """The most units that fit a capacity set at ``fit`` units' own peak,
    against every depth run: the train step's peak is affine in depth, so
    the 1-2 unit line predicts it; the decode step's first unit costs 1 KiB
    more than the others, so the line falls short and the answer steps up."""
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), n_layers=units)
    kw = dict(learners=LEARNERS) if shape_name == "train_4k" else {}
    peaks = {u: dryrun.measure(dataclasses.replace(cfg, n_layers=u), shape_name,
                               shape=SMALL[shape_name], **kw)["peak_bytes"]
             for u in range(1, units + 1)}
    r = dryrun.max_units_that_fit(cfg, shape_name, peaks[fit], peaks[units],
                                  shape=SMALL[shape_name], **kw)
    assert r["max_units_that_fit"] == fit == max(u for u, p in peaks.items()
                                                 if p <= peaks[fit])
    assert r["max_layers_that_fit"] == fit
    assert (r["predicted_units"] == fit) == (shape_name == "train_4k")
    assert {str(u): peaks[u] for u in (1, 2, fit, fit + 1)}.items() \
        <= r["peak_bytes_by_units"].items()
    r = dryrun.max_units_that_fit(cfg, shape_name, peaks[1] - 1, peaks[units],
                                  shape=SMALL[shape_name], **kw)
    assert r["max_units_that_fit"] == 0


# ---- the production meshes: rank 0's program ----------------------------------------------

# smoke configurations whose heads split 16 ways (16 of 16 columns at d = 256):
# every published one cuts a head or its kv heads at m = 16 only where its full
# configuration does; one layer (gemma3 one unit: a local and a global layer)
def _wide(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), n_heads=16, n_kv_heads=16, **kw)


POD_SMALL = {"train_4k": dict(seq_len=64, global_batch=64, kind="train"),
             "prefill_32k": dict(seq_len=64, global_batch=32, kind="prefill"),
             "decode_32k": dict(seq_len=128, global_batch=128, kind="decode"),
             "long_500k": dict(seq_len=1024, global_batch=1, kind="decode")}
POD_ARCH = {"train_4k": "internlm2-1.8b", "prefill_32k": "internlm2-1.8b",
            "decode_32k": "internlm2-1.8b", "long_500k": "gemma3-12b"}


@pytest.fixture
def _fake_group_after():
    """The fake group the dry run starts, destroyed after the test: one left
    running makes ``init_world`` raise in a later test of this process."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", ["pod256", "pod512"])
@pytest.mark.parametrize("shape", SHAPES)
def test_production_mesh_record_is_rank_zeros_program(shape, mesh, _fake_group_after):
    """Rank 0 of the mesh's grid (16 data x 16 model ranks, two pods on
    pod512) runs its program on meta tensors: a record with its peak, FLOPs
    and the bytes its collectives would send by op; for one decode block
    (embedding, attention, MLP, head) those bytes are the hand count: three
    bf16 psums of the rank's [B_r, 1, d] activations and the all-gather of
    its [B_r, 1, V/16] logits, each (16 - 1) copies."""
    cfg = _wide(POD_ARCH[shape], n_layers=len(get_smoke_config(POD_ARCH[shape]).pattern))
    grid = dryrun.MESH_GRIDS[mesh]
    m = dryrun.measure(cfg, shape, shape=POD_SMALL[shape], per_rank=True, **grid)
    assert m["description"].split(" B")[0].endswith(
        f"rank 0 of n=16 m=16 pods={grid['pods']}"), m["description"]
    assert m["peak_bytes"] > m["argument_bytes"] > 0 and m["matmul_flops"] > 0
    assert m["collective_bytes"]["psum"] > 0 and m["collective_bytes"]["all_gather"] > 0
    if shape == "train_4k":  # rank 0's chunk round: its share of the SAFE kernels
        assert m["kernels"]["mask_add"]["calls"] == 3
    if shape == "decode_32k":
        rows = POD_SMALL[shape]["global_batch"] // (16 * grid["pods"])
        assert m["collective_bytes"] == {"psum": 3 * 15 * rows * cfg.d_model * 2,
                                         "all_gather": 15 * rows * (cfg.vocab // 16) * 2}
    if shape == "long_500k":  # the log-sum-exp merge over the data ranks
        assert m["collective_bytes"]["pmax"] > 0


def test_per_rank_record_keeps_the_logits_vocabulary_sharded(_fake_group_after, monkeypatch):
    """A smoke-size per-rank train_4k record at m = 4 whose vocabulary
    dominates (the smoke internlm2-1.8b, one layer, 32,768 words): rank 0's
    loss is vocabulary-parallel, so its collectives gather no [B, S, V]
    logits — its all-gather bytes are those of the gathered head (the
    loss over the whole vocabulary, as the port took it before) less
    exactly the (m − 1) copies of the rank's [B, S, V/m] logits — and
    ``pmax`` appears; its temporaries fall against the gathered head's by
    at least half of 3·(m − 1)/m of the f32 logits' bytes."""
    from repro_torch.train.loss import next_token_loss
    m, n, B, S = 4, 3, 4, 512
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), vocab=32768, n_layers=1)
    kw = dict(shape=dict(seq_len=S, global_batch=n * B, kind="train"), learners=n, batch=B,
              per_rank=True, model_shards=m)
    sharded = dryrun.measure(cfg, "train_4k", **kw)

    def gathered(self, params, tokens, prefix_embeds=None):
        logits, aux = self.apply(params, tokens, prefix_embeds)
        return next_token_loss(logits, tokens, self.cfg.prefix_embeds), aux

    monkeypatch.setattr(Model, "loss", gathered)
    whole = dryrun.measure(cfg, "train_4k", **kw)
    elem = 2 if cfg.dtype == "bfloat16" else 4
    assert (whole["collective_bytes"]["all_gather"] - sharded["collective_bytes"]["all_gather"]
            == (m - 1) * B * S * (cfg.vocab // m) * elem)
    assert sharded["collective_bytes"]["pmax"] > 0 and "pmax" not in whole["collective_bytes"]
    f32_logits = B * S * cfg.vocab * 4
    fall = (whole["peak_by_category"]["temporaries"]
            - sharded["peak_by_category"]["temporaries"])
    assert fall >= 0.5 * 3 * (m - 1) / m * f32_logits, (fall, f32_logits)


@pytest.mark.parametrize("mesh", ["pod256", "pod512"])
def test_production_mesh_records_run_what_the_port_once_refused(mesh, _fake_group_after):
    """The smoke qwen3-14b's 5 q heads over 16 model ranks, as the full
    configuration's 40 are, once refused: now ``ok``, from rank 0's program,
    which holds one q head (ranks 5-15 hold none) and the kv head every rank
    keeps. Expert parallelism with pods, once refused too: qwen3-moe's
    pod512 train_4k at one layer is ``ok`` and fits, and its ``psum`` bytes
    exceed the same layout's with one pod (the same B_l) by exactly the
    rank's expert gradients in f32, summed over the other pod, and the
    loss's pmean over the pods (one f32 word)."""
    rec = dryrun.run_one("qwen3-14b", "decode_32k", mesh, smoke=True)
    assert rec["status"] == "ok", rec.get("reason")
    assert "rank 0 of n=16 m=16" in rec["description"]
    assert rec["collectives"]["by_op"]["psum"] > 0
    rec = dryrun.run_one("internlm2-1.8b", "long_500k", mesh, smoke=True)
    assert rec["status"] == "skipped"
    if mesh == "pod512":
        # the full configuration (the smoke one's 4 experts do not shard over 16)
        arch = "qwen3-moe-235b-a22b"
        rec = dryrun.run_one(arch, "train_4k", mesh, n_layers=1)
        assert rec["status"] == "ok" and rec["fits"], rec
        assert rec["description"].startswith("train_step rank 0 of n=16 m=16 pods=2 B_l=8")
        one_pod = dryrun.run_one(arch, "train_4k", "pod256", n_layers=1, batch=8)
        assert "pods=1 B_l=8" in one_pod["description"]
        moe = get_config(arch).moe
        words = 3 * (moe.num_experts // 16) * get_config(arch).d_model * (moe.expert_d_ff // 16)
        psum = rec["collectives"]["by_op"]["psum"] - one_pod["collectives"]["by_op"]["psum"]
        assert psum == words * 4 + 4, (psum, words * 4)


# last: the sweep runs in its subprocess while the tests above run
def test_dry_run_sweeps_every_smoke_combination_on_one_card(background):
    _finish(background["sweep"])
    out_dir = background["out_dir"]
    for arch in all_arch_ids():
        for shape in SHAPES:
            with open(os.path.join(out_dir, f"{arch}__{shape}__one.json")) as f:
                rec = json.load(f)
            assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, "one")
            if shape == "long_500k" and not get_smoke_config(arch).subquadratic:
                assert rec["status"] == "skipped"
                continue
            assert rec["status"] == "ok", rec.get("traceback")
            mem = rec["memory"]
            assert mem["total_per_device_bytes"] == sum(mem["peak_by_category"].values())
            assert mem["total_per_device_bytes"] >= mem["argument_bytes"] > 0
            assert rec["matmul_flops"] > 0 and rec["collectives"]["total_bytes"] == 0
            assert rec["device"]["capacity_bytes"] > 0
            assert rec["fits"] == (mem["total_per_device_bytes"]
                                   <= rec["device"]["capacity_bytes"])
            if not rec["fits"]:
                assert 0 <= rec["max_units_that_fit"] < rec["n_units"]
            if shape == "train_4k":
                # the SAFE round's kernels, each word read and written once
                assert rec["kernels"]["mask_add"]["calls"] == 3
                assert rec["kernels"]["chain_combine"]["calls"] == LEARNERS - 1
            else:
                assert rec["kernels"] == {}
