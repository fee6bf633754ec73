"""The PyTorch port's checkpoints against the JAX package's.

* The port's msgpack subset writes what ``msgpack.packb`` writes, byte for
  byte, and reads what it writes.
* A train state with bf16 and f32 leaves, an int32 step, a NamedTuple and
  empty subtrees, saved by the reference, restores in the port bit for
  bit, and the reverse; so does the port's own train state, the
  expert-parallel one with its ``ep_opt`` included.
* Blobs: gzip, raw and zstd-tagged ones, stale siblings, ``latest_step``.
* A process in which ``jax``, ``repro``, ``msgpack``, ``ml_dtypes`` and
  ``zstandard`` cannot be imported still imports the train step, the
  launcher, the checkpoints and the load harness, and saves and restores.
"""
import dataclasses
import gzip
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from helpers import REPO
from repro.ckpt import checkpoint as ref_ckpt
from repro.optim.adamw import AdamState as RefAdamState
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.core import make_aggregator
from repro_torch.models import Model
from repro_torch.optim.adamw import AdamState
from repro_torch.train import make_train_step
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


OBJECTS = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    "", "a", "é" * 10, "x" * 31, "x" * 32, "x" * 255, "x" * 256, "x" * 65536,
    [], [1] * 15, [1] * 16, [1] * 65536, {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, None, True, False, 1.5, -0.0, b"", b"\x00" * 300,
    {"step": 7, "treedef": "PyTreeDef({'a': *})", "leaves": [
        {"dtype": "bfloat16", "shape": [2, 3], "nbytes": 12},
        {"dtype": "float32", "shape": [], "nbytes": 4}], "extra": {"step": 7}},
]


@pytest.mark.parametrize("i", range(len(OBJECTS)))
def test_msgpack_subset_byte_equal(i):
    obj = OBJECTS[i]
    data = msgpack.packb(obj)
    assert ckpt.packb(obj) == data
    assert ckpt.unpackb(data) == msgpack.unpackb(data)


def _state(rng, torch_side: bool):
    """A train state's structure with bf16, f32 and int leaves: the
    reference's (jnp) or the port's (torch) leaves, from the same bits."""
    w = rng.standard_normal((3, 5)).astype(np.float32)
    bf = torch.from_numpy(w).to(torch.bfloat16)
    bits = bf.view(torch.int16).numpy()
    f32 = rng.standard_normal(7).astype(np.float32)
    m = rng.standard_normal(7).astype(np.float32)
    if torch_side:
        return {"params": {"blocks": [{"w": bf.clone()}], "final_norm": {"scale": torch.from_numpy(f32)}},
                "master": torch.from_numpy(m), "fm": torch.from_numpy(m * 2),
                "fv": torch.from_numpy(m * m), "fstep": torch.tensor(5, dtype=torch.int32),
                "ep_opt": None,
                "sec_opt": AdamState(torch.tensor(2, dtype=torch.int32),
                                     {"w": torch.from_numpy(f32 * 3)}, {"w": torch.from_numpy(f32 * 4)}),
                "step": 11}
    bfj = jnp.asarray(bits).view(jnp.bfloat16)
    return {"params": {"blocks": [{"w": bfj}], "final_norm": {"scale": jnp.asarray(f32)}},
            "master": jnp.asarray(m), "fm": jnp.asarray(m * 2), "fv": jnp.asarray(m * m),
            "fstep": jnp.asarray(5, jnp.int32), "ep_opt": None,
            "sec_opt": RefAdamState(jnp.asarray(2, jnp.int32), {"w": jnp.asarray(f32 * 3)},
                                    {"w": jnp.asarray(f32 * 4)}),
            "step": 11}


def _bits(leaf) -> tuple:
    """(dtype name, shape, raw bytes) of a jax, torch or Python leaf."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", tuple(leaf.shape), leaf.view(torch.int16).numpy().tobytes()
        a = leaf.numpy()
    else:
        a = np.asarray(leaf)
    return str(a.dtype), a.shape, a.tobytes()


def test_reference_checkpoint_restores_in_port(tmp_path):
    rng = np.random.RandomState(0)
    ref_state = _state(rng, torch_side=False)
    ref_ckpt.save_checkpoint(str(tmp_path), 3, ref_state, extra={"step": 3, "counter": 99})
    skeleton = _state(np.random.RandomState(1), torch_side=True)
    got, extra = restore_checkpoint(str(tmp_path), 3, skeleton)
    assert extra == {"step": 3, "counter": 99}
    assert isinstance(got["sec_opt"], AdamState) and got["ep_opt"] is None
    assert got["step"] == 11 and isinstance(got["step"], int)
    want = _state(np.random.RandomState(0), torch_side=True)
    assert len(leaves(got)) == len(leaves(want)) == 10
    for a, b in zip(leaves(got), leaves(want)):
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor)
        assert _bits(a) == _bits(b)


def test_port_checkpoint_restores_in_reference(tmp_path):
    port_state = _state(np.random.RandomState(0), torch_side=True)
    save_checkpoint(str(tmp_path), 4, port_state, extra={"step": 4})
    skeleton = _state(np.random.RandomState(1), torch_side=False)
    got, extra = ref_ckpt.restore_checkpoint(str(tmp_path), 4, skeleton)
    assert extra == {"step": 4}
    want = _state(np.random.RandomState(0), torch_side=False)
    import jax
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        if isinstance(b, int):  # the reference restores a Python int as an array
            assert int(a) == b
        else:
            assert _bits(a) == _bits(b)


def test_manifest_is_msgpack(tmp_path):
    """The manifest the port writes is a msgpack map the reference's
    decoder reads, and re-encoding it with msgpack gives the same bytes."""
    save_checkpoint(str(tmp_path), 1, _state(np.random.RandomState(0), True), {"step": 1})
    with gzip.open(tmp_path / "step_00000001" / "manifest.msgpack.gz") as f:
        data = f.read()
    manifest = msgpack.unpackb(data)
    assert msgpack.packb(manifest) == data == ckpt.packb(manifest)
    assert manifest["step"] == 1 and manifest["extra"] == {"step": 1}
    assert [m["dtype"] for m in manifest["leaves"]][:2] == ["float32", "int32"]
    assert {"dtype": "bfloat16", "shape": [3, 5], "nbytes": 30} in manifest["leaves"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_round_trips_both_ways(tmp_path, dtype):
    """The port's train state at the smoke size, after one step: saved by
    the port and read back by both packages, every leaf bit for bit; the
    reference's copy, saved again by the reference, restores in the port
    bit for bit."""
    import jax
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), dtype=dtype)
    model = Model(cfg, device="cpu")
    agg = make_aggregator("safe", 4, device="cpu")
    bundle = make_train_step(model, agg, lr=1e-3)
    state = bundle.init_state_fn(model.tree())
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (4, 1, 16)).astype(np.int32)
    state, _ = bundle.step_fn(state, toks, counter=agg.reserve_round(bundle.padded_size + 2))
    save_checkpoint(str(tmp_path / "port"), 1, state, extra={"step": 1})
    mine, _ = restore_checkpoint(str(tmp_path / "port"), 1, bundle.init_state_fn(model.tree()))
    assert [_bits(a) for a in leaves(mine)] == [_bits(a) for a in leaves(state)]
    # the reference reads it into a skeleton of its own arrays
    ref, extra = ref_ckpt.restore_checkpoint(str(tmp_path / "port"), 1, _as_jax(state))
    assert extra == {"step": 1}
    want = [_bits(a) for a in leaves(state)]
    # the int step comes last: the reference restores it as an int32 array
    assert [_bits(a) for a in jax.tree.leaves(ref)][:-1] == want[:-1]
    assert int(ref["step"]) == 1
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1, ref, extra={"step": 1})
    back, _ = restore_checkpoint(str(tmp_path / "ref"), 1, bundle.init_state_fn(model.tree()))
    assert [_bits(a) for a in leaves(back)][:-1] == want[:-1]
    assert back["step"] == 1 and isinstance(back["step"], int)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ep_train_state_round_trips_both_ways(tmp_path, dtype):
    """The expert-parallel train state (smoke qwen3-moe after one step):
    ``ep_opt`` is an AdamState of an int32 step and m, v trees that hold
    the expert leaves and None elsewhere, as the reference's. Saved by the
    port, it restores in the port and in the reference bit for bit, and the
    reference's save of it restores in the port bit for bit."""
    import jax
    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-235b-a22b"), dtype=dtype,
                              ep_axis="data", ep_ranks=4)
    model = Model(cfg, device="cpu")
    agg = make_aggregator("safe", 4, device="cpu")
    bundle = make_train_step(model, agg, lr=1e-3)
    state = bundle.init_state_fn(model.tree())
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (4, 1, 16)).astype(np.int32)
    state, _ = bundle.step_fn(state, toks, counter=agg.reserve_round(bundle.padded_size + 2))
    ep = state["ep_opt"]
    assert isinstance(ep, AdamState) and int(ep.step) == 1 and ep.step.dtype == torch.int32
    assert len(leaves(ep.m)) == len(leaves(ep.v)) == 3  # wi, wg, wo
    save_checkpoint(str(tmp_path / "port"), 1, state, extra={"step": 1})
    mine, _ = restore_checkpoint(str(tmp_path / "port"), 1, bundle.init_state_fn(model.tree()))
    want = [_bits(a) for a in leaves(state)]
    assert [_bits(a) for a in leaves(mine)] == want
    ref, _ = ref_ckpt.restore_checkpoint(str(tmp_path / "port"), 1, _as_jax(state))
    assert isinstance(ref["ep_opt"], RefAdamState)
    assert [_bits(a) for a in jax.tree.leaves(ref)][:-1] == want[:-1]
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1, ref, extra={"step": 1})
    back, _ = restore_checkpoint(str(tmp_path / "ref"), 1, bundle.init_state_fn(model.tree()))
    assert [_bits(a) for a in leaves(back)][:-1] == want[:-1]


def _as_jax(tree):
    """A jax skeleton of the port's state (the reference's own leaf types)."""
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, AdamState):
        return RefAdamState(*[_as_jax(v) for v in tree])
    if isinstance(tree, list):
        return [_as_jax(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return jnp.zeros(tuple(tree.shape), jnp.float32)
    return tree  # a Python number, or None (an empty subtree in both)


def test_blob_codecs(tmp_path):
    """gzip is written; raw and gzip blobs are read; a zstd-tagged blob
    raises the reference's error on a host without zstandard; a save
    removes a stale sibling of another codec."""
    base = str(tmp_path / "blob")
    data = b"payload" * 100
    ckpt._write_tagged(base, data)
    assert os.path.exists(base + ".gz") and ckpt._read_tagged(base) == data
    os.remove(base + ".gz")
    with open(base, "wb") as f:  # raw, as the reference reads a bare file
        f.write(data)
    assert ckpt._read_tagged(base) == ref_ckpt._read_tagged(base) == data
    with open(base + ".zst", "wb") as f:  # a stale zstd sibling, preferred on read
        f.write(ckpt._ZSTD_MAGIC + b"\x00" * 8)
    try:
        import zstandard  # noqa: F401
    except ModuleNotFoundError:
        with pytest.raises(RuntimeError) as port_err:
            ckpt._read_tagged(base)
        with pytest.raises(RuntimeError) as ref_err:
            ref_ckpt._read_tagged(base)
        assert str(port_err.value) == str(ref_err.value)
    ckpt._write_tagged(base, data)
    assert not os.path.exists(base + ".zst") and not os.path.exists(base)
    assert ckpt._read_tagged(base) == ref_ckpt._read_tagged(base) == data


def test_latest_step(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    assert latest_step(str(tmp_path)) is None
    for s in (2, 10, 4):
        save_checkpoint(str(tmp_path), s, {"x": torch.zeros(2)})
    (tmp_path / "step_00000099.tmp").mkdir()
    (tmp_path / "notes").mkdir()
    assert latest_step(str(tmp_path)) == ref_ckpt.latest_step(str(tmp_path)) == 10


def test_shape_mismatch_refused(tmp_path):
    """A checkpoint that does not fit the skeleton is refused (the reference
    asserts; the port raises, so the check survives ``python -O``)."""
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 1, {"x": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="structure changed"):
        restore_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2, 3), "y": torch.zeros(1)})


BLOCKED_CODE = """
import sys
BLOCKED = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes", "zstandard")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this process")
        return None

sys.meta_path.insert(0, Block())
import os, tempfile
import numpy as np, torch
import repro_torch.train.train_step, repro_torch.launch.train, repro_torch.ckpt
import repro_torch.net.loadgen
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
state = {"params": {"w": torch.randn(4, 3).to(torch.bfloat16), "b": torch.randn(5)},
         "fstep": torch.tensor(3, dtype=torch.int32), "ep_opt": None, "step": 7}
d = tempfile.mkdtemp()
save_checkpoint(d, 7, state, extra={"step": 7})
skel = {"params": {"w": torch.zeros(4, 3), "b": torch.zeros(5)},
        "fstep": torch.zeros((), dtype=torch.int32), "ep_opt": None, "step": 0}
got, extra = restore_checkpoint(d, latest_step(d), skel)
assert extra == {"step": 7} and got["step"] == 7
assert torch.equal(got["params"]["w"].view(torch.int16), state["params"]["w"].view(torch.int16))
assert got["params"]["w"].dtype == torch.bfloat16
assert torch.equal(got["params"]["b"], state["params"]["b"]) and got["fstep"].dtype == torch.int32
print("BLOCKED_OK")
"""


def test_no_jax_msgpack_ml_dtypes_or_zstandard_needed():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(BLOCKED_CODE)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BLOCKED_OK" in proc.stdout
