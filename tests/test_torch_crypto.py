"""PyTorch port's crypto substrate vs the JAX package, word for word.

Threefry, both keystream schedules, the key derivations, the fixed-point
codec and the counter allocator, at the shapes and counter bases of
tests/test_kernels.py (including the base 2**32 - 5, whose counters wrap).
Also the port's hygiene: importing it loads no JAX, and no module under
src/repro_torch imports JAX or the JAX package.
"""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto import fixedpoint as jfp
from repro.crypto import np_impl as jnp_impl
from repro.crypto import prf as jprf
from repro_torch.crypto import fixedpoint, np_impl, prf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [1, 5, 127, 128, 129, 1000, 8192, 100_001]
BASES = [0, 1, 2**31, 2**32 - 5]


def _key(seed):
    return np.random.RandomState(seed).randint(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)


def test_threefry2x32_words():
    rng = np.random.RandomState(0)
    for _ in range(4):
        key = rng.randint(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        x0 = rng.randint(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
        x1 = rng.randint(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
        x0[:3] = [0, 2**32 - 1, 2**32 - 5]
        want = jprf.threefry2x32(jnp.asarray(key), jnp.asarray(x0), jnp.asarray(x1))
        got = prf.threefry2x32(key, torch.from_numpy(x0), torch.from_numpy(x1))
        for g, w in zip(got, want):
            assert g.dtype == torch.uint32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("V", SHAPES)
@pytest.mark.parametrize("base", [0, 2**32 - 5])
def test_keystream_pair_lanes_words(V, base):
    key = _key(V)
    want = jprf.keystream_pair_lanes(jnp.asarray(key), V, base)
    got = prf.keystream_pair_lanes(key, V, base, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("V", [3, 256, 4097])
@pytest.mark.parametrize("base", BASES)
def test_keystream_words(V, base):
    key = np.array([11, 13], np.uint32)
    # the jitted reference takes a uint32 base, not a Python int >= 2**31
    want = jprf.keystream(jnp.asarray(key), V, np.uint32(base))
    np.testing.assert_array_equal(prf.keystream(key, V, base, device="cpu").numpy(),
                                  np.asarray(want))
    want2 = jprf.keystream_pair_lanes(jnp.asarray(key), V, base)
    np.testing.assert_array_equal(prf.keystream_pair_lanes(key, V, base, device="cpu").numpy(),
                                  np.asarray(want2))


@pytest.mark.parametrize("offset", [1, 2, 5, 36, 4097])
@pytest.mark.parametrize("V", [1, 2, 37, 1000])
@pytest.mark.parametrize("base", [0, 2**32 - 5])
def test_keystream_pair_lanes_at_a_word_offset(offset, V, base):
    """A pad that starts at word ``offset`` of the two-lane stream, odd
    (mid-block) or even, is that slice of the stream: the reference's
    seekable slab ``keystream_slice_np``, and the slice of its jnp stream."""
    key = _key(offset + V)
    got = prf.keystream_pair_lanes(key, V, base, device="cpu", offset=offset)
    assert got.dtype == torch.uint32 and got.shape == (V,)
    np.testing.assert_array_equal(got.numpy(),
                                  jnp_impl.keystream_slice_np(key, V, offset, base))
    whole = jprf.keystream_pair_lanes(jnp.asarray(key), offset + V, base)
    np.testing.assert_array_equal(got.numpy(), np.asarray(whole)[offset:])


def test_derived_keys():
    master = np.array([0xC0FFEE, 0], np.uint32)
    for tags in [(0,), (0, 5), (0x50,), (0x52, 7, 2**32 - 1)]:
        np.testing.assert_array_equal(
            prf.derive_key(master, *tags).numpy(),
            np.asarray(jprf.derive_key(jnp.asarray(master), *tags)))
    seed = _key(3)
    for i, j in [(0, 1), (7, 0), (35, 0), (2**31, 5)]:
        np.testing.assert_array_equal(
            prf.derive_pair_key(seed, i, j).numpy(),
            np.asarray(jprf.derive_pair_key(jnp.asarray(seed), i, j)))


def test_np_impl_is_the_reference_mirror():
    key = _key(9)
    for n, start, base in [(1, 0, 0), (37, 3, 5), (1000, 1, 2**32 - 2)]:
        np.testing.assert_array_equal(
            np_impl.keystream_slice_np(key, n, start, base),
            jnp_impl.keystream_slice_np(key, n, start, base))
    np.testing.assert_array_equal(np_impl.derive_key_np(key, 0, 1),
                                  jnp_impl.derive_key_np(key, 0, 1))


@pytest.mark.parametrize("scale_bits", [8, 16, 24])
def test_codec_words(scale_bits):
    ref = jfp.FixedPointCodec(scale_bits)
    codec = fixedpoint.FixedPointCodec(scale_bits)
    bound = codec.max_abs_value(36)
    rng = np.random.RandomState(scale_bits)
    x = rng.uniform(-bound, bound, 2000).astype(np.float32)
    # exact half steps: round half to even on both sides
    x[:8] = (np.arange(8, dtype=np.float32) - 3.5) / np.float32(2.0**scale_bits)
    enc = codec.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(ref.encode(jnp.asarray(x))))
    np.testing.assert_array_equal(codec.decode(enc).numpy(),
                                  np.asarray(ref.decode(jnp.asarray(enc.numpy()))))
    np.testing.assert_array_equal(
        codec.decode_mean(enc, 7.0).numpy(),
        np.asarray(ref.decode_mean(jnp.asarray(enc.numpy()), 7.0)))
    a = rng.randint(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(codec.add(ta, tb).numpy(),
                                  np.asarray(ref.add(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(codec.sub(ta, tb).numpy(),
                                  np.asarray(ref.sub(jnp.asarray(a), jnp.asarray(b))))
    assert codec.max_abs_value(3) == ref.max_abs_value(3)


def test_round_counter_refuses_before_mutation():
    rc, ref = prf.RoundCounter(), jprf.RoundCounter()
    for n in (10, 2**31, 2**31 - 10):
        assert rc.reserve(n) == ref.reserve(n)
    assert rc.remaining == ref.remaining == 0
    with pytest.raises(OverflowError):
        rc.reserve(1)
    assert rc.remaining == 0 and rc.reserve(0) == 2**32
    with pytest.raises(ValueError):
        prf.RoundCounter().reserve(-1)


def test_import_does_not_load_jax():
    code = ("import sys; import repro_torch, repro_torch.core, repro_torch.serve, "
            "repro_torch.convert, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; "
            "assert not bad, bad; print('CLEAN')")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CLEAN" in proc.stdout


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_or_repro():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "src", "repro_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 15
    for path in paths:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"
