"""Masking kernels of the PyTorch port.

On the CPU the port's ``kernels.ops`` runs each kernel's plain version;
these tests hold it word for word against the JAX package's Pallas kernels
(``repro.kernels.ops``, interpret mode off the TPU), at tails, odd V and
wrapping counters. Pads that start at a word offset (the pipelined
schedule's segments), which no Pallas kernel takes, are held against the
reference's seekable slab ``np_impl.keystream_slice_np``. The CUDA kernels themselves are held against the plain
versions in tests/test_torch_cuda.py, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.crypto.np_impl import keystream_slice_np
from repro.kernels import ops as jops
from repro_torch.crypto.fixedpoint import FixedPointCodec, ring_add, ring_sub
from repro_torch.crypto.prf import derive_pair_key, keystream_pair_lanes
from repro_torch.kernels import bon_mask as bm
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import chain_combine as cc
from repro_torch.kernels import threefry_mask_add as tma

U32_MAX = 2**32


def _u32(rng, shape):
    return rng.randint(0, U32_MAX, shape, dtype=np.uint64).astype(np.uint32)


def _same(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))


@pytest.mark.parametrize("V,base", [(1, 0), (5, 2**32 - 5), (127, 0), (128, 7),
                                    (129, 2**32 - 5), (1000, 2**31), (4097, 1),
                                    (100_001, 42)])
def test_mask_add_matches_pallas(V, base):
    rng = np.random.RandomState(V)
    x = rng.uniform(-100, 100, V).astype(np.float32)
    key = _u32(rng, 2)
    _same(ops.mask_add(torch.from_numpy(x), key, base),
          jops.mask_add(jnp.asarray(x), jnp.asarray(key), base))


@pytest.mark.parametrize("scale_bits", [8, 16, 24])
def test_mask_add_scale_bits(scale_bits):
    x = np.random.RandomState(2).uniform(-3, 3, 500).astype(np.float32)
    key = np.array([1, 2], np.uint32)
    _same(ops.mask_add(torch.from_numpy(x), key, 0, scale_bits=scale_bits),
          jops.mask_add(jnp.asarray(x), jnp.asarray(key), 0, scale_bits=scale_bits))


@pytest.mark.parametrize("V,base", [(7, 9), (640, 2**32 - 5), (4097, 9)])
def test_chain_combine_matches_pallas(V, base):
    rng = np.random.RandomState(V)
    cipher = _u32(rng, V)
    x = rng.uniform(-50, 50, V).astype(np.float32)
    kin, kout = np.array([11, 22], np.uint32), np.array([33, 44], np.uint32)
    _same(ops.chain_combine(torch.from_numpy(cipher), torch.from_numpy(x), kin, kout, base),
          jops.chain_combine(jnp.asarray(cipher), jnp.asarray(x), jnp.asarray(kin),
                             jnp.asarray(kout), base))


@pytest.mark.parametrize("S,V", [(1, 128), (3, 1000), (8, 257)])
def test_chain_combine_batched_matches_pallas(S, V):
    rng = np.random.RandomState(S * 1000 + V)
    cipher = _u32(rng, (S, V))
    x = rng.uniform(-50, 50, (S, V)).astype(np.float32)
    kin, kout, bases = _u32(rng, (S, 2)), _u32(rng, (S, 2)), _u32(rng, (S,))
    bases[0] = 2**32 - 5
    want = jops.chain_combine_batched(jnp.asarray(cipher), jnp.asarray(x),
                                      jnp.asarray(kin), jnp.asarray(kout),
                                      jnp.asarray(bases))
    _same(ops.chain_combine_batched(torch.from_numpy(cipher), torch.from_numpy(x),
                                    kin, kout, bases), want)


@pytest.mark.parametrize("m", [1, 2, 8, 15, 36])
@pytest.mark.parametrize("V,base", [(1, 0), (129, 2**32 - 5), (1001, 5)])
def test_bon_mask_matches_pallas(m, V, base):
    rng = np.random.RandomState(m * 7 + V)
    x = rng.uniform(-50, 50, V).astype(np.float32)
    keys = _u32(rng, (m, 2))
    signs = rng.choice([-1, 1], m).astype(np.int32)
    want = jops.bon_mask(jnp.asarray(x), jnp.asarray(keys), jnp.asarray(signs), base)
    _same(ops.bon_mask(torch.from_numpy(x), keys, signs, base), want)
    _same(ref.bon_mask_ref(torch.from_numpy(x), keys, signs, base), want)


def test_bon_pairwise_cancellation():
    """Opposite-sign pads cancel: bon_mask(x, +k) + bon_mask(y, -k) ==
    encode(x) + encode(y), and with no keys bon_mask is the encode."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.uniform(-5, 5, 513).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-5, 5, 513).astype(np.float32))
    k = np.array([[123, 456], [7, 8]], np.uint32)
    codec = FixedPointCodec(16)
    a = ops.bon_mask(x, k, [1, -1], 2**32 - 5)
    b = ops.bon_mask(y, k, [-1, 1], 2**32 - 5)
    assert torch.equal(ring_add(a, b), ring_add(codec.encode(x), codec.encode(y)))
    assert torch.equal(ops.bon_mask(x, np.zeros((0, 2), np.uint32), []), codec.encode(x))


@pytest.mark.parametrize("offset", [1, 2, 5, 10_001])
@pytest.mark.parametrize("V,base", [(1, 0), (2, 7), (37, 2**32 - 5), (1000, 2**31)])
def test_mask_add_at_a_word_offset(offset, V, base):
    """mask_add whose pad starts at word ``offset`` (odd: mid-block) of the
    stream: encode(x) plus the reference's slab of the stream."""
    rng = np.random.RandomState(offset + V)
    x = rng.uniform(-100, 100, V).astype(np.float32)
    key = _u32(rng, 2)
    with np.errstate(over="ignore"):
        want = (FixedPointCodec(16).encode(torch.from_numpy(x)).numpy()
                + keystream_slice_np(key, V, offset, base))
    _same(ops.mask_add(torch.from_numpy(x), key, base, offset=offset), want)
    assert torch.equal(ops.mask_add(torch.from_numpy(x), key, base, offset=0),
                       ops.mask_add(torch.from_numpy(x), key, base))


@pytest.mark.parametrize("S,V,seg", [(8, 5, 5), (4, 10, 10), (3, 129, 129), (5, 64, 1)])
def test_batched_rows_at_start_words(S, V, seg):
    """The pipelined step's rows: row s's pads start at word s·seg of each
    stream (odd seg: every other row starts mid-block). Each row equals the
    hop computed from the reference's slabs, and offset 0 is the plain hop."""
    rng = np.random.RandomState(S * 100 + V)
    cipher, kin, kout = _u32(rng, (S, V)), _u32(rng, (S, 2)), _u32(rng, (S, 2))
    x = rng.uniform(-50, 50, (S, V)).astype(np.float32)
    bases = np.full(S, 2**32 - 3, np.uint32)
    starts = np.arange(S) * seg
    got = ops.chain_combine_batched(torch.from_numpy(cipher), torch.from_numpy(x),
                                    kin, kout, bases, starts=starts)
    enc = FixedPointCodec(16).encode(torch.from_numpy(x)).numpy()
    with np.errstate(over="ignore"):
        want = np.stack([cipher[s] - keystream_slice_np(kin[s], V, starts[s], bases[s])
                         + enc[s] + keystream_slice_np(kout[s], V, starts[s], bases[s])
                         for s in range(S)])
    _same(got, want)
    _same(ops.chain_combine_batched(torch.from_numpy(cipher), torch.from_numpy(x),
                                    kin, kout, bases, starts=np.zeros(S)),
          jops.chain_combine_batched(jnp.asarray(cipher), jnp.asarray(x),
                                     jnp.asarray(kin), jnp.asarray(kout),
                                     jnp.asarray(bases)))


def test_batched_rows_equal_single_hops():
    rng = np.random.RandomState(42)
    S, V = 4, 513
    cipher = torch.from_numpy(_u32(rng, (S, V)))
    x = torch.from_numpy(rng.uniform(-5, 5, (S, V)).astype(np.float32))
    kin, kout = _u32(rng, (S, 2)), _u32(rng, (S, 2))
    bases = np.arange(S, dtype=np.uint32) * 1000
    batched = ops.chain_combine_batched(cipher, x, kin, kout, bases)
    for s in range(S):
        assert torch.equal(batched[s], ops.chain_combine(cipher[s], x[s], kin[s],
                                                         kout[s], bases[s]))


def test_four_hop_roundtrip_matches_reference_chain():
    """A 4-hop chain of the port's kernels leaves the reference's
    ciphertext word for word, and unmasks to the sum of the inputs."""
    from repro.crypto.prf import derive_pair_key as jpair
    from repro.crypto.prf import keystream_pair_lanes as jks
    V, n = 1000, 4
    rng = np.random.RandomState(0)
    vals = [rng.uniform(-5, 5, V).astype(np.float32) for _ in range(n)]
    seed = np.array([9, 9], np.uint32)
    rkey = np.array([77, 88], np.uint32)

    keys = [derive_pair_key(seed, i, (i + 1) % n) for i in range(n)]
    R = keystream_pair_lanes(rkey, V, 0, device="cpu")
    cipher = ring_add(ops.mask_add(torch.from_numpy(vals[0]), keys[0], 0), R)
    for i in range(1, n):
        cipher = ops.chain_combine(cipher, torch.from_numpy(vals[i]), keys[i - 1],
                                   keys[i], 0)

    jkeys = [jpair(jnp.asarray(seed), i, (i + 1) % n) for i in range(n)]
    jR = jks(jnp.asarray(rkey), V, 0)
    jc = jops.mask_add(jnp.asarray(vals[0]), jkeys[0], 0) + jR
    for i in range(1, n):
        jc = jops.chain_combine(jc, jnp.asarray(vals[i]), jkeys[i - 1], jkeys[i], 0)
    _same(cipher, jc)

    total = FixedPointCodec(16).decode(
        ring_sub(ring_sub(cipher, keystream_pair_lanes(keys[n - 1], V, 0, device="cpu")), R))
    np.testing.assert_allclose(total.numpy(), sum(vals), atol=n / 2**16 + 1e-4)


def test_key_table_layout():
    """Batched rows are (kin, kout, first counter, lead): a start word w
    of the stream at base b is counter b + w // 2 (mod 2^32), lane w & 1."""
    kin = np.array([[1, 2], [3, 4]], np.uint32)
    kout = np.array([[5, 6], [7, 8]], np.uint32)
    np.testing.assert_array_equal(
        cc.key_table(kin, kout, [9, 2**32 - 5]),
        np.array([[1, 2, 5, 6, 9, 0], [3, 4, 7, 8, 2**32 - 5, 0]], np.uint32))
    np.testing.assert_array_equal(
        cc.key_table(kin, kout, [9, 2**32 - 5], starts=[5, 2**33 + 12]),
        np.array([[1, 2, 5, 6, 11, 1], [3, 4, 7, 8, 1, 0]], np.uint32))
    with pytest.raises(ValueError, match="start words"):
        cc.key_table(kin, kout, [9, 9], starts=[1])
    np.testing.assert_array_equal(
        bm.key_table([[1, 2], [3, 4], [5, 6]], [1, -1, 0]),
        np.array([[1, 2, 1], [3, 4, 0], [5, 6, 0]], np.uint32))
    with pytest.raises(ValueError, match="signs"):
        bm.key_table([[1, 2]], [1, 1])


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    build.reset_launches()
    x = torch.zeros(9)
    assert torch.equal(ops.mask_add(x, [1, 2], 3), ref.mask_add_ref(x, [1, 2], 3))
    assert torch.equal(ops.bon_mask(x, [[1, 2]], [-1], 3),
                       ref.bon_mask_ref(x, [[1, 2]], [-1], 3))
    assert build.launches == {"mask_add": 0, "chain_combine": 0,
                              "chain_combine_batched": 0, "bon_mask": 0}


def test_other_devices_and_cpu_tensors_are_refused_by_the_kernels():
    # a meta tensor takes the ops' shape functions: no kernel, no launch
    build.reset_launches()
    ops.reset_fake_calls()
    out = ops.mask_add(torch.zeros(4, device="meta"), [1, 2])
    assert (out.device.type, out.shape, out.dtype) == ("meta", (4,), torch.uint32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tma.mask_add(torch.zeros(4), [1, 2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc.chain_combine(torch.zeros(4, dtype=torch.uint32), torch.zeros(4),
                         [1, 2], [3, 4])
    with pytest.raises(ValueError, match="expected \\[S, V\\]"):
        cc.chain_combine_batched(torch.zeros(4, dtype=torch.uint32),
                                 torch.zeros(4), [[1, 2]], [[3, 4]], [0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        bm.bon_mask(torch.zeros(4), [[1, 2]], [1])
    assert ops.bon_mask(torch.zeros(4, device="meta"), [[1, 2]], [1]).device.type == "meta"
    assert not any(build.launches.values())
    assert ops.fake_calls["mask_add"] == {"calls": 1, "bytes": 32}
    assert ops.fake_calls["bon_mask"] == {"calls": 1, "bytes": 32}


def test_build_without_nvcc_names_the_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_build_dir_tracks_the_sources():
    d = build.build_dir()
    assert d.parent == build.BUILD_ROOT and len(d.name) == 16
    assert {"mask_add.cu", "chain_combine.cu", "bon_mask.cu", "threefry.cuh"} <= {
        p.name for p in build.CSRC.iterdir()}
    assert set(build.LIBRARIES) == set(build.launches) - {"chain_combine_batched"}


def _op_cases():
    """Each op's schema arguments: keys and counter bases as ints, a
    counter base that wraps, odd lengths."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.uniform(-9, 9, 129).astype(np.float32))
    cipher = torch.from_numpy(_u32(rng, 129))
    rows = torch.from_numpy(rng.uniform(-9, 9, (3, 65)).astype(np.float32))
    crow = torch.from_numpy(_u32(rng, (3, 65)))
    keys = [int(k) for k in _u32(rng, 6)]
    return {
        "mask_add": (x, keys[0], keys[1], 2**32 - 5, 3, 16),
        "chain_combine": (cipher, x, keys[:2], keys[2:4], 2**32 - 5, 16),
        "chain_combine_batched": (crow, rows, keys, keys[::-1], [0, 7, 2**32 - 5], [0, 1, 6],
                                  16),
        "bon_mask": (x, keys, [1, -1, 1], 2**31, 16),
    }


@pytest.mark.parametrize("name", ["mask_add", "chain_combine", "chain_combine_batched",
                                  "bon_mask"])
def test_custom_op_opcheck_on_cpu(name):
    """Each kernel is a torch.library custom op: its schema and its shape
    function (the fake implementation) agree with the CPU route, and the
    shape function counts its call and bytes but no launch."""
    op = getattr(torch.ops.repro_torch, name)
    args = _op_cases()[name]
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    build.reset_launches()
    ops.reset_fake_calls()
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    out = op(*meta)
    want = op(*args)
    assert (out.shape, out.dtype) == (want.shape, want.dtype)
    per_word = 12 if name.startswith("chain") else 8
    assert ops.fake_calls[name] == {"calls": 1, "bytes": per_word * args[0].numel()}
    assert not any(build.launches.values())
