"""Masking kernels of the PyTorch port.

On the CPU the port's ``kernels.ops`` runs each kernel's plain version;
these tests hold it word for word against the JAX package's Pallas kernels
(``repro.kernels.ops``, interpret mode off the TPU), at tails, odd V and
wrapping counters. The CUDA kernels themselves are held against the plain
versions in tests/test_torch_cuda.py, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.crypto.fixedpoint import FixedPointCodec, ring_add, ring_sub
from repro_torch.crypto.prf import derive_pair_key, keystream_pair_lanes
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
    R = keystream_pair_lanes(rkey, V, 0)
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
        ring_sub(ring_sub(cipher, keystream_pair_lanes(keys[n - 1], V, 0)), R))
    np.testing.assert_allclose(total.numpy(), sum(vals), atol=n / 2**16 + 1e-4)


def test_key_table_layout():
    kin = np.array([[1, 2], [3, 4]], np.uint32)
    kout = np.array([[5, 6], [7, 8]], np.uint32)
    np.testing.assert_array_equal(
        cc.key_table(kin, kout, [9, 2**32 - 5]),
        np.array([[1, 2, 5, 6, 9], [3, 4, 7, 8, 2**32 - 5]], np.uint32))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    build.reset_launches()
    x = torch.zeros(9)
    assert torch.equal(ops.mask_add(x, [1, 2], 3), ref.mask_add_ref(x, [1, 2], 3))
    assert build.launches == {"mask_add": 0, "chain_combine": 0,
                              "chain_combine_batched": 0}


def test_other_devices_and_cpu_tensors_are_refused_by_the_kernels():
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.mask_add(torch.zeros(4, device="meta"), [1, 2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        tma.mask_add(torch.zeros(4), [1, 2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        cc.chain_combine(torch.zeros(4, dtype=torch.uint32), torch.zeros(4),
                         [1, 2], [3, 4])
    with pytest.raises(ValueError, match="expected \\[S, V\\]"):
        cc.chain_combine_batched(torch.zeros(4, dtype=torch.uint32),
                                 torch.zeros(4), [[1, 2]], [[3, 4]], [0])


def test_build_without_nvcc_names_the_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_build_dir_tracks_the_sources():
    d = build.build_dir()
    assert d.parent == build.BUILD_ROOT and len(d.name) == 16
    assert {"mask_add.cu", "chain_combine.cu", "threefry.cuh"} <= {
        p.name for p in build.CSRC.iterdir()}
