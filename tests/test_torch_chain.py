"""The PyTorch port's rounds vs the JAX package's, bit for bit.

The JAX side runs ``SecureAggregator.aggregate_sharded`` (and, for the
rotation cells, ``chain_aggregate_sequential`` under ``shard_map``; for the
hierarchical cells, ``aggregate`` under ``shard_map`` over a ("pod",
"data") mesh) on a host-device mesh in a subprocess and writes its
published means to an npz. The port runs the same inputs learner-major
(pod-major for the pods) on the CPU, through the plain versions of its
kernels. Every SAFE, SAF, pipelined, BON and hierarchical cell must be
equal with ``assert_array_equal``; INSEC sums floats in another order and
is held to ``allclose`` (rtol 1e-6).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro.core import ChainConfig as JChainConfig
from repro.core import make_round_keys as j_make_round_keys
from repro.topology import AliveTracker as JAliveTracker
from repro.topology import RingTopology as JRingTopology
from repro.topology import elect_initiator_local as j_elect
from repro.topology import make_topology as j_make_topology
from repro_torch import convert
from repro_torch.core import (SecureAggregator, chain_aggregate_sequential,
                              make_aggregator, make_round_keys)
from repro_torch.topology import (AliveTracker, HierarchicalTopology, RingTopology,
                                  elect_initiator_local, make_topology)

N, V = 8, 37
ALIVE_FAIL = [1, 1, 1, 0, 1, 0, 1, 1]
ALIVE_INIT = [0, 1, 1, 1, 1, 1, 1, 1]
ALIVE_ROT3 = [1, 1, 1, 0, 1, 1, 1, 1]

# name -> (aggregator kwargs, aggregate kwargs); "w" stands for the weights.
CELLS = {
    "saf": (dict(mode="saf"), {}),
    "safe": (dict(mode="safe"), {}),
    "safe-wrapping-counter": (dict(mode="safe"), dict(counter_base=2**32 - 5)),
    "subgroups": (dict(mode="safe", subgroups=2), {}),
    "failover": (dict(mode="safe"), dict(alive=ALIVE_FAIL)),
    "init-failover": (dict(mode="safe"), dict(alive=ALIVE_INIT)),
    "weighted": (dict(mode="safe", weighted=True), dict(weights="w")),
    "weighted-failover": (dict(mode="safe", weighted=True),
                          dict(weights="w", alive=ALIVE_FAIL)),
    "subgroups-failover": (dict(mode="safe", subgroups=2), dict(alive=ALIVE_FAIL)),
    # BON ignores weights and subgroups, as the reference does
    "bon": (dict(mode="bon"), {}),
    "bon-failover": (dict(mode="bon"), dict(alive=ALIVE_FAIL)),
    "bon-wrapping-counter": (dict(mode="bon"), dict(counter_base=2**32 - 5)),
    "bon-subgroups2": (dict(mode="bon", subgroups=2), {}),
    "bon-weighted": (dict(mode="bon", weighted=True), dict(weights="w")),
    # V = 37 over 8 segments: seg = 5, so odd segments start mid-block
    "pipelined": (dict(mode="safe", pipelined=True), {}),
    "pipelined-saf": (dict(mode="saf", pipelined=True), {}),
    "pipelined-failover": (dict(mode="safe", pipelined=True), dict(alive=ALIVE_FAIL)),
    "pipelined-rank0-dead": (dict(mode="safe", pipelined=True), dict(alive=ALIVE_INIT)),
    "pipelined-subgroups": (dict(mode="safe", pipelined=True, subgroups=2), {}),
    "pipelined-weighted": (dict(mode="safe", pipelined=True, weighted=True),
                           dict(weights="w")),
    "pipelined-wrapping-counter": (dict(mode="safe", pipelined=True),
                                   dict(counter_base=2**32 - 5)),
}
# Hierarchical cells: name -> (pods P, learners per pod n, aggregator
# kwargs, alive bitmap of every pod or None). One weight per global rank.
HIER = {
    "hier-p2": (2, 4, dict(mode="safe"), None),
    "hier-p3": (3, 4, dict(mode="safe"), None),
    "hier-p3-failover": (3, 4, dict(mode="safe"), [1, 0, 1, 1]),
    "hier-p3-weighted": (3, 4, dict(mode="safe", weighted=True), None),
    "hier-p3-pipelined": (3, 4, dict(mode="safe", pipelined=True), None),
    "hier-p3-bon": (3, 4, dict(mode="bon"), [1, 1, 1, 0]),
    "hier-p2-subgroups": (2, 6, dict(mode="safe", subgroups=2), None),
}
ROTATIONS = {"rot1": (1, None), "rot3": (3, None), "rot7": (7, None),
             "rot3-dead3": (3, ALIVE_ROT3)}

REF_CODE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import ChainConfig, make_aggregator, make_round_keys
from repro.core.chain import chain_aggregate_sequential

CELLS, ROTATIONS, HIER = @CELLS@, @ROTATIONS@, @HIER@
mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
n, V = 8, 37
rng = np.random.RandomState(0)
vals = rng.uniform(-2, 2, size=(n, V)).astype(np.float32)
w = rng.uniform(1, 10, size=(n,)).astype(np.float32)
vals_nan = vals.copy()
vals_nan[3] = np.nan                     # dead in the failover cells
out = {"values": vals, "weights": w}
for name, (akw, kw) in CELLS.items():
    akw, kw = dict(akw), dict(kw)
    mode = akw.pop("mode")
    if kw.get("weights") == "w":
        kw["weights"] = jnp.asarray(w)
    if "alive" in kw:
        kw["alive"] = jnp.asarray(kw["alive"], jnp.float32)
    v = vals_nan if name.endswith("failover") and name != "init-failover" else vals
    agg = make_aggregator(mode, n, **akw)
    out[name] = np.asarray(agg.aggregate_sharded(mesh, jnp.asarray(v), **kw))
out["insec"] = np.asarray(make_aggregator("insec", n).aggregate_sharded(
    mesh, jnp.asarray(vals), weights=jnp.asarray(w)))

cfg = ChainConfig(num_learners=n, mode="safe")
for name, (rot, alive) in ROTATIONS.items():
    a = np.ones(n, np.float32) if alive is None else np.asarray(alive, np.float32)
    def pr(v, a, rot=rot):
        keys = make_round_keys(0xC0FFEE, 0x5EED, 0)
        return chain_aggregate_sequential(v.reshape(-1), keys, cfg, alive=a, rotate=rot)
    f = jax.shard_map(pr, mesh=mesh, in_specs=(P("data"), P()), out_specs=P(),
                      axis_names=frozenset({"data"}), check_vma=False)
    with jax.set_mesh(mesh):
        out[name] = np.asarray(jax.jit(f)(jnp.asarray(vals), jnp.asarray(a)))

# three subgroup rings of three: the publish sums three group averages
mesh9 = Mesh(np.array(jax.devices()[:9]), ("data",))
vals9 = rng.uniform(-2, 2, size=(9, V)).astype(np.float32)
out["values9"] = vals9
out["subgroups3"] = np.asarray(make_aggregator("safe", 9, subgroups=3)
                               .aggregate_sharded(mesh9, jnp.asarray(vals9)))

# pods: global rank p * n + r holds pod p's learner r, as shard_map over
# ("pod", "data") lays out a [P * n, V] matrix
for name, (pods, hn, akw, alive) in HIER.items():
    akw = dict(akw)
    mode = akw.pop("mode")
    meshp = Mesh(np.array(jax.devices()[:pods * hn]).reshape(pods, hn), ("pod", "data"))
    hv = rng.uniform(-1, 1, size=(pods * hn, V)).astype(np.float32)
    hw = rng.uniform(1, 10, size=(pods * hn,)).astype(np.float32)
    ha = np.ones(hn, np.float32) if alive is None else np.asarray(alive, np.float32)
    out[name + "/values"], out[name + "/weights"] = hv.copy(), hw
    hv[np.tile(ha, pods) == 0] = np.nan      # dead ranks' rows never reach the sum
    agg = make_aggregator(mode, hn, axis="data", pod_axis="pod", **akw)
    def pr(v, w, a, agg=agg):
        return agg.aggregate(v.reshape(-1), 0, a, w.reshape(()))
    f = jax.shard_map(pr, mesh=meshp, in_specs=(P(("pod", "data")), P(("pod", "data")), P()),
                      out_specs=P(), axis_names=frozenset({"pod", "data"}), check_vma=False)
    with jax.set_mesh(meshp):
        out[name] = np.asarray(jax.jit(f)(jnp.asarray(hv), jnp.asarray(hw), jnp.asarray(ha)))
np.savez("@OUT@", **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("chain_ref") / "ref.npz"
    code = (REF_CODE.replace("@CELLS@", repr(CELLS))
            .replace("@ROTATIONS@", repr(ROTATIONS)).replace("@HIER@", repr(HIER))
            .replace("@OUT@", str(path)))
    assert "REF_OK" in run_multidevice(code, devices=12)
    return dict(np.load(path))


def _port_kwargs(kw, ref):
    kw = dict(kw)
    if kw.get("weights") == "w":
        kw["weights"] = ref["weights"]
    return kw


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_published_mean_bit_identical(reference, cell):
    akw, kw = CELLS[cell]
    akw = dict(akw)
    jcfg = JChainConfig(num_learners=N, **akw)
    agg = SecureAggregator(convert.chain_config(dataclasses.asdict(jcfg)), device="cpu")
    vals = reference["values"].copy()
    if "failover" in cell and cell != "init-failover":
        vals[3] = np.nan  # a dead rank's NaN must not reach the sum
    got = agg.aggregate(torch.from_numpy(vals), **_port_kwargs(kw, reference))
    assert got.dtype == torch.float32 and got.shape == (V,)
    np.testing.assert_array_equal(got.numpy(), reference[cell])


@pytest.mark.parametrize("cell", sorted(ROTATIONS))
def test_rotated_round_bit_identical(reference, cell):
    rot, alive = ROTATIONS[cell]
    agg = make_aggregator("safe", N, device="cpu")
    got = agg.aggregate(reference["values"], alive=alive, rotate=rot)
    np.testing.assert_array_equal(got.numpy(), reference[cell])


@pytest.mark.parametrize("cell", sorted(HIER))
def test_hierarchical_bit_identical(reference, cell):
    """Pod-major [P, n, V] through ``pod_axis``: every pod on the same keys
    and alive bitmap, the mean over pods of their published means."""
    pods, n, akw, alive = HIER[cell]
    akw = dict(akw)
    vals = reference[cell + "/values"].reshape(pods, n, V).copy()
    if alive is not None:
        vals[:, np.asarray(alive) == 0] = np.nan
    agg = make_aggregator(akw.pop("mode"), n, pod_axis="pod", device="cpu", **akw)
    got = agg.aggregate(vals, alive=alive,
                        weights=reference[cell + "/weights"].reshape(pods, n))
    assert got.dtype == torch.float32 and got.shape == (V,)
    np.testing.assert_array_equal(got.numpy(), reference[cell])


def test_three_subgroups_bit_identical(reference):
    got = make_aggregator("safe", 9, subgroups=3, device="cpu").aggregate(
        reference["values9"])
    np.testing.assert_array_equal(got.numpy(), reference["subgroups3"])


def test_insec_matches(reference):
    got = make_aggregator("insec", N, device="cpu").aggregate(
        reference["values"], weights=reference["weights"])
    np.testing.assert_allclose(got.numpy(), reference["insec"], rtol=1e-6)


def test_round_keys_match_and_convert(reference):
    """make_round_keys for all ranks == the reference's per-rank keys, and
    the round run on converted reference keys publishes the same mean."""
    ref_keys = [j_make_round_keys(0xC0FFEE, 0x5EED, 11, rank=jnp.uint32(r))
                for r in range(N)]
    keys = convert.round_keys(np.asarray(ref_keys[0].provisioning_seed),
                              np.stack([np.asarray(k.learner_seed) for k in ref_keys]),
                              np.asarray(ref_keys[0].counter_base))
    mine = make_round_keys(0xC0FFEE, 0x5EED, 11, N)
    np.testing.assert_array_equal(mine.provisioning_seed, keys.provisioning_seed)
    np.testing.assert_array_equal(mine.learner_seed, keys.learner_seed)
    assert mine.counter_base == keys.counter_base == 11
    keys0 = dataclasses.replace(keys, counter_base=0)
    cfg = convert.chain_config(dataclasses.asdict(JChainConfig(num_learners=N)))
    got = chain_aggregate_sequential(torch.from_numpy(reference["values"]), keys0, cfg)
    np.testing.assert_array_equal(got.numpy(), reference["safe"])


def test_aggregate_tree_is_the_flattened_round(reference):
    vals = torch.from_numpy(reference["values"])
    tree = {"b": vals[:, :12].reshape(N, 3, 4), "a": vals[:, 12:].clone()}
    agg = make_aggregator("safe", N, device="cpu")
    out = agg.aggregate_tree(tree)
    flat = agg.aggregate(torch.cat([tree["a"], tree["b"].reshape(N, -1)], dim=1))
    assert out["b"].shape == (3, 4) and out["a"].shape == (V - 12,)
    assert torch.equal(out["a"], flat[:V - 12])
    assert torch.equal(out["b"].reshape(-1), flat[V - 12:])


def test_every_reference_mode_constructs():
    """BON, the pipelined schedule and the pod axis build as the reference's
    do; an unknown mode is still refused, and so is a [n, V] matrix where
    the pod axis wants [P, n, V]."""
    for kw in (dict(mode="bon"), dict(mode="safe", pipelined=True),
               dict(mode="saf", pipelined=True, subgroups=2),
               dict(mode="safe", pod_axis="pod"), dict(mode="bon", pod_axis="pod")):
        mode = kw.pop("mode")
        agg = make_aggregator(mode, N, device="cpu", **kw)
        jagg_cfg = JChainConfig(num_learners=N, mode=mode, **kw)
        assert agg.cfg == convert.chain_config(dataclasses.asdict(jagg_cfg))
    with pytest.raises(ValueError, match="unknown mode"):
        make_aggregator("sac", N, device="cpu")
    with pytest.raises(ValueError, match=r"\[P, 8, V\]"):
        make_aggregator("safe", N, pod_axis="pod", device="cpu").aggregate(
            np.zeros((N, 4), np.float32))


def test_aggregate_tree_with_pods_is_the_flattened_round():
    rng = np.random.RandomState(4)
    vals = torch.from_numpy(rng.uniform(-1, 1, (2, N, 10)).astype(np.float32))
    agg = make_aggregator("safe", N, pod_axis="pod", pipelined=True, device="cpu")
    out = agg.aggregate_tree({"w": vals[:, :, :6].reshape(2, N, 2, 3),
                              "b": vals[:, :, 6:].clone()})
    flat = agg.aggregate(torch.cat([vals[:, :, 6:], vals[:, :, :6]], dim=-1))
    assert torch.equal(out["b"], flat[:4])
    assert torch.equal(out["w"].reshape(-1), flat[4:])


def test_alive_must_be_a_bitmap():
    agg = make_aggregator("safe", N, device="cpu")
    vals = np.zeros((N, 4), np.float32)
    with pytest.raises(ValueError, match="0/1"):
        agg.aggregate(vals, alive=[2] + [1] * (N - 1))
    with pytest.raises(ValueError, match="entries"):
        agg.aggregate(vals, alive=[1] * (N - 1))


def test_topology_matches_reference():
    for n, g in [(8, 1), (8, 2), (9, 3), (36, 1)]:
        topo, jtopo = RingTopology(n, g), JRingTopology(n, g)
        np.testing.assert_array_equal(topo.successor_map(), jtopo.successor_map())
        assert topo.ring_permutation() == jtopo.ring_permutation()
        assert topo.group_chains(1) == jtopo.group_chains(1)
    rng = np.random.RandomState(1)
    for _ in range(50):
        m = rng.randint(3, 12)
        ga = (rng.uniform(size=m) > 0.4).astype(np.float32)
        rot = int(rng.randint(-20, 40))
        assert elect_initiator_local(ga, rot) == int(j_elect(ga, rot))
        assert elect_initiator_local(ga, rot) == int(j_elect(jnp.asarray(ga), rot,
                                                             xp=jnp))
    for pods, n, g in [(2, 4, 1), (3, 4, 1), (2, 6, 2), (4, 9, 3)]:
        topo, jtopo = make_topology(n, g, pods), j_make_topology(n, g, pods)
        assert isinstance(topo, HierarchicalTopology)
        assert (topo.num_learners, topo.subgroups, topo.group_size) == (
            jtopo.num_learners, jtopo.subgroups, jtopo.group_size)
        np.testing.assert_array_equal(topo.successor_map(), jtopo.successor_map())
        assert topo.group_chains(3) == jtopo.group_chains(3)
        for r in range(topo.num_learners):
            assert (topo.pod_of(r), topo.pod_local(r), topo.predecessor(r)) == (
                jtopo.pod_of(r), jtopo.pod_local(r), jtopo.predecessor(r))
        assert topo.elect_initiators() == jtopo.elect_initiators()
        for _ in range(10):
            alive = (rng.uniform(size=pods * n) > 0.3).astype(np.float32)
            rot = int(rng.randint(0, 20))
            assert topo.elect_initiators(alive, rot) == jtopo.elect_initiators(alive, rot)
    assert isinstance(make_topology(8, 2, 1), RingTopology)
    with pytest.raises(ValueError, match="pods"):
        HierarchicalTopology(0, RingTopology(4))
    tracker, jtracker = AliveTracker(RingTopology(9, 3), 2), JAliveTracker(JRingTopology(9, 3), 2)
    for t in (tracker, jtracker):
        t.report_failure(0), t.report_failure(0), t.report_failure(4)
        t.tick(np.array([1, 1, 0, 1, 1, 1, 0, 0, 1], bool))
        t.tick(np.array([1, 1, 0, 1, 1, 1, 1, 0, 1], bool))
    np.testing.assert_array_equal(tracker.alive(), jtracker.alive())
    assert tracker.compact_chains() == jtracker.compact_chains()
    assert tracker.elect_initiators(5) == jtracker.elect_initiators(5)
    assert tracker.degraded_groups() == jtracker.degraded_groups()
