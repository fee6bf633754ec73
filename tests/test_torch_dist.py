"""SAFE across processes: the port's per-rank rounds against its one-card
rounds and the JAX package's ``aggregate_sharded``, bit for bit.

The port's side spawns gloo ranks on the CPU (``repro_torch.dist.spawn``,
two intra-op threads each, as this process uses), one learner a rank:
n = 4 for the sequential, rotated, failover, weighted, pipelined, BON and
INSEC rounds and for the collectives, n = 6 for two subgroups. Each rank
runs ``SecureAggregator.aggregate_rank`` (and ``aggregate_sharded`` on a
``launch/mesh.py`` mesh over the live group) on its row; every rank's
mean must equal the others', the one-card ``aggregate`` of the stacked
rows and the reference's, with ``assert_array_equal``. The reference runs
``aggregate_sharded`` (the rotated cells: ``chain_aggregate_sequential``
under ``shard_map``) and ``jax.lax``'s collectives on host devices in a
subprocess.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import REPO, run_multidevice
from repro_torch.core import make_aggregator
from repro_torch.dist import RankPool, World, collectives, init_world, spawn

V, V_ODD = 37, 35          # V_ODD over 4 segments: seg = 9, so pads start at odd words
DEAD = [1, 0, 1, 1]
DEAD0 = [0, 1, 1, 1]       # the elected initiator at rotate 0
THREADS = 2

# name -> (learners, aggregator kwargs, round kwargs); "w" stands for the
# weights, "rotate" cells run the reference's per-rank chain under shard_map.
CELLS = {
    "safe": (4, dict(mode="safe"), {}),
    "saf": (4, dict(mode="saf"), {}),
    "rotate": (4, dict(mode="safe"), dict(rotate=3)),
    "rotate-dead": (4, dict(mode="safe"), dict(rotate=1, alive=DEAD)),
    "dead": (4, dict(mode="safe"), dict(alive=DEAD)),
    "dead-initiator": (4, dict(mode="safe"), dict(alive=DEAD0)),
    "weighted": (4, dict(mode="safe", weighted=True), dict(weights="w")),
    "weighted-dead": (4, dict(mode="safe", weighted=True), dict(weights="w", alive=DEAD)),
    "pipelined": (4, dict(mode="safe", pipelined=True), {}),
    "pipelined-saf": (4, dict(mode="saf", pipelined=True), {}),
    "pipelined-dead": (4, dict(mode="safe", pipelined=True), dict(alive=DEAD0)),
    "pipelined-weighted": (4, dict(mode="safe", pipelined=True, weighted=True),
                           dict(weights="w")),
    "bon": (4, dict(mode="bon"), {}),
    "bon-dead": (4, dict(mode="bon"), dict(alive=DEAD)),
    "insec": (4, dict(mode="insec"), {}),
    "insec-weighted": (4, dict(mode="insec"), dict(weights="w")),
    "subgroups": (6, dict(mode="safe", subgroups=2), {}),
    "subgroups-dead": (6, dict(mode="safe", subgroups=2), dict(alive=[1, 1, 0, 0, 1, 1])),
    "pipelined-subgroups": (6, dict(mode="safe", pipelined=True, subgroups=2), {}),
}
COUNTER = 2**32 - 5        # the pads wrap the 32-bit counter


def _width(name):
    return V_ODD if name.startswith("pipelined") else V


def _inputs(n, width):
    """Seeded rows and weights; a dead rank's row is NaN."""
    rng = np.random.RandomState(n * 1000 + width)
    return (rng.uniform(-2, 2, (n, width)).astype(np.float32),
            rng.uniform(1, 10, n).astype(np.float32))


def _round_args(name):
    """(mode, aggregator kwargs, values [n, V], round kwargs with the
    weights f32[n] filled in)."""
    n, akw, kw = CELLS[name]
    akw, kw = dict(akw), dict(kw)
    vals, w = _inputs(n, _width(name))
    if "alive" in kw:
        vals[np.asarray(kw["alive"]) == 0] = np.nan
    if kw.get("weights") == "w":
        kw["weights"] = w
    return akw.pop("mode"), akw, vals, kw


REF_CODE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
import repro
from repro.core import ChainConfig, make_aggregator, make_round_keys
from repro.core.chain import chain_aggregate_sequential
import test_torch_dist as t

out = {}
for name in t.CELLS:
    mode, akw, vals, kw = t._round_args(name)
    n = vals.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    alive = jnp.asarray(kw.get("alive", np.ones(n)), jnp.float32)
    if "rotate" in kw:
        cfg = ChainConfig(num_learners=n, mode=mode, **akw)
        def pr(v, a, rot=kw["rotate"], cfg=cfg):
            keys = make_round_keys(0xC0FFEE, 0x5EED, t.COUNTER)
            return chain_aggregate_sequential(v.reshape(-1), keys, cfg, alive=a, rotate=rot)
        f = jax.shard_map(pr, mesh=mesh, in_specs=(P("data"), P()), out_specs=P(),
                          axis_names=frozenset({"data"}), check_vma=False)
        with jax.set_mesh(mesh):
            out[name] = np.asarray(jax.jit(f)(jnp.asarray(vals), alive))
        continue
    agg = make_aggregator(mode, n, **akw)
    w = kw.get("weights")
    out[name] = np.asarray(agg.aggregate_sharded(
        mesh, jnp.asarray(vals), t.COUNTER, alive,
        None if w is None else jnp.asarray(w)))

# the collectives over 4 learners
n = 4
mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
x, u = t._collective_inputs(n)
xa, ua = t._a2a_inputs(n)
perm = [(r, (r + 1) % n) for r in range(n)]
def coll(x, u, xa, ua):
    x, u, xa, ua = x.reshape(-1), u.reshape(-1), xa[0], ua[0]
    i = jax.lax.axis_index("data")
    return (jax.lax.ppermute(x, "data", perm)[None], jax.lax.ppermute(u, "data", perm)[None],
            jax.lax.psum(x, "data")[None], jax.lax.psum(u, "data")[None],
            jax.lax.pmean(x, "data")[None], jax.lax.all_gather(u, "data", tiled=True)[None],
            jnp.full((1, 1), i, jnp.int32),
            jax.lax.all_to_all(xa, "data", 0, 0, tiled=True)[None],
            jax.lax.all_to_all(ua, "data", 1, 0, tiled=True)[None],
            jax.lax.all_to_all(xa.reshape(n, -1, 3), "data", 0, 2, tiled=False)[None])
f = jax.shard_map(coll, mesh=mesh, in_specs=(P("data"),) * 4, out_specs=P("data"),
                  axis_names=frozenset({"data"}), check_vma=False)
with jax.set_mesh(mesh):
    res = jax.jit(f)(jnp.asarray(x), jnp.asarray(u), jnp.asarray(xa), jnp.asarray(ua))
for k, r in zip(t.COLLECTIVES, res):
    out["coll/" + k] = np.asarray(r)
np.savez("@OUT@", **out)
print("REF_OK")
"""

COLLECTIVES = ("ppermute_f32", "ppermute_u32", "psum_f32", "psum_u32", "pmean_f32",
               "all_gather_u32", "axis_index", "all_to_all_f32", "all_to_all_u32_axis1",
               "all_to_all_f32_untiled")


def _collective_inputs(n):
    rng = np.random.RandomState(7)
    x = rng.uniform(-3, 3, (n, 129)).astype(np.float32)
    u = rng.randint(0, 2**32, (n, 129), dtype=np.uint64).astype(np.uint32)
    return x, u


def _a2a_inputs(n):
    """Each rank's f32[2n, 3] and uint32[3, 2n] for the all-to-alls."""
    rng = np.random.RandomState(8)
    xa = rng.uniform(-3, 3, (n, 2 * n, 3)).astype(np.float32)
    ua = rng.randint(0, 2**32, (n, 3, 2 * n), dtype=np.uint64).astype(np.uint32)
    return xa, ua


def _ranks(world, names):
    """One rank: every round of ``names`` through ``aggregate_rank`` and, for
    the first, ``aggregate_sharded`` on a mesh over the live group; at
    n = 4 also the collectives."""
    from repro_torch.launch.mesh import make_test_mesh
    out = {}
    for name in names:
        mode, akw, vals, kw = _round_args(name)
        agg = make_aggregator(mode, world.size, device="cpu", **akw)
        w = kw.pop("weights", None)
        out[name] = agg.aggregate_rank(torch.from_numpy(vals[world.rank]), COUNTER,
                                       weights=None if w is None else w[world.rank],
                                       world=world, **kw)
    mesh = make_test_mesh(world.size, 1)
    mode, akw, vals, kw = _round_args(names[0])
    out["sharded/" + names[0]] = make_aggregator(mode, world.size, device="cpu", **akw) \
        .aggregate_sharded(mesh, torch.from_numpy(vals), COUNTER)
    if world.size == 4:
        x, u = _collective_inputs(world.size)
        x, u = torch.from_numpy(x[world.rank]), torch.from_numpy(u[world.rank])
        perm = [(r, (r + 1) % world.size) for r in range(world.size)]
        got = (collectives.ppermute(x, perm, world), collectives.ppermute(u, perm, world),
               collectives.psum(x, world), collectives.psum(u, world),
               collectives.pmean(x, world), collectives.all_gather(u, world, tiled=True),
               torch.tensor([collectives.axis_index(world)], dtype=torch.int32))
        xa, ua = (torch.from_numpy(a[world.rank]) for a in _a2a_inputs(world.size))
        got += (collectives.all_to_all(xa, world),
                collectives.all_to_all(ua, world, split_axis=1, concat_axis=0),
                collectives.all_to_all(xa.reshape(world.size, -1, 3), world, 0, 2,
                                       tiled=False))
        out.update({"coll/" + k: v for k, v in zip(COLLECTIVES, got)})
        out["gather_to_host"] = collectives.gather_to_host(u, 2, world)
        collectives.reset_stats()
        collectives.psum(x, world)
        untimed = collectives.stats["seconds"]
        collectives.reset_stats(timed=True)
        collectives.psum(x, world)
        out["seconds"] = (untimed, collectives.stats["seconds"])
        collectives.reset_stats()
    return out


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads here and in each rank: a CPU reduction's order
    follows the thread count, and the one-card round must sum as the
    ranks do."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results: rank r of n is at ``ranks[n][r]``."""
    by_n = {}
    for n in sorted({c[0] for c in CELLS.values()}):
        names = [k for k, c in CELLS.items() if c[0] == n]
        by_n[n] = [r["result"] for r in spawn(_ranks, n, "cpu", args=(names,),
                                              threads=THREADS)]
    return by_n


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_ref") / "ref.npz"
    code = ("import sys; sys.path.insert(0, %r)\n" % os.path.join(REPO, "tests")
            + REF_CODE.replace("@OUT@", str(path)))
    assert "REF_OK" in run_multidevice(code, devices=6, timeout=600)
    return dict(np.load(path))


def _one_card(name):
    mode, akw, vals, kw = _round_args(name)
    agg = make_aggregator(mode, vals.shape[0], device="cpu", **akw)
    return agg.aggregate(torch.from_numpy(vals), COUNTER, **kw)


@pytest.mark.parametrize("name", list(CELLS))
def test_rank_round_equals_one_card_and_reference(ranks, reference, name):
    n = CELLS[name][0]
    got = [r[name] for r in ranks[n]]
    want = _one_card(name)
    assert want.dtype == torch.float32 and want.shape == (_width(name),)
    for r, g in enumerate(got):
        assert g.dtype == torch.float32 and g.shape == want.shape, r
        np.testing.assert_array_equal(g.numpy().view(np.uint32), got[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(got[0].numpy(), want.numpy())
    np.testing.assert_array_equal(got[0].numpy(), reference[name])


@pytest.mark.parametrize("n", [4, 6])
def test_aggregate_sharded_on_live_mesh(ranks, n):
    """``aggregate_sharded`` over a ``make_test_mesh(n, 1)`` of the live
    group: each rank takes its row of the global matrix."""
    name = next(k for k, c in CELLS.items() if c[0] == n)
    want = _one_card(name)
    for r in ranks[n]:
        np.testing.assert_array_equal(r["sharded/" + name].numpy(), want.numpy())


@pytest.mark.parametrize("op", COLLECTIVES)
def test_collectives_match_jax_lax(ranks, reference, op):
    """Each collective on each rank equals ``jax.lax``'s on that device, bit
    for bit (an f32 psum here is the one-card sum over the learner dim; at
    n = 4 it adds in XLA's order too; the all-to-alls tiled over dim 0 and
    from dim 1 to dim 0, and untiled into dim 2)."""
    want = reference["coll/" + op]
    for r, res in enumerate(ranks[4]):
        got = res["coll/" + op].numpy()
        assert got.dtype == want.dtype, (op, got.dtype, want.dtype)
        np.testing.assert_array_equal(got.reshape(-1), want[r].reshape(-1))


def test_psum_f32_is_the_one_card_sum(ranks):
    x, _ = _collective_inputs(4)
    want = torch.from_numpy(x).sum(dim=0)
    for res in ranks[4]:
        assert torch.equal(res["coll/psum_f32"], want)


def test_gather_to_host_lands_on_one_rank(ranks):
    """The tiled gather on rank 2 only, in host memory, bits unchanged."""
    _, u = _collective_inputs(4)
    for r, res in enumerate(ranks[4]):
        got = res["gather_to_host"]
        if r != 2:
            assert got is None
            continue
        assert got.device.type == "cpu" and got.dtype == torch.uint32
        np.testing.assert_array_equal(got.numpy(), u.reshape(-1))


def test_collectives_are_timed_only_when_asked(ranks):
    for res in ranks[4]:
        untimed, timed = res["seconds"]
        assert untimed == 0.0 and timed > 0.0


def _raises_on_rank_one(world):
    if world.rank == 1:
        raise RuntimeError("rank one fails")
    return world.rank


def test_spawn_fails_when_a_rank_raises():
    with pytest.raises(Exception, match="rank one fails"):
        spawn(_raises_on_rank_one, 2, "cpu", threads=1)


def _pid_and_sum(world, x):
    return os.getpid(), world.rank, float(collectives.psum(torch.tensor(world.rank + x,
                                                                       dtype=torch.float32),
                                                           world))


def test_rank_pool_keeps_its_ranks_across_calls():
    """Two calls on one ``RankPool`` run on the same started processes, in
    rank order; a rank's raise fails the call with its message and closes
    the pool, which then refuses another call."""
    with RankPool(2, "cpu", threads=1) as pool:
        first = [r["result"] for r in pool.run(_pid_and_sum, (1,))]
        second = [r["result"] for r in pool.run(_pid_and_sum, (2,))]
        assert [r[1:] for r in first] == [(0, 3.0), (1, 3.0)]  # (0 + 1) + (1 + 1)
        assert [r[1:] for r in second] == [(0, 5.0), (1, 5.0)]
        assert [r[0] for r in first] == [r[0] for r in second]
        assert len({r[0] for r in first}) == 2 and os.getpid() not in {r[0] for r in first}
        with pytest.raises(RuntimeError, match="rank one fails"):
            pool.run(_raises_on_rank_one)
        assert pool.closed
        with pytest.raises(RuntimeError, match="closed"):
            pool.run(_pid_and_sum, (3,))


def _wrong_size(world):
    make_aggregator("safe", 3, device="cpu").aggregate_rank(torch.zeros(4), world=world)


def test_rank_count_must_be_the_learner_count():
    with pytest.raises(Exception, match="one learner a rank"):
        spawn(_wrong_size, 4, "cpu", threads=1)


@pytest.mark.parametrize("device,transport,err", [
    ("cuda", None, RuntimeError), ("cuda", "nccl", RuntimeError),
    ("cuda", "host", RuntimeError), ("cuda", "gloo", ValueError),
    ("cpu", "nccl", ValueError), ("cpu", "host", ValueError)])
def test_transport_is_never_chosen_silently(device, transport, err):
    """nccl without a card a rank raises (here: no card at all), and so does
    a transport that does not fit the device; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the no-card refusals cannot show")
    import torch.distributed as dist
    with pytest.raises(err):
        init_world(0, 2, dist.HashStore(), device=device, transport=transport)
    assert not dist.is_initialized()


def test_world_routes_by_transport():
    w = World(rank=1, size=4, device=torch.device("cpu"), transport="gloo")
    assert (w.backend, w.stage, w.global_rank(3)) == ("gloo", False, 3)
    h = World(rank=0, size=4, device=torch.device("cpu"), transport="host")
    assert (h.backend, h.stage) == ("gloo", True)
    assert World(0, 2, torch.device("cpu"), "nccl").backend == "nccl"


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.dist, repro_torch.core, repro_torch.launch.mesh\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\nprint('CLEAN')")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env)
    assert proc.returncode == 0 and "CLEAN" in proc.stdout, proc.stderr[-2000:]
