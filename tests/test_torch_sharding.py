"""Partition specs, placements and meshes of the PyTorch port.

``repro_torch.models.sharding`` and ``serve.engine.cache_pspecs`` against
the JAX package's, entry for entry (a port spec is the content of a
``PartitionSpec``): the parameter specs of all ten configurations at their
published widths, the cache specs of every smoke configuration, and
``sanitize_spec`` on the JAX package's own cases. DTensor placements on a
fake 8-rank (4, 2) mesh give the shard shapes JAX's ``NamedSharding``
gives, computed in a subprocess with 512 host devices, which also builds
the reference's production meshes.
"""
import json

import jax
import numpy as np
import pytest
import torch
from helpers import run_multidevice
from jax.sharding import PartitionSpec as P

import repro  # noqa: F401  (jax API shims)
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.models.sharding import param_pspecs as jparam_pspecs
from repro.models.transformer import Model as JModel
from repro.serve.engine import cache_pspecs as jcache_pspecs
from repro.train.flatten import _path_str
from repro_torch.configs import all_arch_ids, get_config, get_smoke_config
from repro_torch.launch.input_specs import ArgSpec
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh, start_fake_world
from repro_torch.models import Model
from repro_torch.models.sharding import param_pspecs, placements, sanitize_spec
from repro_torch.serve.engine import cache_pspecs
from repro_torch.train.flatten import leaves, leaves_with_paths

AXES = [None, {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
        {"data": 4, "model": 2}]


def _jspecs(tree):
    """(path, spec tuple) of every PartitionSpec of a JAX tree, in order."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(_path_str(p), tuple(s)) for p, s in flat]


def _specs(tree):
    """(path, spec) of every spec of a port tree (a spec is a tuple, so
    the walk stops at the tuples of the last level)."""
    out = []

    def walk(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{prefix}{k}/")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}/")
        elif t is not None:
            out.append((prefix[:-1], t))
    walk(tree, "")
    return out


@pytest.fixture(scope="module")
def full_params():
    """{arch: (JAX abstract params, the port's meta tree)} at published widths."""
    return {a: (jax.eval_shape(JModel(jget_config(a)).init, jax.random.key(0)),
                Model(get_config(a), device="meta").tree()) for a in all_arch_ids()}


@pytest.mark.parametrize("axes", AXES, ids=["none", "pod256", "pod512", "test8"])
def test_param_pspecs_match_reference_at_published_widths(full_params, axes):
    for arch in all_arch_ids():
        jtree, tree = full_params[arch]
        want = _jspecs(jparam_pspecs(jget_config(arch), jtree, axes))
        got = _specs(param_pspecs(get_config(arch), tree, axes))
        assert got == want, arch
        assert [p for p, _ in got] == [p for p, _ in leaves_with_paths(tree)]


@pytest.mark.parametrize("spec,shape,axes,want", [
    (("model", None), (151655, 896), {"model": 16}, (None, None)),
    (("model", None), (256, 8), {"model": 16}, ("model", None)),
    ((("pod", "data"), None), (64, 8), {"pod": 2, "data": 16}, (("pod", "data"), None)),
    ((("pod", "data"), None), (33, 8), {"pod": 2, "data": 16}, (None, None)),
    (("model",), (32, 4, 4), {"model": 16}, ("model", None, None)),
])
def test_sanitize_spec_cases_of_the_reference(spec, shape, axes, want):
    from repro.models.sharding import sanitize_spec as jsanitize
    assert sanitize_spec(spec, shape, axes) == want
    assert tuple(jsanitize(P(*spec), shape, axes)) == want


@pytest.mark.parametrize("model_size", [1, 16])
@pytest.mark.parametrize("layout", ["batch", "seq", "neither"])
def test_cache_pspecs_match_reference(layout, model_size):
    batch_sharded, seq_axis = {"batch": (True, None), "seq": (False, "data"),
                               "neither": (False, None)}[layout]
    for arch in all_arch_ids():
        jm = JModel(jget_smoke_config(arch))
        jcache = jax.eval_shape(lambda: jm.init_cache(2, 64, prefilled=True))  # noqa: B023
        cache = Model(get_smoke_config(arch), device="meta").init_cache(2, 64, device="meta")
        want = _jspecs(jcache_pspecs(jcache, batch_sharded, seq_axis, model_size))
        got = _specs(cache_pspecs(cache, batch_sharded, seq_axis, model_size))
        assert got == want, arch


_REFERENCE_SHARDS = """
import json, numpy as np
import jax, repro
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_production_mesh, make_test_mesh
cases = json.loads({cases!r})
mesh = make_test_mesh(4, 2)
out = {{"shards": [list(NamedSharding(mesh, P(*[tuple(p) if isinstance(p, list) else p
                                                for p in spec])).shard_shape(tuple(shape)))
                   for shape, spec in cases],
       "meshes": {{name: [list(m.axis_names), list(m.devices.shape)] for name, m in (
           ("pod256", make_production_mesh()), ("pod512", make_production_mesh(multi_pod=True)),
           ("test", mesh), ("test_pod", make_test_mesh(4, 2, pod=2)))}}}}
print("JSON" + json.dumps(out))
"""


def _shard_cases():
    """(shape, spec) pairs: a smoke config's parameters and cache under the
    test mesh's axes, and specs with axis tuples."""
    cfg = get_smoke_config("qwen3-moe-235b-a22b")
    model = Model(cfg, device="meta")
    tree = model.tree()
    cases = [(list(x.shape), list(s)) for x, (_, s) in zip(
        leaves(tree), _specs(param_pspecs(cfg, tree, {"data": 4, "model": 2})))]
    cache = model.init_cache(8, 64, device="meta")
    cases += [(list(x.shape), list(s)) for x, (_, s) in zip(
        leaves(cache), _specs(cache_pspecs(cache, True, None, 2)))]
    cases += [([16, 6], [["data", "model"], None]), ([8, 4, 2], [None, "data", "model"]),
              ([8], []), ([24, 8], [["model", "data"]])]
    return cases


def test_placements_give_jax_shard_shapes_and_meshes():
    cases = _shard_cases()
    out = run_multidevice(_REFERENCE_SHARDS.format(cases=json.dumps(cases)), devices=512,
                          timeout=300)
    ref = json.loads(out.split("JSON", 1)[1])
    start_fake_world(512)
    mesh = make_test_mesh(4, 2)
    for (shape, spec), want in zip(cases, ref["shards"]):
        spec = tuple(tuple(p) if isinstance(p, list) else p for p in spec)
        arg = ArgSpec(tuple(shape), torch.float32, spec, placements(spec, mesh))
        assert list(arg.local_shape(mesh)) == want, (shape, spec)
    for name, m in (("pod256", make_production_mesh()),
                    ("pod512", make_production_mesh(multi_pod=True)),
                    ("test", mesh), ("test_pod", make_test_mesh(4, 2, pod=2))):
        assert [list(m.mesh_dim_names), list(m.shape)] == ref["meshes"][name], name
        assert m.device_type == "cuda"
    from repro_torch.compat import Replicate, Shard
    assert placements((None, ("data", "model")), mesh) == (Shard(1), Shard(1))
    assert placements(("model",), mesh) == (Replicate(), Shard(0))
    with pytest.raises(ValueError, match="not one of the mesh's"):
        placements(("pod",), mesh)


def test_meshes_raise_when_the_world_is_too_small():
    try:
        start_fake_world(8)
        with pytest.raises(RuntimeError, match="need 256 devices.*start_fake_world"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="need 512 devices"):
            make_production_mesh(multi_pod=True)
        with pytest.raises(RuntimeError, match="need 16 devices"):
            make_test_mesh(4, 2, pod=2)
        assert make_test_mesh(4, 2).shape == (4, 2)
    finally:
        start_fake_world(512)
    assert torch.distributed.get_world_size() == 512
    assert np.prod(make_production_mesh(multi_pod=True).shape) == 512
