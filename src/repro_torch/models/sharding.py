"""Parameter partition specs (Megatron TP + expert-parallel layout).

The counterpart of the JAX package's ``models/sharding.py``, with the same
path rules over the tree ``Model.tree()`` gives (paths from
``train/flatten.py``'s walk, e.g. ``blocks/0/attn/wq``):

  embed / lm_head       : vocab over 'model'
  attn wq/wk/wv         : [U, d, H·hd]   -> heads over 'model'
  attn wo               : [U, H·hd, d]   -> 'model' on the contracted dim
  mlp wi/wg             : [U, d, ff]     -> ff over 'model'
  mlp wo                : [U, ff, d]     -> 'model' on ff
  moe wi/wg             : [U, E, d, f]   -> experts over 'data', f over 'model'
  moe wo                : [U, E, f, d]   -> experts over 'data', f over 'model'
  mamba in_proj/out_proj, rwkv projections: like mlp
  norms / scalars       : replicated

A spec is a tuple with one entry per dim: ``None``, a mesh axis name, or a
tuple of names — the content of a ``PartitionSpec``. ``placements`` turns
one into DTensor placements on a ``DeviceMesh`` (the counterpart of
``NamedSharding(mesh, spec)``); ``launch/input_specs.py``'s ``ArgSpec``
gives a device's shard.
On one card the learner axis is dim 0 of a learner-major tensor and none
of this applies; the dry run (``launch/dryrun.py``) reads these specs for
the pod meshes.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.train.flatten import tree_map_with_path

_COL = {"wq", "wk", "wv", "wi", "wg", "w_proj", "in_proj",
        "wr", "shared_wi", "shared_wg"}
_ROW = {"wo", "out_proj", "shared_wo"}


def _spec_for(path: str, leaf, cfg: ModelConfig) -> tuple:
    name = path.rsplit("/", 1)[-1]
    nd = len(leaf.shape)
    if name in ("embed", "lm_head"):
        # [V, d] or [nc, V, d]
        return ("model", None) if nd == 2 else (None, "model", None)
    if "moe/" in path and name in ("wi", "wg", "wo"):
        # [U, E, d/f, f/d]: experts over 'data', expert-ff over 'model'
        if name == "wo":
            return (None, "data", "model", None)
        return (None, "data", None, "model")
    if name == "router":
        return (None,) * nd
    if name in _COL and nd >= 2:
        return (None,) * (nd - 2) + (None, "model")
    if name in _ROW and nd >= 2:
        return (None,) * (nd - 2) + ("model", None)
    return (None,) * nd


def _names(part) -> tuple:
    return part if isinstance(part, tuple) else (part,)


def sanitize_spec(spec: tuple, shape, axes_sizes: dict) -> tuple:
    """Drop named axes from dims they don't divide (XLA requires exact
    tiling for explicit input shardings — e.g. internvl2's vocab 151655
    is not divisible by 16). The spec comes back one entry per dim."""
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        size = 1
        for a in _names(part) if part is not None else ():
            size *= axes_sizes.get(a, 1)
        out.append(part if part is not None and dim % size == 0 else None)
    return tuple(out)


def param_pspecs(cfg: ModelConfig, params, axes_sizes: dict | None = None):
    """The tree of specs matching ``params`` (``Model.tree()``'s structure;
    any leaf with a ``shape``)."""
    def build(path, x):
        spec = _spec_for(path, x, cfg)
        if axes_sizes:
            spec = sanitize_spec(spec, tuple(x.shape), axes_sizes)
        return spec
    return tree_map_with_path(build, params)


def axes_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements on ``mesh`` for ``spec``: mesh dim i is
    ``Shard(d)`` where dim d of the spec names it, else ``Replicate()``."""
    from repro_torch.compat import Replicate, Shard
    where = {}
    for d, part in enumerate(spec):
        for a in _names(part) if part is not None else ():
            if a not in mesh.mesh_dim_names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of the mesh's "
                                 f"{mesh.mesh_dim_names}")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)

