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

Tensor parallelism across ranks (``Model(cfg, tp_world=...)``): model rank
j of m holds ``shard_leaf`` of each leaf, cut by the ``Split`` that
``tp_dim`` gives: slice j of m along the dim where ``_spec_for`` puts
'model' after ``sanitize_spec`` (a dim that m does not divide stays
replicated, as the reference's: internvl2's vocabulary of 151,655 at
m = 2), or, for Mamba2's packed ``in_proj`` [z | x | B | C | dt], a
segmented split: z, x and dt cut by head, B and C replicated. The
reference's GSPMD cuts that leaf's columns evenly across the segment
boundaries and reshards around the cut; the flat vector's words are the
one-card order either way. Attention is split on whole heads only. The
q heads and wo split when m divides them. The kv heads split when m divides them, and stay replicated when
they divide m (fewer kv heads than ranks: each rank's q heads then share
one kv head, ``j·n_kv/m``). Any other split would cut a head in two and
raises ``ValueError``. The reference's ``sanitize_spec`` looks only at the
column count there, so GSPMD cuts a head (14 q heads of 64 at m = 4:
896 columns divide by 4) and reshards around it
(``tests/test_torch_dist_tp.py``). Every block kind splits: Mamba2 and
RWKV6 by head, the MoE's expert-ff and shared experts by column (the
router replicated), zamba2's shared block as the dense ones; ``check_tp``
raises where a split would cut a head or an ff column.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.train.flatten import Split, leaves_with_paths, tree_map_with_path

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
        lead = (None,) * (nd - 3)
        if name == "wo":
            return lead + ("data", "model", None)
        return lead + ("data", None, "model")
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



_ATTN = {"wq", "wk", "wv", "wo"}
_RECURRENT = ("mamba2", "rwkv6")


def check_tp(cfg: ModelConfig, m: int) -> None:
    """Raise unless ``cfg`` splits over ``m`` model ranks without cutting a
    unit that must stay whole: a q or kv head, a Mamba2 or RWKV6 head, or
    an MLP's or an expert's ff column (the message names the count; the
    shared experts' s·ff columns split wherever an expert's f does)."""
    if m == 1:
        return
    kinds = set(cfg.pattern)

    def whole(count: int, what: str) -> None:
        if count % m:
            raise ValueError(f"{cfg.arch_id}: {count} {what} over {m} model shards would cut "
                             f"one in two; pick m dividing {count}")
    if kinds - set(_RECURRENT):  # attention: the head rules
        _heads(cfg, "wq", m)
        _heads(cfg, "wk", m)
    if "mamba2" in kinds:
        whole(mamba2_dims(cfg)[2], "Mamba2 heads (ssm_heads)")
    if "rwkv6" in kinds:
        whole(cfg.d_model // cfg.rwkv_head_size, "RWKV6 heads (d_model / rwkv_head_size)")
    if any(not ("moe" in k and cfg.moe is not None)
           and (k not in _RECURRENT or cfg.recurrent_mlp) for k in kinds):  # block_init's MLP
        whole(cfg.d_ff, "MLP columns (d_ff)")
    if cfg.moe is not None and any("moe" in k for k in kinds):  # and so the shared s·ff
        whole(cfg.moe.expert_d_ff, "expert columns (expert_d_ff)")


def mamba2_dims(cfg: ModelConfig) -> tuple:
    """(inner, N, H) of a Mamba2 block: its packed ``in_proj`` is [d, 2·inner
    + 2N + H] = [z | x | B | C | dt]."""
    H = cfg.ssm_heads or (cfg.d_model // 64)
    return H * 64, cfg.ssm_state, H


def _heads(cfg: ModelConfig, name: str, m: int) -> bool:
    """Whether attention leaf ``name`` splits over ``m`` ranks (False: kv
    replicated), or ``ValueError`` where a split would cut a head."""
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    if name in ("wq", "wo"):
        if nh % m:
            raise ValueError(f"{cfg.arch_id}: {nh} q heads over {m} model shards would cut a "
                             f"head in two (the reference's GSPMD splits the {nh}·"
                             f"{cfg.resolved_head_dim} columns and reshards); pick m dividing "
                             f"{nh}")
        return True
    if nkv % m == 0:
        return True
    if m % nkv == 0:
        return False  # fewer kv heads than ranks: replicated, each rank uses one
    raise ValueError(f"{cfg.arch_id}: {nkv} kv heads over {m} model shards would cut a head "
                     "in two; pick m dividing them or divisible by them")


def tp_dim(path: str, leaf, cfg: ModelConfig, m: int) -> Optional[Split]:
    """How ``leaf`` (a leaf of the full tree, stacked or one unit's) is split
    over ``m`` model ranks (``train/flatten.py::Split``), or None for a
    replicated leaf. Mamba2's ``in_proj`` is cut by head: z, x and dt by
    rank, B and C replicated; every other split is one segment."""
    if m == 1:
        return None
    name = path.rsplit("/", 1)[-1]
    if "attn/" in path and name in _ATTN and not _heads(cfg, name, m):
        return None
    if "mamba/" in path and name == "in_proj":
        inner, N, H = mamba2_dims(cfg)
        return Split(len(leaf.shape) - 1,
                     ((inner, True), (inner, True), (N, False), (N, False), (H, True)))
    spec = sanitize_spec(_spec_for(path, leaf, cfg), tuple(leaf.shape), {"model": m})
    dims = [d for d, part in enumerate(spec)
            if part is not None and "model" in _names(part)]
    return Split.whole(dims[0], leaf.shape[dims[0]]) if dims else None


def shard_leaf(path: str, leaf, cfg: ModelConfig, j: int, m: int):
    """Model rank ``j``'s slice of ``leaf`` (its own memory), or the leaf
    itself where it is replicated."""
    sp = tp_dim(path, leaf, cfg, m)
    if sp is None:
        return leaf
    return sp.cut(leaf, j, m).clone(memory_format=torch.contiguous_format)


def shard_tree(params: Any, cfg: ModelConfig, j: int, m: int) -> Any:
    """Model rank ``j``'s shards of a full parameter tree (``Model.tree()``'s
    structure)."""
    check_tp(cfg, m)
    return tree_map_with_path(lambda path, x: shard_leaf(path, x, cfg, j, m), params)


def tree_dims(params: Any, cfg: ModelConfig, m: int) -> list:
    """``tp_dim`` (a ``Split`` or None) of each leaf of a full tree, in the
    flat order."""
    return [tp_dim(path, x, cfg, m) for path, x in leaves_with_paths(params)]
