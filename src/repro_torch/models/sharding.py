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
``tp_dim`` gives, along the dim where ``_spec_for`` puts 'model'. Every
split is by whole units, unevenly where m does not divide them
(``unit_share``: the first u mod m ranks hold ⌈u/m⌉ units, the rest
⌊u/m⌋, which may be none): the vocabulary (embed, lm_head) by word, so
internvl2's 151,655 words split 9,479 and 9,478 at m = 16 where the
reference's ``sanitize_spec`` replicates them, and each rank's logits and
loss stay on its words (``Model.loss``); q heads (wq's
columns, wo's rows, ``head_dim`` words a unit); the kv heads where m
divides them (then the q heads split evenly too, whole groups a rank), and
otherwise replicated on every rank, each q head q reading kv head
q·n_kv/n_heads; the MLP's, an expert's and the shared experts' ff columns;
Mamba2 and RWKV6 heads (Mamba2's packed ``in_proj`` [z | x | B | C | dt]
a segmented split: z, x and dt by head, B and C replicated). The
reference's ``sanitize_spec`` looks only at the column count, so where
the columns divide and the heads do not (14 q heads of 64 at m = 4: 896
columns) its GSPMD cuts a head and reshards around the cut, and where the
columns do not divide (an ff of 767 at m = 2) it replicates the leaf; the
port's whole-unit split computes the same function in both cases, and the
flat vector's words are the one-card order either way. ``check_tp``
therefore refuses no layout the reference runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.train.flatten import leaves_with_paths, tree_map_with_path

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


def unit_share(units: int, m: int, rank: int) -> Tuple[int, int]:
    """[lo, hi): the whole units (heads, ff columns) that model rank
    ``rank`` of ``m`` holds of ``units``: the first ``units mod m`` ranks
    hold ⌈units/m⌉, the rest ⌊units/m⌋, which may be none."""
    q, r = divmod(int(units), int(m))
    lo = rank * q + min(rank, r)
    return lo, lo + q + (1 if rank < r else 0)


@dataclasses.dataclass(frozen=True)
class Split:
    """How one leaf is cut over m model ranks: along ``dim``, consecutive
    segments of the full leaf, each ``(length, cut)``: a cut segment gives
    each rank its share of whole units (``unit_share``: a unit is
    ``widths[i]`` words along ``dim``, a head's ``head_dim`` columns or one
    ff column; every cut segment of a leaf has the same unit count), a
    replicated one (``cut`` False) is whole on every rank. A plain split
    is one cut segment; Mamba2's packed ``in_proj`` is [z | x | B | C |
    dt], z and x by heads of 64 columns, dt by head, B and C replicated.
    Where m does not divide the units the shards differ in length, rank 0's
    the longest."""

    dim: int
    segments: tuple
    widths: tuple

    @classmethod
    def whole(cls, dim: int, length: int, width: int = 1) -> "Split":
        """One cut segment of units ``width`` words long along ``dim``."""
        return cls(dim, ((length, True),), (width,))

    def spans(self, m: int, rank: int) -> tuple:
        """Each segment's (start, length) on ``rank``, within the segment."""
        out = []
        for i, (n, c) in enumerate(self.segments):
            if not c:
                out.append((0, n))
                continue
            w = self.widths[i]
            lo, hi = unit_share(n // w, m, rank)
            out.append((lo * w, (hi - lo) * w))
        return tuple(out)

    def local(self, m: int, rank: int) -> tuple:
        """Each segment's length on ``rank``."""
        return tuple(k for _, k in self.spans(m, rank))

    def size(self, m: int, rank: int) -> int:
        """The length of ``rank``'s shard along ``dim``."""
        return sum(self.local(m, rank))

    def cut(self, full: torch.Tensor, rank: int, m: int) -> torch.Tensor:
        """Rank ``rank``'s shard of the full leaf (a view for one segment)."""
        pieces, off = [], 0
        for (n, _), (start, k) in zip(self.segments, self.spans(m, rank)):
            pieces.append(full.narrow(self.dim, off + start, k))
            off += n
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=self.dim)

    def join(self, shards: list, rank: int = 0) -> torch.Tensor:
        """The full leaf from the m ranks' shards (rank order): a cut
        segment the shards' pieces joined, a replicated one ``rank``'s."""
        m = len(shards)
        locs = [self.local(m, r) for r in range(m)]
        offs = [0] * m
        parts = []
        for i, (_, c) in enumerate(self.segments):
            for r in (range(m) if c else (rank,)):
                parts.append(shards[r].narrow(self.dim, offs[r], locs[r][i]))
            offs = [o + loc[i] for o, loc in zip(offs, locs)]
        return torch.cat(parts, dim=self.dim)

    def pieces(self, shard: torch.Tensor, rank: int, m: int) -> tuple:
        """(the cut segments' pieces, the replicated segments') of rank
        ``rank``'s shard."""
        cut, rep, off = [], [], 0
        for (_, c), n in zip(self.segments, self.local(m, rank)):
            (cut if c else rep).append(shard.narrow(self.dim, off, n))
            off += n
        return cut, rep

    def pad(self, shard: torch.Tensor, m: int) -> torch.Tensor:
        """``shard`` zero-padded along ``dim`` to rank 0's length, so the
        group's shards gather as one shape (gloo and NCCL need one)."""
        k = self.size(m, 0) - shard.shape[self.dim]
        if not k:
            return shard
        shape = list(shard.shape)
        shape[self.dim] = k
        return torch.cat([shard, shard.new_zeros(shape)], dim=self.dim)

    def trim(self, padded: list) -> list:
        """The m ranks' shards from their ``pad``ded copies."""
        m = len(padded)
        return [s.narrow(self.dim, 0, self.size(m, r)) for r, s in enumerate(padded)]


def check_tp(cfg: ModelConfig, m: int) -> None:
    """Raise unless ``cfg`` splits over ``m`` model ranks: any m ≥ 1 does,
    every unit whole (a rank may hold none of a kind); the reference's
    mesh refuses no model axis of at least one device either."""
    if int(m) < 1:
        raise ValueError(f"{cfg.arch_id}: {m} model shards; a model axis holds at least one")


def mamba2_dims(cfg: ModelConfig) -> tuple:
    """(inner, N, H) of a Mamba2 block: its packed ``in_proj`` is [d, 2·inner
    + 2N + H] = [z | x | B | C | dt]."""
    H = cfg.ssm_heads or (cfg.d_model // 64)
    return H * 64, cfg.ssm_state, H


def _in(path: str, part: str) -> bool:
    """Whether ``path`` passes through a node named ``part`` (zamba2's
    ``shared_attn/mlp/wi`` is an MLP leaf, not an attention one)."""
    return f"/{part}/" in f"/{path}"


def _unit(path: str, cfg: ModelConfig) -> int:
    """The words along the split dim of one whole unit of a leaf's block:
    an attention head, an RWKV6 head, a Mamba2 head's 64 channels, or one
    ff column."""
    if _in(path, "attn"):
        return cfg.resolved_head_dim
    if _in(path, "rwkv"):
        return cfg.rwkv_head_size
    if _in(path, "mamba"):
        return 64
    return 1


def tp_dim(path: str, leaf, cfg: ModelConfig, m: int) -> Optional[Split]:
    """How ``leaf`` (a leaf of the full tree, stacked or one unit's) is split
    over ``m`` model ranks (a ``Split``), or None for a
    replicated leaf: kv heads where m divides them, every other 'model'
    dim (the vocabulary's included) by whole units (see the module
    docstring). Mamba2's ``in_proj`` is cut by head: z, x and dt by rank,
    B and C replicated; every other split is one segment."""
    if m == 1:
        return None
    name = path.rsplit("/", 1)[-1]
    if _in(path, "attn") and name in ("wk", "wv") and cfg.n_kv_heads % m:
        return None  # replicated: each rank's q heads read the kv heads they need
    if _in(path, "mamba") and name == "in_proj":
        inner, N, H = mamba2_dims(cfg)
        return Split(len(leaf.shape) - 1,
                     ((inner, True), (inner, True), (N, False), (N, False), (H, True)),
                     (64, 64, 1, 1, 1))
    spec = _spec_for(path, leaf, cfg)
    dims = [d for d, part in enumerate(spec)
            if part is not None and "model" in _names(part)]
    return Split.whole(dims[0], leaf.shape[dims[0]], _unit(path, cfg)) if dims else None


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
