"""Deterministic tree <-> flat-vector codec in the reference's layout.

The SAFE chain aggregates one flat f32 vector, and its pads are
positional, so the port must lay a parameter tree out exactly as the JAX
package's ``train/flatten.py`` does: in ``jax.tree.leaves`` order, which
visits a dict's keys sorted and a list in index order, each leaf raveled
row-major. For the dense decoder that order is::

    blocks/0/attn/wk, blocks/0/attn/wo, blocks/0/attn/wq, blocks/0/attn/wv,
    blocks/0/ln1/scale, blocks/0/ln2/scale,
    blocks/0/mlp/wg, blocks/0/mlp/wi, blocks/0/mlp/wo,
    embed, final_norm/scale

(the stacked units inside each leaf). ``nn.Module.named_parameters()``
gives another order; ``leaf_paths`` gives this one.

A model split over m model ranks (tensor parallelism, ``Model(cfg,
tp_world=...)``) holds shards of the leaves, each cut by the
``models/sharding.py::Split`` its leaf has; ``shard_layout`` says which
words of the full tree's flat vector each shard
occupies, ``write_chunk`` assembles words [start, start + len) of the
full tree's flat vector from the model group's shards, and
``LeafShard.of`` cuts a shard out of a full flat vector.

``partition_tree``, ``combine_trees`` and ``is_expert_path`` split a tree
by leaf path, as the reference's do: the expert-parallel train step keeps
the per-expert matrices out of the SAFE partition. A leaf that is not
selected becomes ``None``, an empty subtree that every function here
skips.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Callable, List, Optional, Tuple

import torch

if TYPE_CHECKING:
    from repro_torch.models.sharding import Split


def _walk(tree: Any, prefix: str, out: List[Tuple[str, torch.Tensor]]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{prefix}{k}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _walk(v, f"{prefix}{i}/", out)
    elif tree is not None:
        out.append((prefix[:-1], tree))


def leaves_with_paths(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) pairs in the reference's leaf order."""
    out: List[Tuple[str, torch.Tensor]] = []
    _walk(tree, "", out)
    return out


def leaves(tree: Any) -> List[torch.Tensor]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def leaf_paths(tree: Any) -> List[str]:
    return [path for path, _ in leaves_with_paths(tree)]


def tree_size(tree: Any) -> int:
    return int(sum(math.prod(leaf.shape) for leaf in leaves(tree)))


def tree_map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    """``tree_map`` of one tree whose ``fn(path, leaf)`` also gets the
    leaf's path (the reference's ``_path_str`` form, e.g.
    ``blocks/0/moe/wi``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _sequence(tree, [tree_map_with_path(fn, v, f"{prefix}{i}/")
                                for i, v in enumerate(tree)])
    if tree is None:
        return None
    return fn(prefix[:-1], tree)


def partition_tree(tree: Any, pred: Callable[[str], bool]) -> Tuple[Any, Any]:
    """Split into (selected, rest) trees by leaf path; the leaves of the
    other part become None."""
    sel = tree_map_with_path(lambda p, x: x if pred(p) else None, tree)
    rest = tree_map_with_path(lambda p, x: None if pred(p) else x, tree)
    return sel, rest


def combine_trees(a: Any, b: Any) -> Any:
    """Merge two complementary partitions back into one tree."""
    if a is None:
        return b
    if isinstance(a, dict):
        return {k: combine_trees(v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return _sequence(a, [combine_trees(x, y) for x, y in zip(a, b)])
    return a


def is_expert_path(path: str) -> bool:
    """Expert-parallel leaves: the per-expert matrices inside moe blocks
    (the router and the shared experts stay in the SAFE partition)."""
    return "moe/" in path and path.rsplit("/", 1)[-1] in ("wi", "wg", "wo")


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf (of ``tree`` and, leaf for leaf, of the
    trees of the same structure in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(t[k] for t in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _sequence(tree, [tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if tree is None:  # an empty subtree, as in jax.tree
        return None
    return fn(tree, *rest)


def _sequence(like, items: list):
    """A list, tuple or NamedTuple of ``like``'s type holding ``items``."""
    if hasattr(like, "_fields"):
        return type(like)(*items)
    return type(like)(items)


def tree_to_flat(tree: Any) -> torch.Tensor:
    """Concatenate all leaves (tree order) as f32[P]."""
    ls = leaves(tree)
    if not ls:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat([leaf.detach().reshape(-1).float() for leaf in ls])


def flat_to_tree(flat: torch.Tensor, template: Any) -> Any:
    """Inverse of tree_to_flat; casts each leaf to the template's dtype."""
    pieces, off = [], 0
    for leaf in leaves(template):
        n = leaf.numel()
        pieces.append(flat[off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return tree_unflatten(template, pieces)


def tree_unflatten(template: Any, new_leaves) -> Any:
    """The template's structure with ``new_leaves`` (in the flat order)."""
    it = iter(new_leaves)
    return _rebuild(template, lambda _: next(it))


def _rebuild(tree: Any, take) -> Any:
    """``tree_map`` that visits the leaves in the flat order."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], take) for k in sorted(tree)}
        return {k: out[k] for k in tree}  # the template's key order
    if isinstance(tree, (list, tuple)):
        return _sequence(tree, [_rebuild(v, take) for v in tree])
    if tree is None:
        return None
    return take(tree)


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """Where model rank ``rank`` of ``ranks``'s shard of one leaf sits in the
    full tree's flat vector: the full leaf has ``shape`` and starts at word
    ``offset``; the shard is ``split``'s cut of it (a
    ``models/sharding.py::Split``; None: the whole leaf, replicated)."""

    offset: int
    shape: tuple
    split: Optional[Split]
    rank: int
    ranks: int

    @property
    def dim(self) -> Optional[int]:
        """The split dim, None for a replicated leaf."""
        return None if self.split is None else self.split.dim

    @property
    def numel(self) -> int:
        """Words of the full leaf."""
        return math.prod(self.shape)

    def shard_numel(self, rank: Optional[int] = None) -> int:
        """Words of model rank ``rank``'s shard (this one's by default)."""
        if self.split is None:
            return self.numel
        rank = self.rank if rank is None else rank
        return self.numel // self.shape[self.split.dim] * self.split.size(self.ranks, rank)

    def of(self, flat: torch.Tensor) -> torch.Tensor:
        """The shard's words of the full flat vector ``flat``, shaped as the
        shard (a strided view where the split is one segment)."""
        return self.cut(flat[self.offset:self.offset + self.numel].view(self.shape))

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """The shard of the full leaf ``full``."""
        if self.split is None:
            return full
        return self.split.cut(full, self.rank, self.ranks)

    def join(self, shards: list) -> torch.Tensor:
        """The full leaf from the model group's shards (rank order), the
        replicated segments this rank's."""
        if self.split is None:
            return shards[self.rank]
        return self.split.join(shards, self.rank)

    def words(self) -> torch.Tensor:
        """int64 indices of the shard's words in the full flat vector, in the
        shard's own row-major order."""
        return self.of(torch.arange(self.offset + self.numel)).reshape(-1)


def shard_layout(shards: Any, splits: list, rank: int, ranks: int) -> List[LeafShard]:
    """The ``LeafShard`` of each leaf of model rank ``rank``'s shard tree, in
    the flat order; ``splits`` gives each leaf's ``Split`` (None where the
    leaf is replicated), as ``Model.tp_dims`` does."""
    out, off = [], 0
    for leaf, sp in zip(leaves(shards), splits):
        shape = tuple(leaf.shape)
        if sp is not None:
            shape = shape[:sp.dim] + (sum(n for n, _ in sp.segments),) + shape[sp.dim + 1:]
        out.append(LeafShard(off, shape, sp, rank, ranks))
        off += math.prod(shape)
    return out


def write_chunk(layout: List[LeafShard], shard_leaves: list, model_world, out: torch.Tensor,
                start: int) -> None:
    """Words [start, start + len(out)) of the full tree's flat vector into
    ``out`` (f32), assembled from the shards ``shard_leaves`` of every rank
    of ``model_world`` (the model group, which must all call it with their
    own shards): a split leaf is all-gathered over the group, one leaf at a
    time (each shard padded to rank 0's length and trimmed after), and
    joined, its replicated segments (and a replicated leaf) this rank's,
    whose gradient is the whole one. Words past the tree are left as they
    are."""
    from repro_torch.dist import collectives
    end = start + out.numel()
    for sh, x in zip(layout, shard_leaves):
        lo, hi = max(start, sh.offset), min(end, sh.offset + sh.numel)
        if sh.split is not None:  # every rank gathers, whether or not it keeps a word
            sp = sh.split
            x = sp.pad(x.detach(), sh.ranks).contiguous()
            x = sh.join(sp.trim(list(collectives.all_gather(x, model_world).unbind(0))))
        if lo < hi:
            out[lo - start:hi - start].copy_(x.detach().reshape(-1)[lo - sh.offset:
                                                                    hi - sh.offset])
