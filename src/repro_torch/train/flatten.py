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
"""
from __future__ import annotations

import math
from typing import Any, List, Tuple

import torch


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


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf (of ``tree`` and, leaf for leaf, of the
    trees of the same structure in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(t[k] for t in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


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
        return {k: _rebuild(tree[k], take) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, take) for v in tree)
    return take(tree)
