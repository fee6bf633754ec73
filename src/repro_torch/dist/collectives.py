"""The JAX package's collectives over a process group.

Each function takes this rank's tensor and a ``World`` (``dist.world``)
and is the counterpart of one ``jax.lax`` collective inside ``shard_map``
over the learner axis:

- ``axis_index`` — the rank;
- ``ppermute(x, perm)`` — ``batch_isend_irecv`` over the (src, dst)
  pairs (``topo.ring_permutation()``); a rank that no pair sends to gets
  zeros, as in JAX;
- ``send`` / ``recv`` — one point-to-point message (the sequential
  chain's hops);
- ``all_gather(x, tiled)`` — stacked [n, ...] or, tiled, concatenated
  along dim 0; ``gather_to_host`` — the tiled gather on one rank only,
  in host memory (a checkpoint's slices and expert shards);
- ``psum`` — f32: an all-gather, then ``sum(dim=0)`` over the [n, ...]
  stack, the one-card port's sum over the learner dim on the same
  tensor, so the bits are that sum's (a backend's all-reduce adds in an
  order of its own); uint32: the sum mod 2^32;
- ``pmean`` — f32: an all-gather, then ``mean(dim=0)``;
- ``pmax`` — ``jax.lax.pmax``: an all-gather, then ``amax(dim=0)``
  (the log-sum-exp merge of a sequence-sharded KV cache,
  ``models/layers.py``);
- ``broadcast(x, src)`` — ``src``'s tensor on every rank;
- ``scatter(x, shape, dtype, src)`` — row i of ``src``'s [n, ...] tensor
  on rank i (the rows of a session the broker's rank received over the
  wire, ``serve/rank_engine.py``);
- ``all_to_all(x, split_axis, concat_axis, tiled)`` — chunk j of ``x``
  along ``split_axis`` to rank j, the chunks received concatenated along
  ``concat_axis`` in rank order (untiled: the split axis, of size n,
  removed and the received chunks stacked at ``concat_axis``). It is
  differentiable: its backward is the exchange with the two axes swapped,
  its transpose (the experts' dispatch and return, ``models/moe.py``).

Megatron's three operators over the model group (tensor parallelism,
``models/layers.py``), each differentiable:

- ``copy_to_model`` — identity forward, ``psum`` backward: where a
  replicated activation (or weight) enters a column-parallel product, the
  ranks' partial cotangents are summed;
- ``reduce_from_model`` — ``psum`` forward, identity backward: a
  row-parallel product's partial outputs summed. Its f32 psum is the
  all-gather and ``sum(dim=0)`` in rank order below, so the result does
  not depend on the transport; a bf16 psum sums the m bf16 partials the
  same way, which accumulates in f32 and rounds once to bf16. A tensor of
  more than ``MODEL_SLICE`` elements is summed a slice of its flat order
  at a time, so the gathered stack holds m slices, not m copies of the
  whole tensor (the MoE's [E/n, n·C, d] expert outputs at m = 16 would
  otherwise gather 16 copies); each element is the same m words added in
  rank order;
- ``all_reduce_model`` — ``psum`` forward and backward (both the three
  operators' psums a slice at a time): a sum that every
  rank then uses for different channels (Mamba2's gated norm over all its
  heads' channels), so each rank's cotangent of it is partial;
- ``gather_from_model`` — tiled all-gather along a dim forward, this
  rank's slice of the cotangent backward (not a reduce-scatter: the loss
  after it is computed alike on every model rank, so a summed backward
  would count the gradient m times).

Each operator is an ``autograd.Function`` only where autograd records:
under ``torch.no_grad()`` or ``torch.inference_mode()`` (serving) it is
the plain collective.

uint32 crosses the wire as its int32 view, the bits unchanged (neither
gloo nor NCCL takes ``torch.uint32``). With the ``host`` transport a CUDA
tensor is copied to a pinned host buffer before the message and back to
the card after it. ``reset_stats(timed=True)`` times the collectives
from then on: ``stats["seconds"]`` adds up the seconds this rank spent
in them, the device synchronised before each (queued kernels are not the
transport's) and after it (an NCCL call returns once its work is queued,
so only then has the message arrived). Untimed, the default, no
collective synchronises the device.

``stats["bytes"]`` counts, by op, the bytes each call would send from
this rank (on a fake group too, where nothing moves: the dry run's
records): ``psum`` (and ``pmean``), ``pmax`` and ``all_gather`` the
(n − 1) copies of its tensor a direct exchange sends, ``all_to_all`` the
(n − 1)/n of its buffer bound for other ranks, ``ppermute`` and ``send``
one tensor a destination, ``broadcast`` (n − 1) copies from the source
and nothing from the others, ``scatter`` the (n − 1) rows the source
sends. ``reset_stats`` zeroes them.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.crypto.fixedpoint import ring_add

#: whether the collectives are timed, their seconds and the bytes they
#: would send by op since ``reset_stats``
stats = {"timed": False, "seconds": 0.0, "bytes": Counter()}


def reset_stats(timed: bool = False) -> None:
    """Zero ``stats["seconds"]`` and ``stats["bytes"]``, and time the
    collectives from now on, or not."""
    stats.update(timed=timed, seconds=0.0, bytes=Counter())


def _count(op: str, x: torch.Tensor, copies: float) -> None:
    stats["bytes"][op] += int(x.numel() * x.element_size() * copies)


def _dist():
    import torch.distributed as dist
    return dist


def axis_index(world) -> int:
    """``jax.lax.axis_index`` over the learner axis: this rank."""
    return world.rank


class _Timed:
    """Adds one collective's seconds to ``stats`` when they are timed."""

    def __init__(self, world):
        self.world = world

    def _sync(self):
        if self.world.device.type == "cuda":
            torch.cuda.synchronize(self.world.device)

    def __enter__(self):
        if stats["timed"]:
            self._sync()
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if stats["timed"]:
            self._sync()
            stats["seconds"] += time.perf_counter() - self.t0


def _wire(x: torch.Tensor, world) -> torch.Tensor:
    """The tensor that crosses: uint32 as its int32 view, and with the host
    transport a CUDA tensor copied to a pinned host buffer."""
    t = x.contiguous()
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    if world.stage and t.is_cuda:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf
    return t


def _buffer(shape, dtype: torch.dtype, world) -> torch.Tensor:
    """A receive buffer of ``shape`` for a tensor of ``dtype``."""
    if dtype == torch.uint32:
        dtype = torch.int32
    if world.stage:
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=world.device)


def _back(t: torch.Tensor, dtype: torch.dtype, world) -> torch.Tensor:
    """A received wire tensor as ``dtype`` on the rank's device."""
    if t.device != world.device:
        t = t.to(world.device)
    return t.view(torch.uint32) if dtype == torch.uint32 else t


def send(x: torch.Tensor, dst: int, world) -> None:
    """Send ``x`` to rank ``dst`` (blocks until it is handed off)."""
    _count("send", x, 1)
    with _Timed(world):
        _dist().send(_wire(x, world), world.global_rank(dst), group=world.group)


def recv(shape, dtype: torch.dtype, src: int, world) -> torch.Tensor:
    """Receive a tensor of ``shape`` and ``dtype`` from rank ``src``."""
    buf = _buffer(shape, dtype, world)
    with _Timed(world):
        _dist().recv(buf, world.global_rank(src), group=world.group)
        out = _back(buf, dtype, world)
    return out


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], world) -> torch.Tensor:
    """``jax.lax.ppermute``: for each (src, dst) pair, src's ``x`` arrives
    at dst; a rank that is no pair's dst gets zeros."""
    dist = _dist()
    me = world.rank
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"rank {me} is the destination of {len(srcs)} pairs")
    _count("ppermute", x, len(dsts))
    with _Timed(world):
        wire = _wire(x, world)
        buf = _buffer(x.shape, x.dtype, world)
        ops = [dist.P2POp(dist.isend, wire, world.global_rank(d), group=world.group)
               for d in dsts]
        ops += [dist.P2POp(dist.irecv, buf, world.global_rank(s), group=world.group)
                for s in srcs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if not srcs:
            return torch.zeros_like(x)
        out = _back(buf, x.dtype, world)
    return out


def all_gather(x: torch.Tensor, world, tiled: bool = False, *,
               op: str = "all_gather") -> torch.Tensor:
    """``jax.lax.all_gather``: every rank's ``x`` stacked [n, ...] in rank
    order, or with ``tiled`` concatenated along dim 0 (``op``: the name its
    bytes count under)."""
    dist = _dist()
    n = world.size
    _count(op, x, n - 1)
    with _Timed(world):
        wire = _wire(x, world)
        out = _buffer((n,) + tuple(x.shape), x.dtype, world)
        if world.transport == "nccl":
            dist.all_gather_into_tensor(out, wire, group=world.group)
        else:
            dist.all_gather(list(out.unbind(0)), wire, group=world.group)
        out = _back(out, x.dtype, world)
    if tiled:
        return out.reshape((n * x.shape[0],) + tuple(x.shape[1:])) if x.dim() else out
    return out


def gather_to_host(x: torch.Tensor, dst: int, world, axis: int = 0) -> Optional[torch.Tensor]:
    """The tiled ``all_gather`` of ``x`` along ``axis`` on rank ``dst`` only,
    in host memory (None on the other ranks): ``dst`` receives one rank's
    tensor at a time, so its device holds one more ``x`` at most (a
    checkpoint's ZeRO-1 slices along dim 0, its expert shards along dim 1)."""
    if world.rank != dst:
        send(x, dst, world)
        return None
    k = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = world.size * k
    out = torch.empty(shape, dtype=x.dtype)
    for r in range(world.size):
        part = x if r == dst else recv(x.shape, x.dtype, r, world)
        out.narrow(axis, r * k, k).copy_(part)
    return out


def psum(x: torch.Tensor, world) -> torch.Tensor:
    """``jax.lax.psum`` over the learners: f32 as the one-card sum over dim
    0 of the stacked [n, ...] tensor; uint32 mod 2^32."""
    stack = all_gather(x, world, op="psum")
    if x.dtype == torch.uint32:
        total = stack[0]
        for row in stack[1:]:
            total = ring_add(total, row)
        return total
    return stack.sum(dim=0)


def pmean(x: torch.Tensor, world) -> torch.Tensor:
    """``jax.lax.pmean`` over the learners: the mean over dim 0 of the
    stacked [n, ...] tensor."""
    return all_gather(x, world, op="psum").mean(dim=0)


def pmax(x: torch.Tensor, world) -> torch.Tensor:
    """``jax.lax.pmax``: the elementwise max over the ranks (an all-gather,
    then ``amax`` over dim 0: the same bits on every rank, whatever the
    transport)."""
    return all_gather(x, world, op="pmax").amax(dim=0)


def broadcast(x: torch.Tensor, src: int, world) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (the others pass a tensor of the
    same shape and dtype, whose values are not read)."""
    _count("broadcast", x, world.size - 1 if world.rank == src else 0)
    with _Timed(world):
        if world.rank == src:
            buf = _wire(x, world)
        else:
            buf = _buffer(x.shape, x.dtype, world)
        _dist().broadcast(buf, world.global_rank(src), group=world.group)
        out = x if world.rank == src else _back(buf, x.dtype, world)
    return out


def scatter(x: Optional[torch.Tensor], shape, dtype: torch.dtype, src: int,
            world) -> torch.Tensor:
    """Row i of rank ``src``'s ``x`` on rank i, on its device. On ``src``,
    ``x`` is [n, *shape] of ``dtype`` on the host or the device; the other
    ranks pass None."""
    shape = tuple(shape)
    buf = _buffer(shape, dtype, world)
    parts = None
    if world.rank == src:
        if tuple(x.shape) != (world.size,) + shape or x.dtype != dtype:
            raise ValueError(f"scatter: {tuple(x.shape)} {x.dtype} is not one {shape} "
                             f"{dtype} row for each of {world.size} ranks")
        if world.transport == "nccl":
            x = x.to(world.device)
        _count("scatter", x[0], world.size - 1)
        parts = [_wire(row, world) for row in x.unbind(0)]
    with _Timed(world):
        _dist().scatter(buf, parts, src=world.global_rank(src), group=world.group)
        out = _back(buf, dtype, world)
    return out


def _exchange(x: torch.Tensor, world, split_axis: int, concat_axis: int,
              tiled: bool) -> torch.Tensor:
    """The all-to-all's message: one ``all_to_all_single`` over the
    chunks, moved to dim 0."""
    n = world.size
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        lead = x.movedim(split_axis, 0)
        lead = lead.reshape((n, lead.shape[0] // n) + tuple(lead.shape[1:]))
    else:
        if x.shape[split_axis] != n:
            raise ValueError(f"all_to_all: untiled, dim {split_axis} of {tuple(x.shape)} must "
                             f"be the {n} ranks")
        lead = x.movedim(split_axis, 0)
    _count("all_to_all", x, (n - 1) / n)
    with _Timed(world):
        wire = _wire(lead, world)
        out = _buffer(lead.shape, x.dtype, world)
        _dist().all_to_all_single(out, wire, group=world.group)
        out = _back(out, x.dtype, world)
    if not tiled:  # [n (source), ...x without the split axis] -> the source axis at concat_axis
        return out.movedim(0, concat_axis)
    if split_axis == concat_axis == 0:
        return out.reshape((-1,) + tuple(out.shape[2:]))
    return torch.cat([c.movedim(0, split_axis) for c in out.unbind(0)], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """The exchange, differentiable: the cotangent goes back by the
    exchange with the axes swapped (for split = concat = 0, tiled, the same
    exchange: a tiled all-to-all over dim 0 is its own transpose)."""

    @staticmethod
    def forward(ctx, x, world, split_axis, concat_axis, tiled):
        ctx.args = (world, split_axis, concat_axis, tiled)
        return _exchange(x, world, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        world, split_axis, concat_axis, tiled = ctx.args
        return (_exchange(g.contiguous(), world, concat_axis, split_axis, tiled),
                None, None, None, None)


def all_to_all(x: torch.Tensor, world, split_axis: int = 0, concat_axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all``: ``x`` cut into n chunks along
    ``split_axis``, chunk j sent to rank j, and the chunks this rank
    receives joined along ``concat_axis`` in the senders' rank order
    (``tiled``; untiled the split axis must be n long, is removed, and the
    received chunks are stacked at ``concat_axis``). Differentiable (see
    ``_AllToAll``). One ``all_to_all_single`` over the learner group;
    uint32 crosses as int32, and with the host transport through pinned
    host buffers."""
    split_axis, concat_axis = split_axis % x.dim(), concat_axis % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, world, split_axis, concat_axis, tiled)
    return _exchange(x, world, split_axis, concat_axis, tiled)


#: the most elements one all-gather of the model group's psum carries
MODEL_SLICE = 1 << 24


def _psum_sliced(x: torch.Tensor, world) -> torch.Tensor:
    """``psum`` of ``x`` over the model group, ``MODEL_SLICE`` elements of
    its flat order at a time."""
    if x.numel() <= MODEL_SLICE:
        return psum(x, world)
    flat = x.contiguous().view(-1)
    out = torch.empty_like(flat)
    for lo in range(0, flat.numel(), MODEL_SLICE):
        out[lo:lo + MODEL_SLICE] = psum(flat[lo:lo + MODEL_SLICE], world)
    return out.view(x.shape)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        ctx.world = world
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum_sliced(g, ctx.world), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world):
        return _psum_sliced(x, world)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, world, dim):
        ctx.args = (world, dim, x.shape[dim])
        return torch.cat(all_gather(x, world).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        world, dim, k = ctx.args
        return g.narrow(dim, world.rank * k, k).contiguous(), None, None


def copy_to_model(x: torch.Tensor, world) -> torch.Tensor:
    """Megatron's f: ``x`` unchanged; its gradient ``psum``'d over ``world``."""
    if world is None or world.size == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, world)


def reduce_from_model(x: torch.Tensor, world) -> torch.Tensor:
    """Megatron's g: the ``psum`` of ``x`` over ``world``; the gradient
    passes unchanged."""
    if world is None or world.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, world)
    return _psum_sliced(x, world)


def all_reduce_model(x: torch.Tensor, world) -> torch.Tensor:
    """The ``psum`` of ``x`` over ``world`` whose gradient is ``psum``'d too:
    ``reduce_from_model`` then ``copy_to_model``. Every rank gets the same
    bits (the f32 all-gather and sum in rank order)."""
    return copy_to_model(reduce_from_model(x, world), world)


def gather_from_model(x: torch.Tensor, world, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    gradient is this rank's slice of the cotangent."""
    if world is None or world.size == 1:
        return x
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromModel.apply(x, world, dim)
    return torch.cat(all_gather(x, world).unbind(0), dim=dim)


__all__ = ["axis_index", "ppermute", "send", "recv", "all_gather", "gather_to_host", "psum",
           "pmean", "pmax", "broadcast", "scatter", "all_to_all", "copy_to_model",
           "reduce_from_model", "all_reduce_model", "gather_from_model", "stats", "reset_stats"]
