"""Process groups: one learner per rank.

The counterpart of the JAX package's mesh device list. There each learner
is one device of the mesh's 'data' axis inside ``shard_map``; here each
learner is one process of a ``torch.distributed`` group, its rank the
learner's index and the world size the learner count n.

The transport follows the device, and is never chosen silently:

- CPU ranks talk over ``gloo``;
- CUDA ranks with a card each talk over ``nccl`` (``transport="nccl"``,
  the default for CUDA): rank r drives card ``local_rank``. Fewer cards
  on the host than local ranks raises (NCCL refuses two ranks on one
  card);
- CUDA ranks that share a card take ``transport="host"`` when the caller
  asks for it: ``gloo``, each CUDA tensor staged through a pinned host
  buffer (as gloo's own CUDA all-reduce does), while the vectors and the
  kernels stay on the card.

``init_world`` starts this process's group (from explicit rank, world
size and store, or from the environment ``torch.distributed.run`` sets);
``spawn`` starts n ranks of a function on one host and returns what each
rank returned with its kernel launch counts; a ``RankPool`` keeps such
ranks for the next function of the same rank count.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Any, Callable, Optional, Sequence

import torch

TRANSPORTS = ("nccl", "gloo", "host")
TIMEOUT_S = 600  # a collective's longest wait for the other ranks

#: this process's world, once ``init_world`` has run
_CURRENT: Optional["World"] = None


@dataclasses.dataclass(frozen=True)
class World:
    """One process's view of the learner group.

    ``group`` is the process group the collectives use (None: the default
    group). ``transport`` is ``nccl``, ``gloo`` (CPU ranks) or ``host``
    (CUDA ranks through host buffers over gloo)."""

    rank: int
    size: int
    device: torch.device
    transport: str
    group: Any = None

    @property
    def backend(self) -> str:
        return "nccl" if self.transport == "nccl" else "gloo"

    @property
    def stage(self) -> bool:
        """True when CUDA tensors cross through pinned host buffers."""
        return self.transport == "host"

    def global_rank(self, r: int) -> int:
        """The default group's rank of this group's rank ``r``."""
        if self.group is None:
            return r
        import torch.distributed as dist
        return dist.get_global_rank(self.group, r)

    def describe(self) -> str:
        how = {"nccl": "nccl, one card a rank", "gloo": "gloo on the CPU",
               "host": "gloo through pinned host buffers, ranks sharing a card"}
        text = f"{self.size} ranks on {self.device.type}, {how[self.transport]}"
        if self.device.type == "cuda":
            cards = torch.cuda.device_count()
            text += f" ({cards} card{'s' if cards != 1 else ''} visible)"
        return text


def rank_world(mesh, axis: str = "data") -> Optional[World]:
    """The ``World`` of ``mesh``'s ``axis`` dimension when ``mesh`` puts one
    learner on each rank of a live group: ``mesh`` itself when it is a
    ``World``; for a ``DeviceMesh`` over the group ``init_world`` started
    (``launch/mesh.py``), that dimension's group with this process's
    device and transport. On a ('pod', 'data') mesh (``make_pod_mesh``),
    ``axis="data"`` gives this pod's learners and ``axis="pod"`` the ranks
    that hold the same learner in every pod, in pod order (the mesh made
    its groups on every rank in the same order). None for no mesh, or a
    mesh on a fake group (the dry run's placements), where the learners
    are dim 0 of one device."""
    if mesh is None or isinstance(mesh, World):
        return mesh
    if isinstance(mesh, Grid):
        return mesh.axis(axis)
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_backend() == "fake" or _CURRENT is None:
        return None
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} dimension (dimensions {names})")
    return World(rank=mesh.get_local_rank(axis), size=mesh.size(names.index(axis)),
                 device=_CURRENT.device, transport=_CURRENT.transport,
                 group=mesh.get_group(axis))


def pod_world_of(mesh, axis: str = "pod") -> Optional[World]:
    """The pod ``World`` of a ('pod', 'data') mesh over a live group
    (``rank_world(mesh, axis)``); None for a ``World`` (a World is one
    learner axis, with no pods) or no mesh; a ``Grid``'s pod World."""
    if mesh is None or isinstance(mesh, World):
        return None
    if isinstance(mesh, Grid):
        return mesh.pod
    return rank_world(mesh, axis)


def model_world_of(mesh, axis: str = "model") -> Optional[World]:
    """The model group of a ('data', 'model') mesh over a live group
    (``rank_world(mesh, axis)``: the ranks holding one learner's model
    shards, consecutive in the reference's order, rank l·m + j being
    learner l's shard j); None for a ``World``, no mesh, or a mesh without
    a model dimension or with one of size 1; a ``Grid``'s model World."""
    if mesh is None or isinstance(mesh, World):
        return None
    if isinstance(mesh, Grid):
        return mesh.model
    if axis not in tuple(mesh.mesh_dim_names or ()):
        return None
    world = rank_world(mesh, axis)
    return world if world is not None and world.size > 1 else None


@dataclasses.dataclass(frozen=True)
class Grid:
    """One rank's Worlds on the reference's ('pod', 'data', 'model') grid
    (``grid``): ``data`` the learners' ring (the n learners of its pod
    holding the same model shard), ``model`` its model group (None for
    m = 1), ``pod`` its pod group (the P ranks of the same learner and
    shard, one a pod; None for one pod). It stands where a mesh does:
    ``rank_world(grid, axis)``, ``pod_world_of`` and ``model_world_of``
    read it, so ``make_train_step(model, agg, grid, pod_axis="pod")`` and
    ``make_federated_round`` take it as they take a ('pod', 'data',
    'model') ``DeviceMesh``."""

    data: World
    model: Optional[World] = None
    pod: Optional[World] = None

    def axis(self, name: str) -> Optional[World]:
        if name not in ("data", "model", "pod"):
            raise ValueError(f"the grid has no {name!r} dimension (pod, data, model)")
        return getattr(self, name)


def grid(world: World, model_shards: int = 1, pods: int = 1) -> Grid:
    """This rank's ``Grid`` of the P × n × m ranks of ``world`` in the
    reference's device order, pod-major: rank r = (p·n + l)·m + j is pod
    p's learner l, model shard j. Its ring is the n ranks (p, ·, j), its
    model group the m ranks (p, l, ·) and its pod group the P ranks
    (·, l, j). Every rank must call it (each ``new_group`` is collective,
    in one order everywhere: the pod groups, the rings, the model
    groups)."""
    m, P = int(model_shards), int(pods)
    if m < 1 or P < 1 or world.size % (m * P):
        raise ValueError(f"{world.size} ranks do not split into {P} pods of model groups "
                         f"of {m}")
    n = world.size // (m * P)
    if m == 1 and P == 1:
        return Grid(data=world)
    import torch.distributed as dist
    base = [world.global_rank(r) for r in range(world.size)]

    def at(p, l, j):
        return base[(p * n + l) * m + j]

    pod_groups = ({(l, j): dist.new_group([at(p, l, j) for p in range(P)])
                   for l in range(n) for j in range(m)} if P > 1 else {})
    rings = {(p, j): dist.new_group([at(p, l, j) for l in range(n)])
             for p in range(P) for j in range(m)}
    models = ({(p, l): dist.new_group([at(p, l, j) for j in range(m)])
               for p in range(P) for l in range(n)} if m > 1 else {})
    p, rest = divmod(world.rank, n * m)
    l, j = divmod(rest, m)

    def make(rank, size, group):
        return World(rank=rank, size=size, device=world.device, transport=world.transport,
                     group=group)
    return Grid(data=make(l, n, rings[p, j]),
                model=make(j, m, models[p, l]) if m > 1 else None,
                pod=make(p, P, pod_groups[l, j]) if P > 1 else None)


def grid_worlds(world: World, model_shards: int) -> tuple:
    """(learner ring, model group) of the ('data', 'model') grid over the
    ``world.size`` ranks of ``world``, without a ``DeviceMesh``: rank
    r = l·m + j is learner l's model shard j (the reference's device
    order), its ring the n ranks with the same j and its model group the m
    consecutive ranks l·m .. l·m + m − 1 (``grid`` with one pod). Every
    rank must call it. With ``model_shards`` 1 it returns (``world``,
    None)."""
    g = grid(world, model_shards)
    return g.data, g.model


def _pick(device: str, transport: Optional[str], local_rank: int,
          local_size: int) -> tuple:
    """(transport, torch.device) for a rank, or raise."""
    dev = torch.device(device)
    if transport is not None and transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
    if dev.type == "cpu":
        if transport not in (None, "gloo"):
            raise ValueError(f"CPU ranks talk over gloo, not {transport!r}")
        return "gloo", dev
    if dev.type != "cuda":
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    if transport == "gloo":
        raise ValueError("CUDA ranks take transport='nccl' (a card a rank) or "
                         "transport='host' (ranks sharing a card, staged through host "
                         "buffers over gloo)")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError(f"device {device!r}: torch sees no CUDA device")
    if transport == "host":
        index = dev.index if dev.index is not None else local_rank % cards
        return "host", torch.device("cuda", index)
    if cards < local_size:
        raise RuntimeError(
            f"nccl needs one card a rank: {local_size} ranks on this host, {cards} "
            f"card{'s' if cards != 1 else ''} visible (NCCL refuses two ranks on one "
            "card). Ranks that share a card take transport='host'.")
    return "nccl", torch.device("cuda", local_rank)


def init_world(rank: Optional[int] = None, world_size: Optional[int] = None,
               store=None, *, device: str = "cuda", transport: Optional[str] = None) -> World:
    """Start this process's process group and return its ``World``.

    With ``rank`` None the rank, world size and local rank come from the
    environment ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, and ``MASTER_ADDR``/``PORT``
    for the store). Otherwise ``store`` (a ``torch.distributed`` store
    every rank shares) is required and every rank is on this host.
    ``device`` is where the rank keeps its tensors (cuda by default, as
    every entry point of the port); ``transport`` as the module says. A
    collective waits at most ``TIMEOUT_S`` for the other ranks."""
    import torch.distributed as dist
    global _CURRENT
    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this process")
    env = rank is None
    if env:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    else:
        if world_size is None or store is None:
            raise ValueError("init_world: give rank, world_size and store together, "
                             "or none of them (torch.distributed.run's environment)")
        local_rank, local_size = rank, world_size
    transport, dev = _pick(device, transport, local_rank, local_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = World(rank=rank, size=world_size, device=dev, transport=transport)
    where = dict(init_method="env://") if env else dict(store=store)
    dist.init_process_group(world.backend, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S), **where)
    _CURRENT = world
    return world


def close_world() -> None:
    """Stop this process's process group."""
    import torch.distributed as dist
    global _CURRENT
    if dist.is_initialized():
        dist.destroy_process_group()
    _CURRENT = None


def _to_host(obj: Any) -> Any:
    """``obj`` with every tensor moved to the CPU (for the parent)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_loop(rank: int, size: int, device: str, transport: Optional[str],
               threads: Optional[int], out_dir: str, jobs, done) -> None:
    """One rank of a ``RankPool``: start the group once, then run each job
    ``(n, fn, args)`` from ``jobs`` as ``fn(world, *args)``, write its
    result and this process's kernel launch counts for the parent and
    report to ``done``, until the job is None. A raise is reported with
    its traceback and ends the rank."""
    import gc
    import traceback

    from repro_torch.kernels import build
    n = "start"
    try:
        if threads:
            torch.set_num_threads(threads)
        world = init_world(rank, size, _file_store(out_dir, size), device=device,
                           transport=transport)
        cuda = world.device.type == "cuda"
        done.put((n, rank, None))
        while (job := jobs.get()) is not None:
            n, fn, args = job
            result = fn(world, *args)
            if cuda:
                torch.cuda.synchronize(world.device)
            torch.save({"result": _to_host(result), "launches": dict(build.launches)},
                       os.path.join(out_dir, f"job{n}_rank{rank}.pt"))
            del result
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            done.put((n, rank, None))
    except BaseException:
        done.put((n, rank, traceback.format_exc()))
    finally:
        close_world()


def _file_store(out_dir: str, size: int):
    import torch.distributed as dist
    return dist.FileStore(os.path.join(out_dir, "store"), size)


class RankPool:
    """``world_size`` ranks of this host, each a spawned process that
    starts its group once (over a ``FileStore`` in a temporary directory)
    and then runs every job ``run`` gives it, so that consecutive calls of
    one rank count pay the processes' start-up (``start_s``) once.

    ``run(fn, args)`` runs ``fn(world, *args)`` on every rank and returns
    one dict a rank, in rank order: ``result`` (what ``fn`` returned, its
    tensors moved to the CPU) and ``launches`` (that process's
    ``kernels.build.launches`` so far: the counts are per process, so only
    the rank can read them). A rank that raises, or dies, fails the call
    and stops the pool. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function). A job starts on the process the last one left.
    ``device``, ``transport`` and ``threads`` (each rank's intra-op
    threads) as ``spawn``'s. ``close`` (or leaving a ``with`` block) stops
    the ranks."""

    def __init__(self, world_size: int, device: str = "cuda", *,
                 transport: Optional[str] = None, threads: Optional[int] = None):
        import time

        import torch.multiprocessing as mp
        self.size, self.jobs_run, self.closed = world_size, 0, False
        self._dir = tempfile.TemporaryDirectory(prefix="repro_torch_world_")
        ctx = mp.get_context("spawn")
        self._jobs = [ctx.Queue() for _ in range(world_size)]
        self._done = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_loop,
                                   args=(r, world_size, device, transport, threads,
                                         self._dir.name, self._jobs[r], self._done))
                       for r in range(world_size)]
        t0 = time.perf_counter()
        for proc in self._procs:
            proc.start()
        self._wait("start")
        self.start_s = time.perf_counter() - t0

    def _wait(self, what: str) -> None:
        """Until every rank has reported; a rank's raise or death stops
        the pool and raises."""
        import queue
        left = set(range(self.size))
        while left:
            try:
                _, rank, error = self._done.get(timeout=5)
            except queue.Empty:
                dead = sorted(r for r in left if not self._procs[r].is_alive())
                if dead:
                    self.close(wait_s=0)
                    raise RuntimeError(f"ranks {dead} of {self.size} died in {what}")
                continue
            if error is not None:
                self.close(wait_s=0)
                raise RuntimeError(f"rank {rank} of {self.size} raised in {what}:\n{error}")
            left.discard(rank)

    def run(self, fn: Callable, args: Sequence = ()) -> list:
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        n = self.jobs_run
        self.jobs_run += 1
        for q in self._jobs:
            q.put((n, fn, tuple(args)))
        self._wait(getattr(fn, "__name__", repr(fn)))
        out = []
        for r in range(self.size):
            path = os.path.join(self._dir.name, f"job{n}_rank{r}.pt")
            out.append(torch.load(path, weights_only=False))
            os.remove(path)
        return out

    def close(self, wait_s: float = 30.0) -> None:
        """Stop the ranks: each ends its loop, or, ``wait_s`` on (a rank
        left waiting in a collective by a failed job), is terminated."""
        import time
        if self.closed:
            return
        self.closed = True
        for q in self._jobs:
            q.put(None)
        deadline = time.perf_counter() + wait_s
        for proc in self._procs:
            proc.join(timeout=max(0.0, deadline - time.perf_counter()))
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
                proc.join()
        self._dir.cleanup()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn(fn: Callable, world_size: int, device: str = "cuda", *,
          transport: Optional[str] = None, args: Sequence = (),
          threads: Optional[int] = None) -> list:
    """Run ``fn(world, *args)`` once on ``world_size`` ranks of this host:
    ``RankPool.run`` on a pool of its own, stopped after. ``threads`` sets
    each rank's intra-op threads."""
    with RankPool(world_size, device, transport=transport, threads=threads) as pool:
        return pool.run(fn, args)


__all__ = ["World", "Grid", "TRANSPORTS", "init_world", "close_world", "rank_world",
           "pod_world_of", "model_world_of", "grid", "grid_worlds", "RankPool", "spawn"]
