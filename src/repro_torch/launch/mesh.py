"""Production meshes as ``DeviceMesh``es.

The counterpart of the JAX package's ``launch/mesh.py``. Single pod:
16×16 = 256 devices, axes (data, model): 'data' is the learner/chain axis
(one SAFE learner per data rank), 'model' the tensor-parallel axis.
Multi-pod: 2×16×16 = 512 devices, axes (pod, data, model): 'pod' is the
hierarchical-federation axis (paper §5.10).

The meshes are built over whatever process group is running. On a fake
one they let the dry run (``launch/dryrun.py``) place the production
layout's arguments: ``start_fake_world(512)`` is the counterpart of the
reference's ``--xla_force_host_platform_device_count=512``, one process
standing in for every rank. On a live group started by
``repro_torch.dist.init_world`` (one learner a rank), ``make_test_mesh(n,
1)`` is the learners' mesh: ``dist.rank_world(mesh, "data")`` gives the
collectives its 'data' dimension's group, and ``aggregate_sharded``, the
per-rank train step and FedAvg round take the mesh as the reference's
take theirs; ``make_pod_mesh(P, n)`` adds the pods as a second
dimension (hierarchical federation across ranks). Defined as functions,
so importing this module starts no process group.
"""
from __future__ import annotations

import math

import torch


def start_fake_world(ranks: int = 512) -> int:
    """Start a fake process group of ``ranks`` ranks in this process (rank
    0; collectives do nothing), unless one of that size is running; a fake
    group of another size is replaced. Returns the world size."""
    import torch.distributed as dist

    from repro_torch.compat import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == ranks:
            return ranks
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group of "
                               f"{dist.get_world_size()} ranks is running; the fake group of "
                               f"{ranks} ranks would replace it")
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=ranks, store=FakeStore())
    return ranks


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape: tuple, axes: tuple, device_type: str):
    """A mesh of ``shape`` over the world's first ranks."""
    from repro_torch.compat import DeviceMesh, init_device_mesh
    n = math.prod(shape)
    world = _world()
    if world < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {world} — start a fake process "
            f"group first: repro_torch.launch.mesh.start_fake_world({max(n, 512)}) "
            "(dryrun.py does this)")
    if world == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    # more ranks than needed (e.g. 512, single-pod mesh): use the first n
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def _device_type(device_type):
    """The mesh's device type: as given, else the live world's, else cuda."""
    if device_type is not None:
        return device_type
    from repro_torch.dist import world
    return world._CURRENT.device.type if world._CURRENT is not None else "cuda"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, _device_type(device_type))


def make_pod_mesh(pods: int, data: int, device_type=None):
    """The ('pod', 'data') mesh over the first ``pods * data`` ranks, pod
    major as the reference's batch spec ``P((pod, data))`` lays them out:
    rank p·data + l is learner l of pod p. On a live group,
    ``dist.rank_world(mesh, "data")`` is this pod's learners and
    ``rank_world(mesh, "pod")`` links the same learner across pods."""
    return _mesh((pods, data), ("pod", "data"), _device_type(device_type))


def make_test_mesh(data: int = 4, model: int = 2, pod: int = 1, device_type=None):
    """Small mesh over the first ranks, for tests (of the live world's
    device type when ``init_world`` started one)."""
    device_type = _device_type(device_type)
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return _mesh((data, model), ("data", "model"), device_type)
