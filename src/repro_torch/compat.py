"""One place to import what moved between torch releases.

The JAX package's ``compat`` gives old jax releases the modern API. This
module does the counterpart for the port's sharding and dry-run modules
(``models/sharding.py``, ``launch/mesh.py``, ``launch/input_specs.py``,
``launch/dryrun.py``) and its custom ops (``kernels/ops.py``): each name
below is imported from where the running torch keeps it.

- ``DeviceMesh``, ``init_device_mesh`` (loaded on first use, as the
  DTensor names are): ``torch.distributed.device_mesh``.
- DTensor's ``Shard``, ``Replicate``: ``torch.distributed.tensor``.
- ``compute_local_shape_and_global_offset``: DTensor's rule for a rank's
  shard, in the private ``torch.distributed.tensor._utils``.
- ``Library``, ``register_fake``: ``torch.library`` (``register_fake``
  from 2.4 on).
- ``FlopCounterMode``: ``torch.utils.flop_counter``.
- ``FakeStore``: the fake process group's store
  (``torch.testing._internal.distributed.fake_pg``), imported when called.

Strictly additive: it patches nothing in ``torch``, and ``import
repro_torch`` does not import it.
"""
from __future__ import annotations

import importlib

from torch.library import Library, register_fake
from torch.utils.flop_counter import FlopCounterMode

# torch.distributed's modules take about a second to import: they load on
# first use, so the custom ops (kernels/ops.py) import this module cheaply
_LAZY = {
    "DeviceMesh": "torch.distributed.device_mesh",
    "init_device_mesh": "torch.distributed.device_mesh",
    "Shard": "torch.distributed.tensor",
    "Replicate": "torch.distributed.tensor",
    "compute_local_shape_and_global_offset": "torch.distributed.tensor._utils",
}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name]), name)
    globals()[name] = value
    return value


def FakeStore():  # noqa: N802 - the class's own name
    """A store for ``init_process_group("fake", ...)``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore as _FakeStore
    return _FakeStore()


__all__ = ["DeviceMesh", "init_device_mesh", "Shard", "Replicate",
           "compute_local_shape_and_global_offset",
           "Library", "register_fake", "FlopCounterMode", "FakeStore"]
