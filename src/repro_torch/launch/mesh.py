"""Production meshes — the port's counterpart of ``repro/launch/mesh.py``.

``make_production_mesh()`` is a function (importing this module touches no
device or process group):
  single-pod:  (16, 16)      axes ('data', 'model')          — 256 ranks
  multi-pod:   (2, 16, 16)   axes ('pod', 'data', 'model')   — 512 ranks

The shapes are the reference's, so the dry run's records line up cell for
cell.  TP/EP run inside the 'model' axis, FSDP over 'data', pure DP over
'pod' (only gradient all-reduces cross it).  On H100s a 16-wide 'model'
axis spans two 8-GPU NVLink nodes: its collectives cross the inter-node
network (ROADMAP.md keeps this as an open layout question).

Each returns a ``DeviceMesh`` when the default process group has exactly
the mesh's ranks (a real one, or the dry run's ``'fake'`` group), else an
``AbstractMesh`` with the same axes (``sharding/compat.py::make_mesh``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding import compat


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ('pod', 'data', 'model') if multi_pod else ('data', 'model')
    return compat.make_mesh(shape, axes, device_type)


def _world() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(torch.cuda.device_count(), 1)


def make_host_mesh(device_type: Optional[str] = None):
    """Whatever this process group has (tests, examples): (W, 1) over
    ('data', 'model'); W is the group's size, else the visible cards (at
    least 1)."""
    return compat.make_mesh((_world(), 1), ('data', 'model'), device_type)


def make_data_mesh(world: Optional[int] = None,
                   device_type: Optional[str] = None):
    """A 1-D pure-DP ``('data',)`` mesh over the first ``world`` ranks of
    the default group (all of them by default) — the elastic trainer's
    layout.  ``world`` may be smaller than the group: a resize that drops
    workers keeps running on the surviving prefix."""
    have = _world()
    world = have if world is None else int(world)
    if not 1 <= world <= have:
        raise ValueError(f'world must be in [1, {have}] (ranks), got '
                         f'{world}')
    import torch.distributed as dist
    if world == have or not (dist.is_available() and dist.is_initialized()):
        return compat.make_mesh((world,), ('data',), device_type)
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = 'cuda' if torch.cuda.is_available() else 'cpu'
    return DeviceMesh(device_type, torch.arange(world),
                      mesh_dim_names=('data',))
