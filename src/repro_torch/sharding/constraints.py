"""Activation layout constraints, mesh-aware and model-agnostic — the port's
counterpart of ``repro/sharding/constraints.py``.

``constrain(x, *roles)`` lays a tensor out by one logical role per dim
(``'data'`` -> the ``('pod', 'data')`` axes, ``'model'``, or None), and
``shard_activations(x)`` pins the batch dim of (B, S, D)-like activations to
the data axes (the sequence dim over ``'data'`` when the batch does not
divide).  Both keep the reference's rules, and both are the identity on a
plain tensor, outside a mesh, or inside a data group in scope (the
reference's ``shard_map`` body); on a DTensor they redistribute it
(``compat.with_spec``).

The statistics reductions of the data group in scope live in
``comm/exchange.py`` and ``comm/group.py`` and are re-exported here under the
reference's names.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm.exchange import (collect_pmean_stats,  # noqa: F401
                                       issue_pmean_stats, pmean_stats,
                                       psum_tree)
from repro_torch.comm.group import data_axes_in_scope  # noqa: F401
from repro_torch.sharding import compat

__all__ = ['constrain', 'shard_activations', 'data_axes_in_scope',
           'issue_pmean_stats', 'collect_pmean_stats', 'pmean_stats',
           'psum_tree']


def _current_mesh():
    """The mesh in scope where constraints apply: None outside
    ``set_mesh`` and inside a data group in scope."""
    m = compat.current_mesh()
    if m is None or not compat.axes_all_auto(m):
        return None
    if compat.bound_axis_names():
        return None
    return m


def _data_spec(daxes: tuple[str, ...]):
    return daxes if len(daxes) > 1 else daxes[0]


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by logical role per dim: 'data' (-> (pod, data)),
    'model', or None; a role is dropped where its axis is missing or does
    not divide the dim."""
    mesh = _current_mesh()
    if mesh is None:
        return x
    shape = compat.mesh_shape(mesh)
    daxes = tuple(a for a in ('pod', 'data') if a in shape)
    dsize = 1
    for a in daxes:
        dsize *= shape[a]
    spec: list = [None] * x.dim()
    for i, role in enumerate(axes[:x.dim()]):
        if role == 'data' and daxes and x.shape[i] % dsize == 0 \
                and x.shape[i] > 0:
            spec[i] = _data_spec(daxes)
        elif role == 'model' and 'model' in shape and \
                x.shape[i] % shape['model'] == 0:
            spec[i] = 'model'
    if all(s is None for s in spec):
        return x
    return compat.with_spec(x, spec, mesh)


def shard_activations(x: torch.Tensor,
                      seq: Optional[str] = None) -> torch.Tensor:
    """Constrain dim 0 (batch) to (pod, data), and dim 1 (seq) to ``seq``
    when given; the sequence dim over 'data' for batch-1 cells."""
    mesh = _current_mesh()
    if mesh is None or x.dim() < 2:
        return x
    shape = compat.mesh_shape(mesh)
    daxes = tuple(a for a in ('pod', 'data') if a in shape)
    if not daxes:
        return x
    dsize = 1
    for a in daxes:
        dsize *= shape[a]
    spec: list = [None] * x.dim()
    if x.shape[0] % dsize == 0 and x.shape[0] >= dsize:
        spec[0] = _data_spec(daxes)
        if seq and seq in shape and x.dim() >= 3 and \
                x.shape[1] % shape[seq] == 0:
            spec[1] = seq
    elif x.dim() >= 2 and 'data' in shape and \
            x.shape[1] % shape['data'] == 0:
        spec[1] = 'data'
    else:
        return x
    return compat.with_spec(x, spec, mesh)
