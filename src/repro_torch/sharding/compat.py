"""The mesh in scope and the layout helpers over ``torch.distributed`` — the
port's counterpart of ``repro/sharding/compat.py``.

The reference spans two jax generations; the port has one mesh type of its
own besides ``torch.distributed``'s ``DeviceMesh``:

* :class:`AbstractMesh` holds axis names and sizes and no process group.
  Layout resolution (``sharding/logical.py``) reads only a mesh's shape, so
  an abstract mesh serves the tests and the dry run's planning at 256 or 512
  ranks alike.
* A ``DeviceMesh`` carries real (or ``'fake'``) process groups; on it a spec
  becomes DTensor placements (:func:`placements`).

:func:`set_mesh` makes a mesh the one in scope.  With a ``DeviceMesh`` it
also enters :class:`LayoutMode`, which lets plain tensors meet DTensors as
replicated values and runs an op that DTensor has no sharding strategy for
on replicated operands (the all-gather GSPMD would insert), logging it.

The axes bound by ``shard_map`` in the reference are the data group in scope
here (``comm/group.py::in_scope``): :func:`bound_axis_names` and
:func:`bound_axis_sizes` read it.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Iterator, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.comm import group as group_mod


class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices or process groups.
    ``shape`` maps each axis name to its size, as a jax mesh's does."""

    def __init__(self, axis_shapes: Sequence[int],
                 axis_names: Sequence[str]):
        if len(axis_shapes) != len(axis_names):
            raise ValueError(f'{len(axis_shapes)} sizes for axes '
                             f'{tuple(axis_names)}')
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names,
                              (int(s) for s in axis_shapes)))
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f'AbstractMesh({self.shape})'


def is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of an AbstractMesh or a named DeviceMesh."""
    if mesh is None:
        return {}
    if is_device_mesh(mesh):
        return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    return dict(mesh.shape)


def mesh_size(mesh) -> int:
    return math.prod(mesh_shape(mesh).values())


_MESH: contextvars.ContextVar = contextvars.ContextVar(
    'repro_torch_mesh', default=None)


def current_mesh():
    """The mesh of the enclosing :func:`set_mesh`, or None."""
    return _MESH.get()


def axes_all_auto(mesh) -> bool:
    """True: every axis of a port mesh takes layout constraints.  The
    reference's Manual axes (inside ``shard_map``) are the data group in
    scope here, which ``constraints._current_mesh`` checks by
    :func:`bound_axis_names`."""
    del mesh
    return True


def bound_axis_names() -> tuple[str, ...]:
    """The mesh axes the data group in scope stands for: ``('data',)``,
    ``('pod', 'data')`` for a pod scope, () outside every scope."""
    return tuple(bound_axis_sizes())


def bound_axis_sizes() -> dict:
    """{axis name: size} of the data group in scope; {} outside one."""
    sc = group_mod.current()
    if sc is None:
        return {}
    if sc.pods is not None:
        return {'pod': int(sc.pods[0]), 'data': int(sc.pods[1])}
    return {'data': int(sc.world)}


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the ranks of the default process group when
    one is initialized with exactly ``prod(axis_shapes)`` ranks (row-major,
    as ``jax.make_mesh`` lays devices out), else an :class:`AbstractMesh`.
    ``device_type`` defaults to ``'cuda'`` with a card and ``'cpu'``
    without."""
    import torch.distributed as dist
    n = math.prod(axis_shapes)
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == n):
        return AbstractMesh(axis_shapes, axis_names)
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = 'cuda' if torch.cuda.is_available() else 'cpu'
    return DeviceMesh(device_type,
                      torch.arange(n).reshape(tuple(axis_shapes)),
                      mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name, or a tuple of them)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape: Sequence[int], spec: Sequence, mesh
                ) -> tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` laid out by
    ``spec`` on ``mesh`` (resolution only assigns axes that divide)."""
    sizes = mesh_shape(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(int(d) // math.prod(sizes[a] for a in spec_axes(e))
                 for d, e in zip(shape, spec))


def placements(spec: Sequence, mesh, ndim: Optional[int] = None) -> list:
    """DTensor placements of ``spec`` on the DeviceMesh ``mesh``: per mesh
    dim, ``Shard(d)`` for the tensor dim whose entry names that axis,
    else ``Replicate()``.  An entry naming two axes shards its dim over
    both, the first named the major one (``P(('pod', 'data'))``)."""
    from torch.distributed.tensor import Replicate, Shard
    spec = tuple(spec)
    if ndim is not None:
        spec = spec + (None,) * (ndim - len(spec))
    names = mesh.mesh_dim_names
    out: list = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        for a in spec_axes(e):
            out[names.index(a)] = Shard(d)
    return out


def distribute(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """``x`` as a DTensor laid out by ``spec`` on ``mesh``.  A real tensor
    is the global value (each rank keeps its shard); a meta or fake tensor
    stands for it, and each rank's local tensor is one of the shard's
    shape made in the same mode."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(spec, mesh, x.dim())
    if x.is_meta or _is_fake(x):
        loc = x.new_empty(local_shape(x.shape, spec, mesh))
        return DTensor.from_local(loc, mesh, pl, run_check=False,
                                  shape=x.shape, stride=_contiguous(x.shape))
    return distribute_tensor(x, mesh, pl)


def _contiguous(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(d)
    return tuple(reversed(stride))


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def with_spec(x, spec: Sequence, mesh):
    """``x`` redistributed to ``spec`` when it is a DTensor on a
    DeviceMesh; any other value unchanged (the identity of one device)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not is_device_mesh(mesh):
        return x
    pl = placements(spec, mesh, x.dim())
    if tuple(x.placements) == tuple(pl):
        return x
    with _dtensor_internals():
        return x.redistribute(mesh, pl)


# depth inside DTensor's own machinery (dispatch, redistribution), where its
# shard arithmetic must see real values under a fake-tensor trace
_DEPTH = [0]


@contextlib.contextmanager
def _dtensor_internals():
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


# ---------------------------------------------------------------------------
# Ops without a sharding strategy


# DTensor's refusals that replicating the operands answers: no strategy for
# the op, or a layout the op cannot take as it is (an uneven view)
_NO_STRATEGY = ('sharding strategy', 'redistribute the tensor',
                'Sharding propagation failed', 'is invalid for input of size',
                'from one partial type')
# ops whose DTensor strategy yields a layout DTensor cannot take apart again
# (``gather`` or ``embedding`` along a sharded dim leaves a masked partial
# whose gradient cannot be laid back; a grouped convolution over sharded
# channels keeps the full group count): their operands are replicated first
_REPLICATE_FIRST = {'aten::gather', 'aten::embedding',
                    'aten::convolution', 'aten::convolution_backward'}


def _flat(args, kwargs) -> list:
    from torch.utils._pytree import tree_flatten
    return tree_flatten((args, kwargs))[0]


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _index_arithmetic(func, leaves) -> bool:
    """An ``arange``, or an op on real tensors only."""
    ts = [a for a in leaves if isinstance(a, torch.Tensor)]
    if not ts:
        return func._schema.name == 'aten::arange'
    return not any(_is_fake(t) for t in ts)


class LayoutMode(TorchDispatchMode):
    """A dispatch mode for DTensor programs.  An op on DTensors goes to
    DTensor's own dispatch, its local ops back through this mode
    (:meth:`local_op`, which the cost trace overrides).  Where DTensor has
    no usable strategy for the op (``_NO_STRATEGY``, ``_REPLICATE_FIRST``),
    every DTensor operand is gathered to ``Replicate()``, the op runs on the
    full local values, its outputs come back replicated, and the op's name
    is appended to ``log``; a strided shard in an output is gathered at
    once (:meth:`_unstrided`)."""

    def __init__(self, log: Optional[list] = None):
        super().__init__()
        self.log = log if log is not None else []
        self._to_dtensor = False

    def local_op(self, func, args, kwargs):
        """A plain op (no DTensor operand)."""
        return func(*args, **kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _flat(args, kwargs)
        if not any(isinstance(a, _dtensor_type()) for a in leaves):
            if _DEPTH[0] and _index_arithmetic(func, leaves):
                # DTensor's own shard sizes and offsets, read back with
                # tolist: real values even under a fake-tensor trace
                from torch.utils._python_dispatch import \
                    _disable_current_modes
                with _disable_current_modes():
                    return func(*args, **kwargs)
            return self.local_op(func, args, kwargs)
        if self._to_dtensor:               # the re-entered call below
            self._to_dtensor = False
            return NotImplemented
        if func._schema.name in _REPLICATE_FIRST:
            return self._replicated(func, args, kwargs)
        self._to_dtensor = True
        try:
            with self, _dtensor_internals():   # local ops come back here
                out = func(*args, **kwargs)
        except (NotImplementedError, RuntimeError, AssertionError) as e:
            if not any(m in str(e) for m in _NO_STRATEGY):
                raise
            out = None
        finally:
            self._to_dtensor = False
        if out is None:
            return self._replicated(func, args, kwargs)
        return self._unstrided(func, out)

    def _unstrided(self, func, out):
        """``out`` with each strided shard (a sharded dim merged behind an
        unsharded one, as a view of a sequence-sharded (B, S, D) to
        (B·S, D) makes) gathered: DTensor plans every later op on such a
        layout by a search that grows with the mesh, and not always
        right."""
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.placement_types import _StridedShard
        from torch.utils._pytree import tree_map

        def fix(o):
            if not isinstance(o, _dtensor_type()) or not any(
                    isinstance(p, _StridedShard) for p in o.placements):
                return o
            self.log.append(f'  replicated: the strided output of {func}')
            pl = [Replicate() if isinstance(p, _StridedShard) else p
                  for p in o.placements]
            with self, _dtensor_internals():
                return o.redistribute(o.device_mesh, pl)
        return tree_map(fix, out)

    def _replicated(self, func, args, kwargs):
        from torch.distributed.tensor import Replicate
        from torch.utils._pytree import tree_map
        DTensor = _dtensor_type()
        if func._schema.is_mutable:
            raise NotImplementedError(
                f'{func} has no sharding strategy and mutates its '
                'operand: replicate the operand before the op')
        mesh = next(a.device_mesh for a in _flat(args, kwargs)
                    if isinstance(a, DTensor))
        self.log.append(f'  replicated: {func} (no sharding strategy '
                        'for its layout)')
        full = [Replicate()] * mesh.ndim

        def gather(a):
            if isinstance(a, DTensor):
                return a.redistribute(mesh, full).to_local()
            return a

        def wrap(o):
            if isinstance(o, torch.Tensor):
                return DTensor.from_local(o, mesh, full, run_check=False)
            return o
        with self, _dtensor_internals():
            la, lk = tree_map(gather, (args, kwargs))
        with self:
            return tree_map(wrap, func(*la, **lk))


@contextlib.contextmanager
def set_mesh(mesh, log: Optional[list] = None) -> Iterator[Any]:
    """Enter ``mesh`` (an AbstractMesh or a DeviceMesh) as the mesh in
    scope.  On a DeviceMesh, plain tensors meet DTensors as replicated
    values, and ops without a sharding strategy run replicated (their
    names go to ``log``)."""
    token = _MESH.set(mesh)
    try:
        with contextlib.ExitStack() as stack:
            if is_device_mesh(mesh):
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
                stack.enter_context(LayoutMode(log))
            yield mesh
    finally:
        _MESH.reset(token)
