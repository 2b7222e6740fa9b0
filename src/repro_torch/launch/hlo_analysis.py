"""Cost trace of a PyTorch function: FLOPs, HBM traffic and collective bytes
(the three roofline terms), and the collective/compute overlap — the port's
counterpart of ``repro/launch/hlo_analysis.py``.

The reference parses the compiled HLO text.  The port has no compiled
program: each entry here takes ``(fn, *args)`` and runs ``fn`` once on fake
copies of the arguments (``FakeTensorMode``: shapes and dtypes, no data, no
memory, no launch) under a dispatch mode that sees every aten and c10d op,
DTensor's local ops and collectives included.  An eager trace sees every
trip of every loop, so no trip-count multiplier is needed (the reference's
``parse_hlo``, ``computation_multipliers`` and ``shape_elems`` have no
counterpart).  The conventions are the reference's:

  * FLOPs: dots only, 2·prod(out)·K (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, ``mv``, ``dot``, and what ``einsum``/``matmul`` lower to);
    convolutions 2·prod(out)·prod(window), their input gradient likewise and
    their weight gradient over the output's window (the depthwise convs of
    this repo); elementwise ops are not counted.  ``library_flops`` is
    ``torch.utils.flop_counter``'s count of the same ops, for comparison.
  * HBM traffic: at op boundaries, the unique input bytes plus the output
    bytes; views and metadata ops are skipped (as ``_SKIP_TRAFFIC`` skips
    bitcasts), a gathered read moves twice its output and a scattered write
    twice its update (``_SLICED_READ``/``_SLICED_WRITE``), and an op that
    overwrites its first operand does not read it.  In eager PyTorch each
    op boundary is an HBM round trip, so this is the literal model of what
    the port runs.
  * Collective bytes moved per device (ring conventions, g the op's group
    size): all-reduce 2·size·(g−1)/g, all-gather size·(g−1)/g (size: the
    gathered output), reduce-scatter size·(g−1) (size: the shard),
    all-to-all, collective-permute and broadcast size.
  * A kernel of the port (``kernels/``) on fake CUDA operands is one custom
    call, as the reference's analysis sees a Pallas call: its operand bytes
    plus output bytes of traffic and no dot FLOPs
    (``kernels/launch.py::fake_call``).

Overlap (:func:`collective_overlap`) is by forward taint: each collective
issued inside the traced function taints its output, taint flows through
every op, a dot with a tainted input is dependent, and a collective is
blocking when some dot lies in its cone.  A ``wait`` is not a collective,
so statistics issued by an earlier step and waited on here taint nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import launch as klaunch
from repro_torch.sharding.compat import LayoutMode

COLLECTIVE_OPS = ('all-reduce', 'all-gather', 'reduce-scatter', 'all-to-all',
                  'collective-permute', 'broadcast')

# schema name -> collective kind
_COLLECTIVES = {
    **{f'c10d::{n}': 'all-reduce'
       for n in ('allreduce_', 'allreduce_coalesced_')},
    **{f'c10d::{n}': 'all-gather'
       for n in ('allgather_', '_allgather_base_', 'allgather_coalesced_',
                 'allgather_into_tensor_coalesced_')},
    **{f'c10d::{n}': 'reduce-scatter'
       for n in ('reduce_scatter_', '_reduce_scatter_base_',
                 'reduce_scatter_tensor_coalesced_')},
    'c10d::alltoall_': 'all-to-all', 'c10d::alltoall_base_': 'all-to-all',
    'c10d::broadcast_': 'broadcast', 'c10d::send': 'collective-permute',
    'c10d::recv_': 'collective-permute',
    **{f'_c10d_functional::{n}': 'all-reduce'
       for n in ('all_reduce', 'all_reduce_', 'all_reduce_coalesced',
                 'all_reduce_coalesced_')},
    **{f'_c10d_functional::{n}': 'all-gather'
       for n in ('all_gather_into_tensor', 'all_gather_into_tensor_out',
                 'all_gather_into_tensor_coalesced')},
    **{f'_c10d_functional::{n}': 'reduce-scatter'
       for n in ('reduce_scatter_tensor', 'reduce_scatter_tensor_coalesced')},
    '_c10d_functional::all_to_all_single': 'all-to-all',
    '_c10d_functional::broadcast': 'broadcast',
    '_c10d_functional::broadcast_': 'broadcast',
}

# allocation, aliasing and metadata: no bytes move
_SKIP_TRAFFIC = {
    'aten::empty', 'aten::empty_strided', 'aten::empty_like',
    'aten::new_empty', 'aten::new_empty_strided', 'aten::detach',
    'aten::alias', 'aten::lift_fresh', 'aten::_local_scalar_dense',
    'aten::sym_size', 'aten::sym_stride', 'aten::sym_numel',
    'aten::sym_storage_offset', 'aten::resize_', 'aten::set_',
    'aten::record_stream', 'aten::is_same_size',
    '_c10d_functional::wait_tensor',
}
# gathered reads: traffic ≈ the slice moved, not the full operand
_SLICED_READ = {'aten::index', 'aten::_unsafe_index', 'aten::index_select',
                'aten::gather', 'aten::embedding', 'aten::take'}
# scattered writes -> position of the update operand
_SLICED_WRITE = {
    'aten::index_put': 2, 'aten::index_put_': 2, 'aten::_index_put_impl_': 2,
    'aten::index_copy': 3, 'aten::index_copy_': 3, 'aten::index_add': 3,
    'aten::index_add_': 3, 'aten::scatter': 3, 'aten::scatter_': 3,
    'aten::scatter_add': 3, 'aten::scatter_add_': 3,
    'aten::scatter_reduce': 3, 'aten::scatter_reduce_': 3,
    'aten::slice_scatter': 1, 'aten::select_scatter': 1,
}
# ops that overwrite their first operand without reading it
_OVERWRITE = {'aten::copy_', 'aten::fill_', 'aten::zero_', 'aten::normal_',
              'aten::uniform_', 'aten::random_', 'aten::bernoulli_',
              'aten::exponential_'}
# dot ops -> position of the operand whose last dim is K
_DOTS = {'aten::mm': 0, 'aten::bmm': 0, 'aten::addmm': 1,
         'aten::baddbmm': 1, 'aten::addbmm': 1, 'aten::mv': 0,
         'aten::addmv': 1, 'aten::dot': 0, 'aten::vdot': 0}


def shape_bytes(x: Any) -> int:
    """Total bytes of a tensor, or of the tensors in a (nested) sequence."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(shape_bytes(v) for v in x)
    return 0


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _unique(ts: list) -> list:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _dot_flops(name: str, args, out) -> float:
    k = args[_DOTS[name]].shape[-1]
    return 2.0 * out.numel() * k


def _conv_flops(name: str, args, out) -> float:
    if name == 'aten::convolution':
        return 2.0 * out.numel() * math.prod(args[1].shape[2:])
    grad_out, _, weight = args[0], args[1], args[2]
    gi, gw = out[0], out[1]
    fl = 0.0
    if gi is not None:
        fl += 2.0 * gi.numel() * math.prod(weight.shape[2:])
    if gw is not None:
        fl += 2.0 * gw.numel() * math.prod(grad_out.shape[2:])
    return fl


def _group_size(name: str, args, kwargs) -> int:
    import torch.distributed as dist
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dist.ProcessGroup):
            return int(a.size())
        if isinstance(a, torch.ScriptObject):   # c10d ops box their group
            try:
                return int(dist.ProcessGroup.unbox(a).size())
            except RuntimeError:                # the boxed ReduceOp
                continue
    group = kwargs.get('group_name')
    if group is None:
        group = next((a for a in reversed(args) if isinstance(a, str)), None)
    if group is not None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return int(_resolve_process_group(group).size())
    return 2


def _collective_bytes(kind: str, size: float, g: int) -> float:
    if kind == 'all-reduce':
        return 2.0 * size * (g - 1) / max(g, 1)
    if kind == 'all-gather':
        return size * (g - 1) / max(g, 1)
    if kind == 'reduce-scatter':
        return float(size * max(g - 1, 1))
    return float(size)  # all-to-all / collective-permute / broadcast


@dataclasses.dataclass
class HloCosts:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_count: int = 0
    collective_by_op: dict = dataclasses.field(default_factory=dict)
    dot_flops_by_op: dict = dataclasses.field(default_factory=dict)
    # kernel name -> {'count': calls, 'bytes': operand + output bytes}
    custom_calls: dict = dataclasses.field(default_factory=dict)
    library_flops: float = 0.0


@dataclasses.dataclass
class OverlapReport:
    collective_count: int          # collectives issued in the trace
    blocking_collectives: int      # collectives with ≥1 dot in their cone
    total_dots: int
    dependent_dots: int
    dot_flops_total: float
    dot_flops_dependent: float

    @property
    def dot_flops_independent(self) -> float:
        return self.dot_flops_total - self.dot_flops_dependent

    @property
    def dependent_fraction(self) -> float:
        return (self.dot_flops_dependent / self.dot_flops_total
                if self.dot_flops_total else 0.0)


class Trace:
    """The record of one traced run: costs, dots and taint (built by
    :func:`trace`).  ``on_outputs(out)``, when given, sees each counted
    op's outputs (the dry run's memory sampler)."""

    def __init__(self, on_outputs: Optional[Callable] = None):
        self.on_outputs = on_outputs
        self.costs = HloCosts()
        self.dots: list[tuple[float, int]] = []   # (flops, taint mask)
        self.n_collectives = 0
        self._taint: dict[int, tuple[torch.Tensor, int]] = {}
        self._quiet = 0

    # -- counting on and off (kernels' plain twins, DTensor's shape pass)
    def suspend(self) -> None:
        self._quiet += 1

    def resume(self) -> None:
        self._quiet -= 1

    def _mask(self, ts: list) -> int:
        m = 0
        for t in ts:
            hit = self._taint.get(id(t))
            if hit is not None:
                m |= hit[1]
        return m

    def _mark(self, ts: list, mask: int) -> None:
        if mask:
            for t in ts:
                prev = self._taint.get(id(t))
                self._taint[id(t)] = (t, mask | (prev[1] if prev else 0))

    def custom_call(self, name: str, args, out) -> None:
        ins, outs = _unique(_tensors(args)), _unique(_tensors(out))
        b = shape_bytes(ins) + shape_bytes(outs)
        c = self.costs.custom_calls.setdefault(name, {'count': 0,
                                                      'bytes': 0.0})
        c['count'] += 1
        c['bytes'] += b
        self.costs.traffic_bytes += b
        self._mark(outs, self._mask(ins))

    def op(self, func, args, kwargs, out) -> None:
        if self._quiet:
            return
        name = func._schema.name
        if name.startswith('prim::'):
            return
        ins = _unique(_tensors((args, kwargs)))
        outs = _unique(_tensors(out))
        mask = self._mask(ins)
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            written = _tensors(args[0]) if name.startswith('c10d::') \
                else outs
            size = shape_bytes(written)
            b = _collective_bytes(kind, size,
                                  _group_size(name, args, kwargs))
            c = self.costs
            c.collective_bytes += b
            c.collective_count += 1
            c.collective_by_op[kind] = c.collective_by_op.get(kind, 0.0) + b
            mask |= 1 << self.n_collectives
            self.n_collectives += 1
            self._mark(written, mask)
        self._mark(outs, mask)
        if func._schema.is_mutable:
            self._mark(ins, mask)
        if self.on_outputs is not None:
            self.on_outputs(out)
        self._flops(func, name, args, kwargs, out, mask)
        if func.is_view or name in _SKIP_TRAFFIC:
            return
        out_b = shape_bytes(outs)
        if name in _SLICED_READ:
            traffic = 2.0 * out_b
        elif name in _SLICED_WRITE:
            upd = args[_SLICED_WRITE[name]] \
                if len(args) > _SLICED_WRITE[name] else None
            if name.startswith('aten::index_put') or \
                    name == 'aten::_index_put_impl_':
                upd_b = shape_bytes(upd)
            elif isinstance(upd, torch.Tensor):
                upd_b = shape_bytes(upd)
            else:                       # a scalar value: the index's count
                upd_b = args[2].numel() * outs[0].element_size()
            traffic = 2.0 * min(upd_b, out_b)
        else:
            read = ins[1:] if name in _OVERWRITE else ins
            traffic = out_b + shape_bytes(read)
        self.costs.traffic_bytes += traffic

    def _flops(self, func, name, args, kwargs, out, mask) -> None:
        fl = 0.0
        if name in _DOTS:
            fl = _dot_flops(name, args, out)
        elif name in ('aten::convolution', 'aten::convolution_backward'):
            fl = _conv_flops(name, args, out)
        if fl:
            c = self.costs
            c.flops += fl
            c.dot_flops_by_op[name] = c.dot_flops_by_op.get(name, 0.0) + fl
            if name.startswith('aten::convolution'):
                return
            self.dots.append((fl, mask))
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.costs.library_flops += float(
                formula(*args, **kwargs, out_val=out))

    def overlap(self) -> OverlapReport:
        blocking = 0
        for _, m in self.dots:
            blocking |= m
        dep = [(f, m) for f, m in self.dots if m]
        return OverlapReport(
            collective_count=self.n_collectives,
            blocking_collectives=bin(blocking).count('1'),
            total_dots=len(self.dots), dependent_dots=len(dep),
            dot_flops_total=sum(f for f, _ in self.dots),
            dot_flops_dependent=sum(f for f, _ in dep))


class _TraceMode(LayoutMode):
    """The dispatch mode of a trace: a ``compat.LayoutMode`` (so DTensor
    ops and their fallbacks run as in the program) that records every plain
    op it sees."""

    def __init__(self, record: Trace, log=None):
        super().__init__(log)
        self.record = record

    def local_op(self, func, args, kwargs):
        out = func(*args, **kwargs)
        self.record.op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def _quiet_shape_pass(record: Trace):
    """DTensor runs each op once on global fake shapes to infer its output;
    that pass is not the program's work and is not counted."""
    try:
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
    except ImportError:     # a torch without DTensor
        yield
        return
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, *a, **k):
        record.suspend()
        try:
            return orig(self, *a, **k)
        finally:
            record.resume()
    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _fake_mode_of(args):
    from torch._subclasses.fake_tensor import FakeTensor
    for t in _tensors(args):
        local = getattr(t, '_local_tensor', t)
        if isinstance(local, FakeTensor):
            return local.fake_mode
    return None


def fake_copies(args, mode, device='cpu'):
    """``args`` with each real tensor replaced by its fake copy in ``mode``
    and each meta tensor by a fake one on ``device``; fake tensors,
    DTensors and other values as they are."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._pytree import tree_map

    def one(x):
        if not isinstance(x, torch.Tensor) or isinstance(x, FakeTensor) \
                or hasattr(x, '_local_tensor'):
            return x
        if x.is_meta:
            with mode:
                return torch.empty(x.shape, dtype=x.dtype, device=device)
        return mode.from_tensor(x)
    return tree_map(one, args)


def trace(fn: Callable, *args, log: Optional[list] = None,
          device='cpu', on_outputs: Optional[Callable] = None
          ) -> tuple[Trace, Any]:
    """Run ``fn`` once on fake copies of ``args`` (meta tensors become fakes
    on ``device``) and return ``(record, outputs)``.  ``log`` gets the ops
    that ran replicated for want of a DTensor sharding strategy (DTensor
    arguments need their DeviceMesh in scope: ``compat.set_mesh``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = _fake_mode_of(args) or FakeTensorMode(allow_non_fake_inputs=True)
    fargs = fake_copies(args, mode, device)
    record = Trace(on_outputs)
    klaunch.tracers.append(record)
    try:
        with mode, _quiet_shape_pass(record), _TraceMode(record, log):
            out = fn(*fargs)
    finally:
        klaunch.tracers.remove(record)
    return record, out


def analyze(fn: Callable, *args, log: Optional[list] = None,
            device='cpu') -> HloCosts:
    """FLOPs, traffic and collective bytes of one run of ``fn(*args)``."""
    return trace(fn, *args, log=log, device=device)[0].costs


def collective_overlap(fn: Callable, *args, device='cpu') -> OverlapReport:
    """Classify the dot FLOPs of one run of ``fn(*args)`` by whether they
    depend on a collective issued in it (see the module note).

    ``blocking_collectives`` counts, per collective, whether any dot sits
    in its own forward cone: a gradient all-reduce stays blocking in data
    parallelism, while a pipelined curvature exchange leaves the set."""
    return trace(fn, *args, device=device)[0].overlap()
