"""Codec-aware exchange primitives: the one place collectives happen —
PyTorch port of ``repro/comm/exchange.py`` and of the statistics reduction
of ``repro/sharding/constraints.py`` (``issue_/collect_/pmean_stats``,
``psum_tree``; the port has no ``sharding`` package).

The reference's mesh axes become the data group in scope
(``comm/group.py``): every primitive takes ``scope=`` (default: the scope
in effect; None: no scope) and is the identity outside one.  Collectives
are ``torch.distributed`` calls over the scope's group; a tree's leaves are
coalesced into one flat buffer per dtype, so a tree costs one collective.

* :func:`allreduce_mean_tree`: mean all-reduce of a tree, optionally
  through a codec with a carried error-feedback residual.  With int8 it is
  the reference's order: the global MAX of each leaf's ``amax``, int8
  quantization, an exact int32 sum, the shared-scale dequantization and the
  division by W.
* :func:`allgather_owned_slices`: the owned-slice refresh exchange.  Each
  worker sends only the stack rows it owns (a padded static-shape
  all-gather keyed off ``ownership.assign_slice_owners``) and every row is
  rebuilt as an exact copy of its owner's value.  ``pods=`` gathers inside
  each pod and sums the owning pod's rebuilt bucket across pods once.
* :func:`psum_partials`: the one collective of the factor-sharded solve
  (``core/factor_sharded.py``), an f32 sum of the band partials.

Both tree primitives split into an ``issue_*`` half (encode, every
collective, the byte accounting) and a ``collect_*`` half (wait, decode,
divide, rebuild: local math).  ``async_op=True`` leaves the sums in flight
(``Work`` handles in the in-flight object); the one-step pipeline
(``schedule/pipeline.py``) issues at step t and collects at t+1.  The pod
exchange's cross-pod sum consumes the rebuilt bucket, so its issue half
carries it to the end and collect is the identity.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import group as group_mod
from repro_torch.comm import metrics
from repro_torch.comm.codec import F32, Codec, get_codec
from repro_torch.core.transform import tree_leaves, tree_map

F32_DT = torch.float32
# ``scope=IN_SCOPE``: the data group in scope (``group.current()``)
IN_SCOPE = 'in scope'


# ---------------------------------------------------------------------------
# Train-level exchange configuration (threaded through ``Extras.comm``)


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """Which codec each call-site family uses.

    grads: the gradient all-reduce codec of the compressed explicit-DP
    step (error feedback applies there).  stats: the statistics reduction
    codec (K-FAC's and FOOF's ``a_outer``/``b_outer``).  codec: the
    owned-slice refresh codec ('identity'/'f32' | 'bf16' | 'int8').
    exchange: 'gather' (owned slices, ~1/W of the stack a worker) or
    'psum' (the full zero-padded stack).  topology: 'flat', or 'pod'
    (pod-local ownership, the slice gather inside each pod and one
    cross-pod sum of the bucket; needs a pod scope, else flat).
    """

    grads: Any = 'int8'
    stats: Any = 'f32'
    codec: Any = 'f32'
    exchange: str = 'gather'
    topology: str = 'flat'

    def __post_init__(self):
        if self.exchange not in ('gather', 'psum'):
            raise ValueError("exchange must be 'gather' or 'psum', "
                             f'got {self.exchange!r}')
        if self.topology not in ('flat', 'pod'):
            raise ValueError("topology must be 'flat' or 'pod', "
                             f'got {self.topology!r}')


_DEFAULT = ExchangeConfig()


def from_extras(extras) -> ExchangeConfig:
    """The config threaded through ``Extras.comm``, else the default."""
    cfg = getattr(extras, 'comm', None) if extras is not None else None
    return cfg if cfg is not None else _DEFAULT


# ---------------------------------------------------------------------------
# Scope, leaves and coalesced collectives


def _resolve(scope) -> Optional[group_mod.DataScope]:
    if isinstance(scope, str) and scope == IN_SCOPE:
        return group_mod.current()
    if scope is None:
        return None
    return group_mod.scope_of(scope)


def _leaves(tree) -> list:
    """The tensor leaves of ``tree`` in ``tree_map``'s walk order."""
    out: list = []
    tree_map(lambda x: out.append(x), tree)
    return out


def _unflatten(tree, values) -> Any:
    """``tree`` with its leaves replaced, in walk order, by ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def _sum_leaves(leaves: list, group, *, async_op: bool = False):
    """Sum every leaf over ``group`` in its own dtype, one flat buffer per
    dtype.  Returns ``(outputs, works)``: each output a view of its
    buffer, valid once every ``Work`` in ``works`` has been waited on."""
    outs: list = [None] * len(leaves)
    works = []
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        buf = torch.cat([leaves[i].reshape(-1) for i in idx])
        work = dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group,
                               async_op=async_op)
        if async_op:
            works.append(work)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            outs[i] = buf[off:off + n].view(leaves[i].shape)
            off += n
    return outs, works


def _wait(works) -> None:
    for w in works or ():
        w.wait()


_ALIGN = 16


def _allgather_parts(parts: list, group, world: int) -> list:
    """All-gather a list of contiguous tensors (the same shapes and dtypes
    on every rank) as one byte buffer.  Returns, per rank, its parts."""
    layout, off = [], 0
    for p in parts:
        nb = p.numel() * p.element_size()
        layout.append((off, nb, p.dtype, tuple(p.shape)))
        off += -(-nb // _ALIGN) * _ALIGN
    buf = torch.zeros(max(off, _ALIGN), dtype=torch.uint8,
                      device=parts[0].device)
    for p, (o, nb, _, _) in zip(parts, layout):
        buf[o:o + nb] = p.contiguous().reshape(-1).view(torch.uint8)
    got = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(got, buf, group=group)
    return [[g[o:o + nb].view(dt).view(shape) for (o, nb, dt, shape)
             in layout] for g in got]


# ---------------------------------------------------------------------------
# Byte accounting (from shapes and codecs, as in the reference)


def leaf_payload_bytes(leaf, codec: Codec) -> int:
    """Logical bytes one worker contributes for one leaf: the payload and
    the f32 scale of a scaled codec."""
    n = metrics.leaf_elements(leaf)
    payload = (n * codec.wire_bits + 7) // 8
    return payload + (4 if codec.has_scale else 0)


def tree_payload_bytes(tree, codec: Codec) -> int:
    return sum(leaf_payload_bytes(x, codec) for x in tree_leaves(tree))


# ---------------------------------------------------------------------------
# Mean all-reduce


class InFlightMean(NamedTuple):
    """An issued, not yet collected, mean all-reduce: the payloads (views of
    the summed buffers once ``works`` are waited on), their scales, the
    divisor, the new residual tree and the info dict."""
    payloads: Optional[list]
    scales: Optional[list]
    n: Any
    new_err: Any
    info: dict
    tree: Any
    codec: Codec
    scope: Optional[group_mod.DataScope]
    works: list


def _issue_leaves(leaves: list, err_leaves: list, c: Codec,
                  sc: Optional[group_mod.DataScope], async_op: bool):
    """Fold the residuals, encode and fire the sums for a list of leaves.
    Returns ``(payloads, scales, new_errs, n_sats, works)``."""
    xs = []
    for g, e in zip(leaves, err_leaves):
        x = g.to(F32_DT)
        if c.error_feedback and e is not None:
            x = x + e
        xs.append(x)
    if c.passthrough:
        n_sats = [torch.zeros((), dtype=F32_DT, device=x.device)
                  for x in xs[:1]] * len(xs)
        if sc is None:
            return xs, [None] * len(xs), list(err_leaves), n_sats, []
        sums, works = _sum_leaves(xs, sc.group, async_op=async_op)
        return sums, [None] * len(xs), list(err_leaves), n_sats, works
    amaxes = [None] * len(xs)
    if c.has_scale and xs:
        # only a scaled codec reads the max: one MAX over the group for all
        amax = torch.stack([x.abs().max() for x in xs])
        if sc is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=sc.group)
        amaxes = list(amax.unbind())
    payloads, scales, new_errs, n_sats = [], [], [], []
    for x, a, e in zip(xs, amaxes, err_leaves):
        p, s, ns = c.encode(x, a)
        payloads.append(p)
        scales.append(s)
        n_sats.append(ns)
        new_errs.append(x - c.decode(p, s) if c.error_feedback else e)
    if sc is None:
        return payloads, scales, new_errs, n_sats, []
    if c.sum_dtype is not None:
        sums, works = _sum_leaves([p.to(c.sum_dtype) for p in payloads],
                                  sc.group, async_op=async_op)
        return sums, scales, new_errs, n_sats, works
    # no exact-sum wire dtype: sum the locally decoded values
    sums, works = _sum_leaves([c.decode(p, s) for p, s in
                               zip(payloads, scales)], sc.group,
                              async_op=async_op)
    return sums, [None] * len(xs), new_errs, n_sats, works


def _collect_leaf(payload, scale, n, c: Codec, sc) -> torch.Tensor:
    if c.passthrough:
        return payload / n if sc is not None else payload
    if sc is None:
        return c.decode(payload, scale)
    if c.sum_dtype is not None:
        return c.decode(payload, scale) / n
    return payload / n


def _divisor(c: Codec, sc, n_workers):
    """Passthrough codecs divide by W itself (the reference's ``psum`` of a
    Python 1); lossy ones by the summed count of workers."""
    if sc is None:
        return None
    return sc.world if c.passthrough else n_workers


def allreduce_mean_leaf(g: torch.Tensor, err: Optional[torch.Tensor], *,
                        codec: Any, scope: Any = IN_SCOPE
                        ) -> tuple[torch.Tensor, Optional[torch.Tensor],
                                   torch.Tensor]:
    """Codec'd mean all-reduce of one leaf: ``(mean, new_err, n_sat)``
    (``n_sat`` is this worker's count).  Without a scope the leaf still
    round-trips through the codec, so one worker is the W = 1 case of the
    same path; codecs without error feedback return ``err`` as it is."""
    c = get_codec(codec)
    sc = _resolve(scope)
    payloads, scales, new_errs, n_sats, works = _issue_leaves(
        [g], [err], c, sc, async_op=False)
    n_workers = None
    if sc is not None and not c.passthrough:
        n_workers = torch.ones((), dtype=F32_DT, device=g.device)
        dist.all_reduce(n_workers, group=sc.group)
    mean = _collect_leaf(payloads[0], scales[0], _divisor(c, sc, n_workers),
                         c, sc)
    return mean, new_errs[0], n_sats[0]


def issue_allreduce_mean_tree(tree: Any, err: Optional[Any] = None, *,
                              codec: Any = 'f32', scope: Any = IN_SCOPE,
                              site: Optional[str] = None,
                              async_op: bool = False) -> InFlightMean:
    """Collective half of :func:`allreduce_mean_tree`: every sum (and the
    byte record and the residual update) happens here; the decode and the
    division wait for :func:`collect_allreduce_mean_tree`.  With
    ``async_op`` the payload sums stay in flight."""
    c = get_codec(codec)
    sc = _resolve(scope)
    if tree is None:
        return InFlightMean(None, None, None, err,
                            {'saturation': torch.zeros(())}, None, c, sc, [])
    leaves = _leaves(tree)
    dev = leaves[0].device
    err_leaves = _leaves(err) if err is not None else [None] * len(leaves)
    payloads, scales, new_errs, n_sats, works = _issue_leaves(
        leaves, err_leaves, c, sc, async_op)
    n_workers = None
    if c.passthrough:
        # nothing saturates, and the divisor is W itself: no count to sum
        sat_frac = torch.zeros((), dtype=F32_DT, device=dev)
    else:
        sat = torch.stack(n_sats).sum()
        elems = sum(metrics.leaf_elements(x) for x in leaves)
        if sc is not None:
            # the saturation count and the worker count, summed at run time
            both = torch.stack([sat, torch.ones((), dtype=F32_DT,
                                                device=dev)])
            dist.all_reduce(both, group=sc.group)
            sat, n_workers = both[0], both[1]
            sat_frac = sat / (max(elems, 1) * n_workers)
        else:
            sat_frac = sat / max(elems, 1)
    if site is not None:
        metrics.record(site, bytes_per_call=tree_payload_bytes(leaves, c),
                       codec=c.name, mode='allreduce')
    new_err = _unflatten(err, new_errs) if err is not None else None
    return InFlightMean(payloads, scales, _divisor(c, sc, n_workers),
                        new_err, {'saturation': sat_frac}, tree, c, sc,
                        works)


def collect_allreduce_mean_tree(fl: InFlightMean
                                ) -> tuple[Any, Optional[Any], dict]:
    """Local finishing half: wait for the sums, decode and divide.  Returns
    ``(mean_tree, new_err_tree, info)``."""
    if fl.tree is None:
        return None, fl.new_err, fl.info
    _wait(fl.works)
    means = [_collect_leaf(p, s, fl.n, fl.codec, fl.scope)
             for p, s in zip(fl.payloads, fl.scales)]
    return _unflatten(fl.tree, means), fl.new_err, fl.info


def allreduce_mean_tree(tree: Any, err: Optional[Any] = None, *,
                        codec: Any = 'f32', scope: Any = IN_SCOPE,
                        site: Optional[str] = None
                        ) -> tuple[Any, Optional[Any], dict]:
    """Mean all-reduce of a tree: ``(mean_tree, new_err_tree, info)`` with
    ``info['saturation']`` the global share of saturated elements (0 by
    construction under the global max scale)."""
    return collect_allreduce_mean_tree(issue_allreduce_mean_tree(
        tree, err, codec=codec, scope=scope, site=site))


# ---------------------------------------------------------------------------
# The statistics reduction (the reference's sharding/constraints.py)


class InFlightPmean(NamedTuple):
    """An issued statistics reduction: kind 'raw' (no scope: the tree as it
    is), 'passthrough' (summed in the leaves' own dtype, ``n`` = W) or
    'codec' (``tree`` is an :class:`InFlightMean`)."""
    tree: Any
    n: Any
    kind: str
    works: list


def issue_pmean_stats(tree, codec=None, site: Optional[str] = None, *,
                      scope: Any = IN_SCOPE,
                      async_op: bool = False) -> InFlightPmean:
    """Collective half of :func:`pmean_stats`.  Without a scope nothing
    moves, but a named site still records the tree's logical payload
    (mode 'local')."""
    sc = _resolve(scope)
    c = get_codec(codec)
    if sc is None or tree is None:
        if site is not None and tree is not None:
            metrics.record(site, bytes_per_call=tree_payload_bytes(tree, c),
                           codec=c.name, mode='local')
        return InFlightPmean(tree, None, 'raw', [])
    if c.passthrough:
        if site is not None:
            metrics.record(site, bytes_per_call=tree_payload_bytes(tree, c),
                           codec=c.name, mode='psum')
        sums, works = _sum_leaves(_leaves(tree), sc.group, async_op=async_op)
        return InFlightPmean(_unflatten(tree, sums), sc.world, 'passthrough',
                             works)
    fl = issue_allreduce_mean_tree(tree, codec=c, scope=sc, site=site,
                                   async_op=async_op)
    return InFlightPmean(fl, None, 'codec', [])


def collect_pmean_stats(fl: InFlightPmean):
    """Local finishing half of :func:`pmean_stats` (wait, divide, decode)."""
    if fl.kind == 'raw':
        return fl.tree
    if fl.kind == 'passthrough':
        _wait(fl.works)
        return tree_map(lambda v: v / fl.n, fl.tree)
    return collect_allreduce_mean_tree(fl.tree)[0]


def pmean_stats(tree, codec=None, site: Optional[str] = None, *,
                scope: Any = IN_SCOPE):
    """Mean of per-worker KV / KF statistics over the data group in scope
    (the paper's batch-global statistics, §3.3); the identity outside a
    scope.  f32 (or None) keeps plain sums, idempotent over replicated
    values; bf16 and int8 quantize at every call."""
    return collect_pmean_stats(issue_pmean_stats(tree, codec=codec,
                                                 site=site, scope=scope))


def psum_tree(tree, scope: Any = IN_SCOPE):
    """Sum a tree over the data group in scope (the zero-padded refresh
    exchange: ``x + 0`` is exact); the identity outside one."""
    sc = _resolve(scope)
    if sc is None or tree is None:
        return tree
    sums, _ = _sum_leaves(_leaves(tree), sc.group)
    return _unflatten(tree, sums)


# ---------------------------------------------------------------------------
# Owned-slice refresh exchange


@functools.lru_cache(maxsize=1024)
def _gather_maps(owner: tuple, world: int) -> tuple:
    """Static index maps of one bucket's owned-slice exchange:
    ``(send (world, M), src (N,), M)``.  Worker ``w`` sends rows
    ``send[w]`` (its owned rows, padded by repetition to the largest count
    M), and row ``i`` of the stack comes back from flat gather position
    ``src[i] = owner_i * M + (its index among the owner's rows)``."""
    n = len(owner)
    mine = {w: [i for i in range(n) if owner[i] == w] for w in range(world)}
    m = max(1, max(len(v) for v in mine.values()))
    send = np.zeros((world, m), np.int32)
    for w in range(world):
        for j in range(m):
            send[w, j] = mine[w][j % len(mine[w])] if mine[w] else 0
    src = np.zeros(n, np.int32)
    for w in range(world):
        for j, i in enumerate(mine[w]):
            src[i] = w * m + j
    return send, src, m


def owned_slice_bytes(stack_tree: Any, owner, world: int,
                      codec: Codec) -> int:
    """Logical bytes one worker contributes to the owned-slice all-gather
    of one bucket's stacked tree (leaves shaped (N, ...)): its padded M
    rows, and a per-row f32 scale for a scaled codec."""
    _, _, m = _gather_maps(tuple(int(w) for w in owner), world)
    total = 0
    for leaf in tree_leaves(stack_tree):
        n_items = int(leaf.shape[0])
        per_row = metrics.leaf_elements(leaf) // max(n_items, 1)
        total += (m * per_row * codec.wire_bits + 7) // 8
        if codec.has_scale:
            total += 4 * m
    return total


class _GatheredLeaf(NamedTuple):
    """One leaf's gathered wire rows and how to rebuild the stack."""
    payload: Any       # (world, M, *item)
    scale: Any         # (world, M, 1...) or None
    src: Any           # (N,) flat gather position of each stack row
    out_dtype: Any


class InFlightSlices(NamedTuple):
    """An issued owned-slice exchange: ``stacks`` maps each bucket to
    ``(its stacked tree, [one _GatheredLeaf per leaf])``.  ``done``: the
    pod exchange, whose issue half carries it to the end: ``stacks`` holds
    the rebuilt trees and collect is the identity."""
    stacks: dict
    done: bool
    codec: Codec


def _encode_rows(x: torch.Tensor, rows, c: Codec):
    local = x.index_select(0, rows).to(F32_DT)
    if local.dim() > 1:
        amax = local.abs().amax(dim=tuple(range(1, local.dim())),
                                keepdim=True)
    else:
        amax = local.abs()
    payload, scale, _ = c.encode(local, amax)
    return local, payload, scale


def issue_allgather_owned_slices(plan, owners: dict, world: int, rank,
                                 stacks: dict, *, codec: Any = 'f32',
                                 scope: Any = IN_SCOPE,
                                 site: Optional[str] = None,
                                 pods: Optional[tuple[int, int]] = None
                                 ) -> InFlightSlices:
    """Collective half of :func:`allgather_owned_slices`: take the owned
    rows, encode, all-gather the payloads and scales (one byte buffer for
    the whole plan), record the bytes.  The decode and the rebuild wait for
    :func:`collect_allgather_owned_slices`."""
    c = get_codec(codec)
    sc = _resolve(scope)
    two_stage = (pods is not None and sc is not None
                 and sc.pods is not None and pods[0] > 1
                 and pods[0] * pods[1] == world)
    entries = []     # (bucket key, leaf position, x, rows, src, owner)
    nbytes = ici = dcn = 0
    for b in plan.buckets:
        owner = tuple(int(w) for w in owners[b.key])
        if two_stage:
            per_pod = pods[1]
            bucket_pod = owner[0] // per_pod
            if any(w // per_pod != bucket_pod for w in owner):
                raise ValueError(f'bucket {b.key}: owners {owner} span pods '
                                 '(the pod exchange needs pod-local owners)')
            send, src, _ = _gather_maps(
                tuple(w - bucket_pod * per_pod for w in owner), per_pod)
            rows = send[rank % per_pod]
        else:
            send, src, _ = _gather_maps(owner, world)
            rows = send[rank]
        for j, x in enumerate(_leaves(stacks[b.key])):
            entries.append((b.key, j, x, torch.as_tensor(
                rows, dtype=torch.long, device=x.device),
                torch.as_tensor(src, dtype=torch.long, device=x.device),
                owner))
        if two_stage:
            local_owner = np.asarray(owner) % pods[1]
            ici += owned_slice_bytes(stacks[b.key], local_owner, pods[1], c)
            # the cross-pod sum carries the whole rebuilt bucket in f32
            dcn += sum(4 * metrics.leaf_elements(x)
                       for x in tree_leaves(stacks[b.key]))
        else:
            nbytes += owned_slice_bytes(stacks[b.key], owners[b.key],
                                        world, c)
    parts, spans = [], []
    for _, _, x, rows, _, _ in entries:
        _, payload, scale = _encode_rows(x, rows, c)
        spans.append((len(parts), scale is not None))
        parts.append(payload)
        if scale is not None:
            parts.append(scale)
    group = sc.pod_group if two_stage else sc.group
    n_ranks = pods[1] if two_stage else world
    got = _allgather_parts(parts, group, n_ranks) if parts else []
    gathered = {}
    for (key, j, x, _, src, owner), (at, scaled) in zip(entries, spans):
        g_p = torch.stack([got[r][at] for r in range(n_ranks)])
        g_s = (torch.stack([got[r][at + 1] for r in range(n_ranks)])
               if scaled else None)
        gathered.setdefault(key, []).append(
            (_GatheredLeaf(payload=g_p, scale=g_s, src=src,
                           out_dtype=x.dtype), owner))
    out = {}
    if two_stage:
        n_pods, per_pod = pods
        my_pod = rank // per_pod
        recon = []
        for key, leaves in gathered.items():
            for gl, owner in leaves:
                r = _rebuild(gl, c)
                if my_pod != owner[0] // per_pod:
                    r = torch.zeros_like(r)
                recon.append(r)
        sums, _ = _sum_leaves(recon, sc.cross_group)
        it = iter(sums)
        for key, leaves in gathered.items():
            out[key] = _unflatten(stacks[key], [
                next(it).to(gl.out_dtype) for gl, _ in leaves])
    else:
        for key, leaves in gathered.items():
            out[key] = (stacks[key], [gl for gl, _ in leaves])
    if site is not None:
        if two_stage:
            metrics.record(site, bytes_per_call=ici + dcn, codec=c.name,
                           mode='gather-pod',
                           extra={'world': world, 'pods': list(pods),
                                  'ici_bytes': ici, 'dcn_bytes': dcn})
        else:
            metrics.record(site, bytes_per_call=nbytes, codec=c.name,
                           mode='gather', extra={'world': world})
    return InFlightSlices(stacks=out, done=two_stage, codec=c)


def _rebuild(gl: _GatheredLeaf, c: Codec) -> torch.Tensor:
    vals = c.decode(gl.payload, gl.scale)
    flat = vals.reshape((vals.shape[0] * vals.shape[1],)
                        + tuple(vals.shape[2:]))
    return flat.index_select(0, gl.src)


def collect_allgather_owned_slices(fl: InFlightSlices) -> dict:
    """Local finishing half: decode the gathered rows and take each stack
    row from its owner's position (the identity for the pod exchange)."""
    if fl.done:
        return fl.stacks
    return {key: _unflatten(tree, [_rebuild(gl, fl.codec).to(gl.out_dtype)
                                   for gl in gathered])
            for key, (tree, gathered) in fl.stacks.items()}


def allgather_owned_slices(plan, owners: dict, world: int, rank,
                           stacks: dict, *, codec: Any = 'f32',
                           scope: Any = IN_SCOPE,
                           site: Optional[str] = None,
                           pods: Optional[tuple[int, int]] = None) -> dict:
    """Rebuild full bucket stacks from per-owner slices.

    ``owners``: ``{bucket_key: (N,) owner ranks}`` from
    ``ownership.assign_slice_owners`` (``assign_pod_slice_owners`` with
    ``pods=``), the same on every worker; N is the stacks' leading axis.
    ``stacks``: ``{bucket_key: tree of (N, *item) tensors}`` whose owned
    rows hold real values (other rows are never read).  int8 takes one
    symmetric scale per row (each row has one producer).  ``pods``:
    ``(n_pods, per_pod)`` for the two-stage exchange over a pod scope.
    Returns stacks of the same structure, every row its owner's value."""
    return collect_allgather_owned_slices(issue_allgather_owned_slices(
        plan, owners, world, rank, stacks, codec=codec, scope=scope,
        site=site, pods=pods))


def refresh_exchange_bytes(plan, owners: dict, stacks: Any, world: int, *,
                           codec: Any = 'f32', mode: str = 'gather') -> int:
    """Logical per-worker bytes of one refresh exchange, as the runtime
    records them: 'psum' sends the whole zero-padded stack in f32 whatever
    the codec, 'gather' the padded owned rows under ``codec``."""
    if mode == 'psum':
        return sum(4 * metrics.leaf_elements(x)
                   for k in stacks for x in tree_leaves(stacks[k]))
    c = get_codec(codec)
    return sum(owned_slice_bytes(stacks[b.key], owners[b.key], world, c)
               for b in plan.buckets)


def psum_partials(tree: Any, world: int, *, scope: Any = IN_SCOPE,
                  site: Optional[str] = 'factor', calls: int = 1,
                  extra: Optional[dict] = None) -> Any:
    """Sum the full-width per-worker matvec partials of the factor-sharded
    solve (``core/factor_sharded.py``) over the data group in scope: an f32
    ``all_reduce`` in place on the partials.  Each worker's partial comes
    from its own row band of the factor (zero pad rows add zero), so the
    sum is the whole product.  ``calls`` scales the recorded bytes to one
    whole solve, as the reference's record once per traced solve; W = 1 or
    no scope records mode 'local' and moves nothing."""
    sc = _resolve(scope)
    nbytes = tree_payload_bytes(tree, F32) * max(1, int(calls))
    info = {'world': int(world)}
    if extra:
        info.update(extra)
    collective = world > 1 and sc is not None
    if site:
        metrics.record(site, bytes_per_call=nbytes, codec='f32',
                       mode='psum-partial' if collective else 'local',
                       extra=info)
    if not collective:
        return tree
    leaves = [x.to(F32_DT) for x in _leaves(tree)]
    for x in leaves:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=sc.group)
    return _unflatten(tree, leaves)


def slice_stack_specs(plan, sides: str = 'both') -> dict:
    """Shape-only stacks (``meta`` tensors) of what ``sharded_refresh``
    exchanges for a dense-factor method: per bucket an (N·lead, d_in, d_in)
    f32 inverse, and the (N·lead, d_out, d_out) one for ``sides='both'``.
    The slice flattening of ``schedule/runtime.py`` lives here once."""
    from repro_torch.schedule.ownership import lead_size

    if sides not in ('left', 'both'):
        raise ValueError(f"sides must be 'left' or 'both', got {sides!r}")
    out = {}
    for b in plan.buckets:
        s = len(b.paths) * lead_size(b)
        d_in, d_out = b.shape[-2], b.shape[-1]
        specs = (torch.empty((s, d_in, d_in), dtype=F32_DT, device='meta'),)
        if sides == 'both':
            specs += (torch.empty((s, d_out, d_out), dtype=F32_DT,
                                  device='meta'),)
        out[b.key] = specs
    return out
