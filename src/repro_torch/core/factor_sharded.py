"""Matrix-free application of oversized Kronecker factors — PyTorch port of
``repro/core/factor_sharded.py``.

A K-FAC or Shampoo factor side whose dim reaches ``shard_threshold`` is
never inverted: its damped inverse (or inverse 4th root) is applied to the
gradient by an iterative solve whose one primitive is ``Y @ M``.  That
product splits over contiguous row bands of the symmetric factor
(``schedule.ownership.factor_block``): each worker contracts its own columns
of ``Y`` with its band, a full-width partial that one sum over the workers
completes (``comm.exchange.psum_partials``).  The band partial runs through
the ``matvec_cols`` Hopper kernel (``kernels/csrc/matvec_cols.cu``).

Per-factor policy, threaded through ``Extras.factor``:

  'dense'    — the legacy path, bit for bit (the module does nothing).
  'exclude'  — the oversized side becomes the identity; the other side keeps
               plain-γ damping (π-split damping needs both factors).
  'shard'    — matrix-free: band matvecs + one sum per solve iteration.

Solvers: 'binomial' — the generalized binomial series for (M+γI)^{-p} after
a Gershgorin rescale, any p > 0 (K-FAC p=1, Shampoo p=1/4); 'cg' —
conjugate gradients, p=1 only.  Sides below the threshold keep a dense
cached operator, recomputed under the same refresh schedule.

Differences from the reference: ``FactorShardConfig.use_pallas`` is
``impl`` ('auto' | 'cuda' | 'torch', ``kernels/dispatch.py``), and the band
partial goes through the kernel whenever ``impl`` resolves to 'cuda', one
worker included (the reference takes its einsum there).  W and the rank
come from the data group in scope (``ownership.world_and_rank``): each of W
workers contracts only its own ``ceil(d/W)``-row band and the f32 sum over
the group completes the product; outside a scope one worker holds the
whole factor and the sum is the identity.  ``_band`` and
``_matvec_partial`` take ``world`` and ``rank`` as plain ints, so every band
of a W-way split can also be evaluated on one device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.comm import exchange
from repro_torch.core import bucketing
from repro_torch.core import precondition as pre
from repro_torch.core.transform import scalar, tree_map
from repro_torch.kernels import dispatch
from repro_torch.schedule import ownership

F32 = torch.float32
POLICIES = ('dense', 'exclude', 'shard')
SOLVERS = ('binomial', 'cg')


@dataclasses.dataclass(frozen=True)
class FactorShardConfig:
    """Per-factor execution policy for oversized Kronecker factors.

    head_policy: what to do with a factor side whose dim reaches
      ``shard_threshold`` — 'dense' (default), 'exclude' or 'shard'.
    shard_threshold: factor dim at or above which a side trips
      (``ownership.subslice_trips``); the default targets vocab-scale heads.
    solver / solve_iters: the iterative scheme of 'shard' ('cg' for power
      −1 only; Shampoo's −1/4 root always takes the binomial series).
    impl: the band partial's kernel impl, 'auto' | 'cuda' | 'torch'.
    """
    head_policy: str = 'dense'
    shard_threshold: int = 65536
    solver: str = 'cg'
    solve_iters: int = 32
    impl: str = 'auto'

    def __post_init__(self):
        if self.head_policy not in POLICIES:
            raise ValueError(f'head_policy must be one of {POLICIES}, '
                             f'got {self.head_policy!r}')
        if self.solver not in SOLVERS:
            raise ValueError(f'solver must be one of {SOLVERS}, '
                             f'got {self.solver!r}')
        if self.shard_threshold < 2:
            raise ValueError('shard_threshold must be >= 2')
        if self.solve_iters < 1:
            raise ValueError('solve_iters must be >= 1')
        if self.impl not in dispatch.IMPLS:
            raise ValueError(f'impl must be one of {dispatch.IMPLS}, '
                             f'got {self.impl!r}')


def from_extras(extras) -> FactorShardConfig:
    """The policy threaded through ``Extras.factor`` (a FactorShardConfig or
    its kwargs); the default keeps every factor dense."""
    f = getattr(extras, 'factor', None) if extras is not None else None
    if f is None:
        return FactorShardConfig()
    if isinstance(f, FactorShardConfig):
        return f
    return FactorShardConfig(**dict(f))


# ---------------------------------------------------------------------------
# Plan split: which buckets leave the dense refresh path


@functools.lru_cache(maxsize=256)
def _split_cached(plan: bucketing.BucketPlan, policy: str, threshold: int):
    head: dict[str, tuple[str, str]] = {}
    dense = []
    for b in plan.buckets:
        t_in, t_out = ownership.subslice_trips(b, threshold)
        if policy != 'dense' and (t_in or t_out):
            head[b.key] = (policy if t_in else 'dense',
                           policy if t_out else 'dense')
        else:
            dense.append(b)
    if not head:
        # the original plan object: callers take the legacy path unchanged
        return plan, head
    return bucketing.BucketPlan(buckets=tuple(dense)), head


def split_plan(plan: bucketing.BucketPlan, cfg: FactorShardConfig):
    """(dense_plan, {bucket_key: (in_policy, out_policy)}).

    Buckets with a tripped side leave the dense plan; a side below the
    threshold inside such a bucket stays 'dense'.  When nothing trips (or
    head_policy='dense') the original plan object comes back with an empty
    policy map."""
    return _split_cached(plan, cfg.head_policy, int(cfg.shard_threshold))


# ---------------------------------------------------------------------------
# The band matvec: the one primitive of the matrix-free path


def _band(m: torch.Tensor, world: int, rank: Optional[int]) -> torch.Tensor:
    """Worker ``rank``'s contiguous row band of factor ``m`` (..., d, d) ->
    (..., B, d), B = ceil(d/world); rows past d are zeros, so the band
    partials sum to the whole product."""
    if world <= 1 or rank is None:
        return m
    d = m.shape[-2]
    blk = ownership.factor_block(d, world)
    pad = world * blk - d
    if pad:
        m = torch.nn.functional.pad(m, (0, 0, 0, pad))
    return m[..., rank * blk:(rank + 1) * blk, :].contiguous()


def _matvec_partial(band: torch.Tensor, y: torch.Tensor, world: int,
                    rank: Optional[int], impl: str = 'auto') -> torch.Tensor:
    """Partial of ``y @ M`` from one row band (M symmetric, so the row band
    is the transposed column block): contracts only the band's columns of
    ``y`` and returns a full-width (..., R, d) partial.  Through the
    ``matvec_cols`` kernel when ``impl`` resolves to 'cuda', else the plain
    einsum; leading dims beyond one stack axis fold into it."""
    if world > 1 and rank is not None:
        blk = band.shape[-2]
        pad = world * blk - y.shape[-1]
        if pad:
            y = torch.nn.functional.pad(y, (0, pad))
        y = y[..., rank * blk:(rank + 1) * blk]
    band, y = band.contiguous(), y.contiguous()
    if band.dim() == 2:
        return dispatch.matvec_cols(band, y, impl=impl)
    lead = tuple(band.shape[:-2])
    out = dispatch.matvec_cols_stacked(
        band.reshape((-1,) + tuple(band.shape[-2:])),
        y.reshape((-1,) + tuple(y.shape[-2:])), impl=impl)
    return out.reshape(lead + tuple(out.shape[-2:]))


# ---------------------------------------------------------------------------
# Iterative damped-inverse application:  Y (M + γI)^{-power}


@functools.lru_cache(maxsize=64)
def _binomial_coeffs(power: float, iters: int) -> tuple[float, ...]:
    """Series coefficients of (1-x)^{-power} = Σ a_k x^k, a_0 = 1,
    a_{k+1} = a_k (k + power) / (k + 1), each rounded to f32 as the
    reference's f32 scan operand."""
    a = [1.0]
    for k in range(iters):
        a.append(a[-1] * (k + power) / (k + 1))
    return tuple(float(v) for v in torch.tensor(a, dtype=F32))


def solve_damped_power(m: torch.Tensor, y: torch.Tensor, gamma,
                       power: float, *, cfg: FactorShardConfig, world: int,
                       rank: Optional[int],
                       site: Optional[str] = None) -> torch.Tensor:
    """Matrix-free ``Y (M + γI)^{-power}`` for PSD ``m`` (..., d, d) and
    ``y`` (..., R, d); ``gamma`` broadcasts over the leading dims.

    'binomial': the Gershgorin-rescaled generalized binomial series, any
    power > 0, converging as (1 - γ/c)^k with c = max_j Σ_i |M_ij| + γ.
    'cg': conjugate gradients on the SPD system, power 1 only (other powers
    take the series).  Both run ``cfg.solve_iters`` iterations with no
    early exit, and every step stays on the device.  ``site`` labels the
    partial sums' byte record (one whole solve a call, as the
    reference's)."""
    m = m.to(F32)
    y = y.to(F32).contiguous()
    gam = torch.as_tensor(gamma, dtype=F32, device=y.device)
    band = _band(m, world, rank)
    iters = int(cfg.solve_iters)
    extra = {'solve_iters': iters,
             'factor_shard_bytes': int(band.numel() * 4)}
    recorded = []

    def mv(v):
        # the byte record fires once a solve, as the reference's once a
        # trace of its scan body
        part = _matvec_partial(band, v, world, rank, impl=cfg.impl)
        out = exchange.psum_partials(part, world,
                                     site=None if recorded else site,
                                     calls=iters, extra=extra)
        recorded.append(True)
        return out

    if cfg.solver == 'cg' and power == 1.0:
        # CG on (M + γI) xᵀ = yᵀ over the R rows of y at once: each row is
        # its own right-hand side, with its own α and β
        def dot(u, v):
            return (u * v).sum(-1)

        x = torch.zeros_like(y)
        r = p = y
        rs = dot(r, r)
        for _ in range(iters):
            ap = mv(p) + gam[..., None, None] * p
            denom = dot(p, ap)
            alpha = torch.where(denom > 0,
                                rs / torch.clamp(denom, min=1e-30), 0.0)
            x = x + alpha[..., None] * p
            r = r - alpha[..., None] * ap
            rs_new = dot(r, r)
            beta = torch.where(rs > 0, rs_new / torch.clamp(rs, min=1e-30),
                               0.0)
            p = r + beta[..., None] * p
            rs = rs_new
        return x

    # Generalized binomial series.  c >= λmax(M) + γ by the Gershgorin
    # column bound, itself summed from the band partials.
    col = exchange.psum_partials(band.abs().sum(-2), world, site=None)
    c = col.amax(-1) + gam
    coeffs = _binomial_coeffs(float(power), iters)
    v, acc = y, coeffs[0] * y
    for a_k in coeffs[1:]:
        # V ← V T with T = I − (M + γI)/c, spectral radius < 1
        v = v - (mv(v) + gam[..., None, None] * v) / c[..., None, None]
        acc = acc + a_k * v
    return acc * (c ** (-float(power)))[..., None, None]


# ---------------------------------------------------------------------------
# Head state: cached dense-side operators + refresh-time dampings


class HeadState(NamedTuple):
    """Sharded-factor bucket state.  ``buckets`` maps bucket key ->
    {'inv_in', 'inv_out' (the cached dense-side operator, or () for an
    excluded or sharded side), 'gam_in', 'gam_out' (refresh-time dampings:
    the sharded side solves against the live factor EMA with the damping
    of the last refresh)}.  The two scalars are telemetry."""
    buckets: dict
    solve_iters: torch.Tensor    # () int32
    shard_bytes: torch.Tensor    # () f32 — per-step partial-sum bytes


def _plain_gamma(m: torch.Tensor, gamma) -> torch.Tensor:
    return torch.full(tuple(m.shape[:-2]), gamma, dtype=F32, device=m.device)


def _entry_shapes(policies: tuple[str, str], m_in, m_out, gamma, dense_op,
           method: str) -> dict:
    p_in, p_out = policies
    if method == 'kfac' and 'exclude' not in policies:
        gam_in, gam_out = pre.kfac_pi_damping(m_in, m_out, gamma)
    else:
        # identity on one side makes the π split meaningless (and Shampoo
        # never splits): plain γ on the sides that remain
        gam_in, gam_out = _plain_gamma(m_in, gamma), _plain_gamma(m_out,
                                                                  gamma)
    return {
        'inv_in': dense_op(m_in, gam_in) if p_in == 'dense' else (),
        'inv_out': dense_op(m_out, gam_out) if p_out == 'dense' else (),
        'gam_in': gam_in, 'gam_out': gam_out,
    }


def _dense_op(method: str):
    if method == 'kfac':
        return pre._damped_inv
    # the (batch,) damping adds to the (batch, d) eigenvalues
    return lambda m, gam: pre._inv_proot_psd(m.to(F32), gam[..., None], 0.25)


def shard_psum_bytes(plan: bucketing.BucketPlan, policies: dict,
                     cfg: FactorShardConfig) -> float:
    """Per-step f32 partial-sum bytes of one worker: ``solve_iters``
    gradient-shaped sums per sharded side of every head bucket."""
    total = 0.0
    for b in plan.buckets:
        pol = policies.get(b.key)
        if pol is None:
            continue
        n = len(b.paths) * ownership.lead_size(b)
        elems = n * int(b.shape[-2]) * int(b.shape[-1])
        total += sum(4.0 * elems * cfg.solve_iters for p in pol
                     if p == 'shard')
    return total


def init_head(stats: dict, policies: dict, cfg: FactorShardConfig,
              plan: bucketing.BucketPlan) -> Optional[HeadState]:
    """Zeros shaped as ``refresh_head``'s result; None when no bucket
    tripped, so the state keeps the legacy layout."""
    if not policies:
        return None
    buckets = {}
    dev = None
    for k, (p_in, p_out) in policies.items():
        m_in, m_out = stats[k]
        dev = m_in.device
        batch = tuple(m_in.shape[:-2])
        buckets[k] = {
            'inv_in': (torch.zeros(m_in.shape, dtype=F32, device=dev)
                       if p_in == 'dense' else ()),
            'inv_out': (torch.zeros(m_out.shape, dtype=F32, device=dev)
                        if p_out == 'dense' else ()),
            'gam_in': torch.zeros(batch, dtype=F32, device=dev),
            'gam_out': torch.zeros(batch, dtype=F32, device=dev),
        }
    sharded = any(p == 'shard' for pol in policies.values() for p in pol)
    return HeadState(
        buckets=buckets,
        solve_iters=scalar(cfg.solve_iters if sharded else 0, dev,
                           torch.int32),
        shard_bytes=scalar(shard_psum_bytes(plan, policies, cfg), dev))


def refresh_head(refresh: bool, stats: dict,
                 head: Optional[HeadState], policies: dict, gamma: float, *,
                 method: str) -> Optional[HeadState]:
    """Recompute the head buckets' dense-side operators and dampings under
    the refresh decision on the host, as ``schedule.runtime.
    sharded_refresh``: a step that keeps the old values computes nothing
    and returns ``head`` as it is.  ``stats``: {bucket_key: (m_in, m_out)}
    live factor EMAs."""
    if not policies:
        return None
    if not refresh:
        return head
    dense_op = _dense_op(method)
    buckets = {k: _entry_shapes(policies[k], stats[k][0], stats[k][1], gamma,
                                dense_op, method)
               for k in policies}
    return HeadState(buckets=buckets, solve_iters=head.solve_iters,
                     shard_bytes=head.shard_bytes)


# ---------------------------------------------------------------------------
# Apply: the per-step matrix-free preconditioning of head buckets


def _apply_one(g: torch.Tensor, entry: dict, policies: tuple[str, str],
               m_in: torch.Tensor, m_out: torch.Tensor, *, power: float,
               cfg: FactorShardConfig, world: int,
               rank: Optional[int], site: Optional[str]) -> torch.Tensor:
    p_in, p_out = policies
    g32 = g.to(F32)
    kw = dict(cfg=cfg, world=world, rank=rank, site=site)
    if p_in == 'dense':
        g32 = entry['inv_in'] @ g32
    elif p_in == 'shard':
        gt = solve_damped_power(m_in, g32.transpose(-1, -2), entry['gam_in'],
                                power, **kw)
        g32 = gt.transpose(-1, -2)
    # 'exclude': the identity
    if p_out == 'dense':
        g32 = g32 @ entry['inv_out']
    elif p_out == 'shard':
        g32 = solve_damped_power(m_out, g32, entry['gam_out'], power, **kw)
    return g32.to(g.dtype)


def apply_tree(flat: dict, plan: bucketing.BucketPlan, policies: dict,
               head: HeadState, factors: dict, *, power: float,
               cfg: FactorShardConfig, site: Optional[str] = None) -> dict:
    """Precondition the head buckets of ``flat`` ({path: grad}) in place of
    the dense cached-operator path.  ``factors``: {bucket_key: (m_in,
    m_out)} live EMAs, bucket-stacked.  One vectorized apply per stacked
    bucket; the paths of a small bucket one at a time.  ``site``: the
    label of the partial sums' byte record."""
    if not policies:
        return flat
    world, rank = ownership.world_and_rank()
    out = dict(flat)
    kw = dict(power=power, cfg=cfg, world=world, rank=rank, site=site)
    for b in plan.buckets:
        if b.key not in policies:
            continue
        entry = head.buckets[b.key]
        m_in, m_out = factors[b.key]
        if b.stacked:
            g = torch.stack([flat[p] for p in b.paths])
            res = _apply_one(g, entry, policies[b.key], m_in, m_out, **kw)
            for i, p in enumerate(b.paths):
                out[p] = res[i]
        else:
            for i, p in enumerate(b.paths):
                e_i = tree_map(lambda x, i=i: x[i], entry)
                out[p] = _apply_one(flat[p], e_i, policies[b.key], m_in[i],
                                    m_out[i], **kw)
    return out


# ---------------------------------------------------------------------------
# Step metrics


METRIC_FIELDS = {
    'factor_solve_iters': ('int', 'iterations of one sharded-factor solve'),
    'factor_shard_bytes': ('num', 'per-step sharded-factor partial-psum B'),
}


def head_states(opt_state) -> list[HeadState]:
    """Every HeadState in an optimizer state tree (chains nest states in
    tuples and dicts)."""
    found = []

    def walk(x):
        if isinstance(x, HeadState):
            found.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(opt_state)
    return found


def step_metrics(opt_state) -> dict:
    """{declared field: 0-d tensor} for the step's metrics; empty when no
    factor is sharded."""
    out = {}
    for hs in head_states(opt_state):
        out['factor_solve_iters'] = hs.solve_iters
        out['factor_shard_bytes'] = hs.shard_bytes
    return out
