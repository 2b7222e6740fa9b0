"""Gradient-transformation algebra with a side-channel — PyTorch port.

Counterpart of ``repro/core/transform.py``.  A transform is a pair of plain
functions ``(init, update)``; trees are flat dicts of tensors keyed by the
reference's ``'fc0/w'`` paths, and states are ``NamedTuple``s whose fields
mirror the reference's.  Updates return new tensors and leave their inputs
as they were, as the reference's pure functions do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

F32 = torch.float32


# ---------------------------------------------------------------------------
# Types


@dataclasses.dataclass(frozen=True)
class Extras:
    """Side-channel values available to every transform in a chain.

    raw_grads: the gradients before any transform; stats: captured KV
    statistics ({path: kv.LayerStats}); loss; step (filled in by ``chain``);
    plan: the ``bucketing.BucketPlan`` built at ``init_opt_state`` time;
    sched: the ``schedule.runtime.RefreshRuntime``; comm: the
    ``comm.exchange.ExchangeConfig`` (the statistics and refresh codecs,
    'gather' or 'psum'); factor: the
    ``core.factor_sharded.FactorShardConfig`` (or its kwargs) — what to do
    with oversized Kronecker factors; None keeps every factor dense.
    """

    raw_grads: Any = None
    stats: Any = None
    loss: Any = None
    step: Any = None
    plan: Any = None
    sched: Any = None
    comm: Any = None
    factor: Any = None


class GradientTransformation(NamedTuple):
    init: Callable[..., Any]       # (params, extras=None) -> state
    update: Callable[..., tuple]   # (updates, state, params, extras)


class EmptyState(NamedTuple):
    pass


def _unit_init(params, extras=None):
    del params, extras
    return EmptyState()


def stateless(fn: Callable[[Any, Any, Extras], Any]) -> GradientTransformation:
    """A stateless transform from ``fn(updates, params, extras)``."""

    def update(updates, state, params=None, extras: Optional[Extras] = None):
        return fn(updates, params, extras), state

    return GradientTransformation(_unit_init, update)


# ---------------------------------------------------------------------------
# Tree utilities (dicts, NamedTuples, tuples; None is an empty subtree)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, '_fields')


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of ``tree`` and its twins."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, prefix: str = '') -> dict[str, Any]:
    """{'/'-joined path: leaf}: NamedTuple fields by name, tuple entries by
    index, dict entries by key; None subtrees vanish."""
    out: dict[str, Any] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    for k, v in items:
        out.update(tree_leaves_with_path(v, f'{prefix}/{k}' if prefix
                                         else str(k)))
    return out


def key_order(k):
    """A dict key's place in the reference's leaf order: jax sorts a nested
    dict's keys level by level, which for the port's '/'-joined paths is
    the order of their '/'-split segments."""
    return tuple(k.split('/')) if isinstance(k, str) else (k,)


def tree_leaves(tree) -> list:
    """The tensor leaves in the reference's ``jax.tree_util.tree_leaves``
    order: dict keys sorted (a '/'-joined path as its nested dicts would
    sort), NamedTuple fields and sequence entries in order; None subtrees
    vanish."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=key_order)
                for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_scale(tree, s):
    """Each leaf times ``s`` in f32, back in the leaf's dtype."""
    return tree_map(lambda x: (x.to(F32) * s).to(x.dtype), tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=dtype or x.dtype,
                                          device=x.device), tree)


def tree_device(tree) -> torch.device:
    """The device of the first tensor leaf."""
    return next(iter(tree_leaves_with_path(tree).values())).device


def tree_vdot(a, b) -> torch.Tensor:
    """Global inner product ⟨a, b⟩ over two trees, in f32, summed over the
    sorted leaf paths (the reference's leaf order)."""
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    total = torch.zeros((), dtype=F32, device=tree_device(a))
    for k in sorted(la):
        total = total + (la[k].to(F32) * lb[k].to(F32)).sum()
    return total


def tree_norm_sq(a) -> torch.Tensor:
    return tree_vdot(a, a)


def scalar(value, device, dtype=F32) -> torch.Tensor:
    """A 0-d tensor made on ``device`` by a fill kernel: no host copy, so
    nothing waits on the card."""
    return torch.full((), value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Chain


class ChainState(NamedTuple):
    step: torch.Tensor
    inner: tuple


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Compose transforms left to right with a shared int32 step counter.

    ``Extras`` gains ``raw_grads`` (the incoming updates) and ``step``
    before the first transform runs."""

    def init(params, extras: Optional[Extras] = None):
        inner = tuple(t.init(params, extras) for t in transforms)
        return ChainState(step=scalar(0, tree_device(params), torch.int32),
                          inner=inner)

    def update(updates, state: ChainState, params=None,
               extras: Optional[Extras] = None):
        extras = extras or Extras()
        extras = dataclasses.replace(extras, raw_grads=updates,
                                     step=state.step)
        new_inner = []
        for t, s in zip(transforms, state.inner):
            updates, s = t.update(updates, s, params=params, extras=extras)
            new_inner.append(s)
        return updates, ChainState(step=state.step + 1, inner=tuple(new_inner))

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """``w <- w + Δw`` preserving dtypes (master math in f32)."""
    return tree_map(lambda p, u: (p.to(F32) + u.to(F32)).to(p.dtype),
                    params, updates)


# ---------------------------------------------------------------------------
# First-order building blocks


class TraceState(NamedTuple):
    trace: Any


def trace(momentum: float = 0.9, nesterov: bool = False,
          dampening: float = 0.0,
          bias_correction: bool = False) -> GradientTransformation:
    """Heavy-ball momentum, m <- μ·m + (1−dampening)·g; with
    ``dampening=momentum`` and ``bias_correction`` the EMA form
    m̂ = (μ·m + (1−μ)·g) / (1−μ^(t+1)) (see the reference's docstring)."""

    def init(params, extras=None):
        return TraceState(trace=tree_map(torch.zeros_like, params))

    def update(updates, state, params=None, extras=None):
        del params
        gain = 1.0 - dampening
        new_trace = tree_map(lambda m, g: momentum * m.to(F32)
                             + gain * g.to(F32), state.trace, updates)
        out = new_trace
        if bias_correction and momentum:
            step = extras.step.to(F32)
            corr = 1.0 - scalar(momentum, step.device) ** (step + 1.0)
            out = tree_map(lambda m: m / corr, new_trace)
        if nesterov:
            out = tree_map(lambda g, m: gain * g.to(F32) + momentum * m,
                           updates, out)
        stored = tree_map(lambda m, old: m.to(old.dtype), new_trace,
                          state.trace)
        return out, TraceState(trace=stored)

    return GradientTransformation(init, update)


def ema_trace(momentum: float = 0.9,
              nesterov: bool = False) -> GradientTransformation:
    """Bias-corrected EMA momentum (see ``trace``)."""
    return trace(momentum, nesterov=nesterov, dampening=momentum,
                 bias_correction=True)


def scale(factor) -> GradientTransformation:
    return stateless(lambda u, p, e: tree_map(lambda x: x * factor, u))


class ScheduleState(NamedTuple):
    pass


def scale_by_schedule(schedule: Callable, negate: bool = True
                      ) -> GradientTransformation:
    """Multiply updates by ``-schedule(step)`` (learning-rate schedule)."""

    def update(updates, state, params=None, extras: Optional[Extras] = None):
        lr = schedule(extras.step if extras is not None else 0)
        s = -lr if negate else lr
        return tree_map(lambda x: x * s, updates), state

    return GradientTransformation(_unit_init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def fn(updates, params, extras):
        if weight_decay == 0.0 or params is None:
            return updates
        return tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                        updates, params)

    return stateless(fn)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def fn(updates, params, extras):
        gn = torch.sqrt(tree_norm_sq(updates) + 1e-16)
        s = torch.clamp(torch.full_like(gn, max_norm) / gn, max=1.0)
        return tree_map(lambda x: x * s, updates)

    return stateless(fn)


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """Adam's bias-corrected m̂ / (√v̂ + ε), the moments in f32."""

    def init(params, extras=None):
        def z():
            return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                  device=p.device), params)
        return AdamState(mu=z(), nu=z(),
                         count=scalar(0, tree_device(params), torch.int32))

    def update(updates, state, params=None, extras=None):
        del params, extras
        count = state.count + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(F32), state.mu,
                      updates)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.to(F32).square(),
                      state.nu, updates)
        c = count.to(F32)
        s_mu = 1.0 / (1 - scalar(b1, c.device) ** c)
        s_nu = 1.0 / (1 - scalar(b2, c.device) ** c)
        out = tree_map(lambda m, v: (m * s_mu) / (torch.sqrt(v * s_nu) + eps),
                       mu, nu)
        return out, AdamState(mu=mu, nu=nu, count=count)

    return GradientTransformation(init, update)


class AdagradState(NamedTuple):
    accum: Any


def scale_by_adagrad(eps: float = 1e-10, initial_accum: float = 0.1
                     ) -> GradientTransformation:
    """g / (√(Σ g²) + ε), the sum starting at ``initial_accum``."""

    def init(params, extras=None):
        return AdagradState(accum=tree_map(
            lambda p: torch.full(p.shape, initial_accum, dtype=F32,
                                 device=p.device), params))

    def update(updates, state, params=None, extras=None):
        del params, extras
        accum = tree_map(lambda a, g: a + g.to(F32).square(), state.accum,
                         updates)
        out = tree_map(lambda g, a: g.to(F32) / (torch.sqrt(a) + eps),
                       updates, accum)
        return out, AdagradState(accum=accum)

    return GradientTransformation(init, update)
