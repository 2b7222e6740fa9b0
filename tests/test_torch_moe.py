"""The MoE layer of the port against the reference on the same inputs:
``capacity``; ``route``'s slot tables, equal as integers, with overflow
drops at capacity factor 1.0; ``kv.fwd_stats_masked``; ``moe_apply``'s
output and aux loss with their gradients; a MoE ``TransformerLM``'s loss,
gradients and per-expert stats, with and without a shared expert; and the
reduced qwen3-moe forward with bfloat16 parameters, computing in f32 and
in bf16.

The reference's slot tables come from its own ``moe_apply``: the test
records what the first ``jax.vmap`` there (the per-group ``route``)
returns, on one device one group.

Both sides compute in f32 on the CPU and sum in other orders, but for
``test_bf16_compute_forward``.  Stated tolerances: slot tables and counts
exact; outputs, stats, gradients and the f32-compute logits within 1e-5 of
each leaf's largest magnitude (``_close_rel``); bf16-compute logits and
router probabilities within BF16_LOGITS_REL and BF16_PROB_TOL, set from
the gaps measured there.

The gather-form dispatch and combine (``moe.gather_rows``, the path of
plain tensors) against the advanced-index gathers (the DTensor path) on
the same plain CPU tensors: forward, the combine's gradient, every weight's
and tap's gradient equal bit for bit; the token gradient, summed in another
order, within TOKEN_GRAD_ULPS of the dtype's epsilon a term, of its largest
magnitude; ``gather_rows``' backward under ``torch.autograd.gradcheck`` in
f64.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.core import kv  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.sharding import compat  # noqa: E402
from test_torch_lm_modules import _close_rel, _np_tree, _t  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

D, FF, E = 16, 24, 4
# bf16 compute: twice and three times the gaps measured (see
# test_bf16_compute_forward)
BF16_LOGITS_REL, BF16_PROB_TOL = 1.5e-2, 1e-2
# the token gradient: top_k terms summed in another order (and, in bf16,
# in f32 and rounded once, where the advanced-index backward may round
# each add): at most this many epsilons of the dtype a term, of its
# largest magnitude
TOKEN_GRAD_ULPS = 1.0


def test_capacity():
    for n, k, e, f in [(32, 2, 4, 1.25), (1, 1, 8, 1.0), (4096, 8, 128, 1.25),
                       (4096, 8, 128, 16.0), (100, 3, 7, 0.5)]:
        assert moe.capacity(n, k, e, f) == jmoe.capacity(n, k, e, f)
    assert moe.capacity(4096, 8, 128, 1.25) == 320
    assert moe.capacity(2, 8, 128, 16.0) == 8


class _RouteSpy:
    """Stands in for ``jax`` inside the reference's moe module: records
    the outputs of each vmapped function (the first is ``route``)."""

    def __init__(self):
        self.outs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *args, **kw):
        mapped = jax.vmap(fn, *args, **kw)

        def call(*a):
            out = mapped(*a)
            self.outs.append(out)
            return out
        return call


def _moe_case(rng, skew=0.0):
    spec = jmoe.moe_spec(D, FF, E)
    jp = _np_tree(spec, rng, scale=0.3)
    x = rng.standard_normal((2, 12, D)).astype(np.float32)
    # a skewed router sends every token to expert 0, past its capacity
    jp['router']['w'][:, 0] += skew
    x += np.float32(skew)
    return jp, x


@pytest.mark.parametrize('factor', [1.0, 1.25, 4.0])
def test_route_slot_tables(monkeypatch, factor):
    rng = np.random.default_rng(0)
    jp, x = _moe_case(rng, skew=1.0 if factor == 1.0 else 0.0)
    spy = _RouteSpy()
    monkeypatch.setattr(jmoe, 'jax', spy)
    jmoe.moe_apply(jp, jnp.asarray(x), top_k=2, capacity_factor=factor)
    slot_token, slot_mask, flat_slot, ok = (np.asarray(o)[0]
                                            for o in spy.outs[0])
    logits = jnp.asarray(x).reshape(-1, D) @ jp['router']['w']
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    cap = moe.capacity(24, 2, E, factor)
    got = moe.route(_t(np.asarray(ids)).reshape(-1), E, 2, cap)
    for name, g, w in zip(('slot_token', 'slot_mask', 'flat_slot', 'ok'),
                          got, (slot_token, slot_mask, flat_slot, ok)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if factor == 1.0:
        assert not ok.all(), 'the skewed router should overflow expert 0'
    assert int((~got[3]).sum()) == int(48 - slot_mask.sum())


@pytest.mark.parametrize('kind', ['mean', 'outer'])
def test_fwd_stats_masked(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((E, 8, D)).astype(np.float32)
    mask = (rng.random((E, 8)) < 0.6).astype(np.float32)
    mask[2] = 0.0                                    # an idle expert
    cap_j, cap_t = jkv.CaptureConfig(kind, None), kv.CaptureConfig(kind, None)
    want = jkv.fwd_stats_masked(jnp.asarray(x), jnp.asarray(mask), cap_j)
    got = kv.fwd_stats_masked(_t(x), _t(mask), cap_t)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    _close_rel(got.a_mean, want.a_mean, 'a_mean')
    assert not got.a_mean[2].any()
    if kind == 'outer':
        _close_rel(got.a_outer, want.a_outer, 'a_outer')
    else:
        assert got.a_outer is None and want.a_outer is None
    assert kv.fwd_stats_masked(_t(x), _t(mask), None) == kv.LayerStats()


@pytest.mark.parametrize('factor', [1.0, 1.25])
def test_moe_apply_values_and_gradients(factor):
    """Output, aux, stats of the router and the three expert weights, and
    the gradients of a loss of both with respect to x, every weight and
    every tap."""
    rng = np.random.default_rng(2)
    jp, x = _moe_case(rng, skew=1.0 if factor == 1.0 else 0.0)
    d_out = {'router': E, 'gate': FF, 'up': FF, 'down': D}
    taps = {f'moe/{n}/w': np.zeros((d,) if n == 'router' else (E, d),
                                   np.float32) for n, d in d_out.items()}
    kw = dict(top_k=2, capacity_factor=factor, aux_coef=1e-2, path='moe')

    def jloss(args):
        p, t, xx = args
        col = {}
        y, aux = jmoe.moe_apply(p, xx, col=col, taps=t,
                                capture=jkv.EVA_CAPTURE, **kw)
        return jnp.sum(jnp.sin(y)) + 10 * aux, (y, aux, col)
    args = (jax.tree_util.tree_map(jnp.asarray, jp),
            {k: jnp.asarray(v) for k, v in taps.items()}, jnp.asarray(x))
    (_, (jy, jaux, jcol)), (jgp, jgt, jgx) = jax.value_and_grad(
        jloss, has_aux=True)(args)

    tp = {k: v.requires_grad_(True) for k, v in
          M.add_prefix(M.params_from_numpy(jp, 'cpu'), 'moe').items()}
    tt = {k: _t(v).requires_grad_(True) for k, v in taps.items()}
    tx = _t(x).requires_grad_(True)
    col = {}
    y, aux = moe.moe_apply(tp, tx, col=col, taps=tt, capture=kv.EVA_CAPTURE,
                           **kw)
    grads = torch.autograd.grad(torch.sin(y).sum() + 10 * aux,
                                [tx, *tp.values(), *tt.values()])
    _close_rel(y, jy, 'out')
    _close_rel(aux, jaux, 'aux')
    _close_rel(grads[0], jgx, 'grad x')
    jflat = jkv.flatten_params(jgp)
    for k, g in zip(tp, grads[1:1 + len(tp)]):
        _close_rel(g, jflat[k[len('moe/'):]], f'grad {k}')
    for k, g in zip(tt, grads[1 + len(tp):]):
        _close_rel(g, jgt[k], f'tap grad {k}')
    assert set(col) == set(jcol) == set(taps)
    for k in taps:
        _close_rel(col[k].a_mean, jcol[k].a_mean, f'{k} a_mean')
        np.testing.assert_array_equal(col[k].count.numpy(),
                                      np.asarray(jcol[k].count))


@pytest.mark.parametrize('shared', [0, 1], ids=['no_shared', 'shared'])
def test_moe_lm_loss_gradients_and_stats(shared):
    """A MoE TransformerLM (qwen3-moe's reduced config; with a shared
    expert, kimi-k2's block): loss with the aux summed over layers, the
    gradients, the tap gradients and the per-expert stats stacked over the
    layers, (layers, experts, d_in)."""
    arch = 'kimi-k2-1t-a32b' if shared else 'qwen3-moe-30b-a3b'
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    assert jcfg.n_shared_experts == tcfg.n_shared_experts == shared
    jm, tm = jbuild(jcfg), build_model(tcfg)
    assert tm.precon_paths() == jm.precon_paths()
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jtaps = jkv.make_vector_taps(jp, jm.precon_paths())

    def jloss(p, t):
        loss, aux = jm.loss_fn(p, t, {'tokens': jnp.asarray(toks),
                                      'labels': jnp.asarray(labels)},
                               jkv.EVA_CAPTURE)
        return loss, aux['stats']
    (jl, jst), (jg, jtg) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(jp, jtaps)
    tp = {k: v.requires_grad_(True)
          for k, v in M.params_from_numpy(jp, 'cpu').items()}
    tt = {k: torch.zeros(v.shape, requires_grad=True)
          for k, v in jtaps.items()}
    loss, aux = tm.loss_fn(tp, tt, {'tokens': _t(toks), 'labels': _t(labels)},
                           kv.EVA_CAPTURE)
    grads = torch.autograd.grad(loss, [*tp.values(), *tt.values()])
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    jflat = jkv.flatten_params(jg)
    for k, g in zip(tp, grads[:len(tp)]):
        _close_rel(g, jflat[k], f'grad {k}')
    for k, g in zip(tt, grads[len(tp):]):
        _close_rel(g, jtg[k], f'tap grad {k}')
    assert set(aux['stats']) == set(jst)
    for k, st in jst.items():
        _close_rel(aux['stats'][k].a_mean, st.a_mean, f'{k} a_mean')
        np.testing.assert_array_equal(aux['stats'][k].count.numpy(),
                                      np.asarray(st.count), err_msg=k)
    assert aux['stats']['blocks/moe/gate/w'].a_mean.shape == \
        (tcfg.n_layers, tcfg.n_experts, tcfg.d_model)


class _Delegate:
    """Stands in for a module: ``over``'s names, and the module's own for
    the rest."""

    def __init__(self, base, **over):
        self._base = base
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._base, name)


def record_topk(monkeypatch):
    """From now on, each ``lax.top_k`` of the reference's moe module (one
    a MoE layer and call, under jit too) appends (probs, ids) to the list
    returned."""
    calls = []

    def keep(p, i):
        calls.append((np.asarray(p), np.asarray(i)))

    def top_k(probs, k):
        vals, ids = jax.lax.top_k(probs, k)
        jax.debug.callback(keep, probs, ids, ordered=True)
        return vals, ids
    monkeypatch.setattr(jmoe, 'jax',
                        _Delegate(jax, lax=_Delegate(jax.lax, top_k=top_k)))
    return calls


def replay_topk(monkeypatch, calls):
    """From now on, the port's moe module routes each call as the
    reference's ``calls`` did (its gate values gathered from its own
    probabilities at those ids); the list returned gets, per call, the
    port's probabilities and its own top-k ids beside the reference's.

    In bf16 two experts' probabilities can sit within one rounding of each
    other, and then either side may pick either: one such flip moves a
    token's logits by O(1).  Routing both sides alike holds everything
    else to bf16 rounding; ``check_routing`` holds the port's own choice."""
    seen = []

    def topk(probs, k, dim=-1):
        p_ref, ids_ref = calls[len(seen)]
        ids = torch.from_numpy(ids_ref.copy()).long()
        seen.append((probs.detach(), torch.topk(probs, k, dim=dim).indices,
                     p_ref, ids))
        return probs.gather(-1, ids), ids
    monkeypatch.setattr(moe, 'torch', _Delegate(torch, topk=topk))
    return seen


def check_routing(seen, calls, prob_tol):
    """Every call was replayed; the port's router probabilities are within
    ``prob_tol`` of the reference's; and the experts the port would pick
    itself carry, in its own probabilities, the weight of the reference's
    pick up to what that gap explains (k * gap each way): a near tie
    flipped, and no more."""
    assert len(seen) == len(calls)
    for i, (probs, own, p_ref, ids) in enumerate(seen):
        gap = float(np.abs(probs.numpy() - p_ref).max())
        assert gap <= prob_tol, (i, gap)
        k = ids.shape[-1]
        diff = probs.gather(-1, own).sum(-1) - probs.gather(-1, ids).sum(-1)
        assert float(diff.abs().max()) <= 2 * k * gap + 1e-7, i


def _all_logits_ref(m, p, toks):
    x = m._embed_in(p, {'tokens': toks})
    b, s = x.shape[:2]
    x, col, _, _ = m._forward(x=x, params=p, positions=jnp.broadcast_to(
        jnp.arange(s), (b, s)))
    return m._logits(p, x, col, None, None)


@torch.no_grad()
def _all_logits(m, p, toks):
    x = m._embed_in(p, {'tokens': toks})
    b, s = x.shape[:2]
    x, col, _, _ = m._forward(p, x, torch.arange(s).expand(b, s))
    return m._logits(p, x, col, None, None)


def _bf16_case(compute):
    kw = dict(param_dtype='bfloat16', compute_dtype=compute,
              cache_dtype=compute)
    jcfg = jget_reduced('qwen3-moe-30b-a3b').replace(**kw)
    tcfg = get_reduced('qwen3-moe-30b-a3b').replace(**kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 16)
                                             ).astype(np.int32)
    return jm, tm, jp, M.params_from_numpy(jp, 'cpu'), toks


def test_bf16_params_forward():
    """qwen3-moe's reduced config with bfloat16 parameters and f32
    compute: the reference's bf16 leaves cross bit for bit, and the logits
    of every position agree within 1e-5 of the largest (7.5e-7 measured)."""
    jm, tm, jp, tp, toks = _bf16_case('float32')
    flat = jkv.flatten_params(jp)
    for k, v in flat.items():
        assert tp[k].dtype == (torch.bfloat16 if v.dtype == jnp.bfloat16
                               else torch.float32), k
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)
    assert tp['blocks/moe/gate/w'].dtype == torch.bfloat16
    want = jax.jit(lambda p, t: _all_logits_ref(jm, p, t))(
        jp, jnp.asarray(toks))
    got = _all_logits(tm, tp, _t(toks))
    assert got.dtype == torch.float32
    _close_rel(got, want, 'f32-compute logits on bf16 weights')


def test_bf16_compute_forward(monkeypatch):
    """The published dtypes, bf16 parameters, compute and cache, on both
    sides: the logits of every position within BF16_LOGITS_REL of the
    largest, the port routed as the reference was (``replay_topk``), its
    own routing held by ``check_routing`` with BF16_PROB_TOL.

    The reference runs op by op (``jax.disable_jit``), so that each op
    rounds its result to bf16 as the port's eager ops do; under jit XLA's
    CPU backend may keep excess precision between fused ops.  Measured op
    by op: logits 7.3e-3 of the largest (two bf16 roundings at 4.3),
    router probabilities equal to 3e-8 in the first layer and 3.2e-3 apart
    in the second, after attention summed in another order."""
    jm, tm, jp, tp, toks = _bf16_case('bfloat16')
    calls = record_topk(monkeypatch)
    with jax.disable_jit():
        want = _all_logits_ref(jm, jp, jnp.asarray(toks))
    seen = replay_topk(monkeypatch, calls)
    got = _all_logits(tm, tp, _t(toks))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    w = np.asarray(want, np.float32)
    check_routing(seen, calls, BF16_PROB_TOL)
    _close_rel(got.float(), w, 'bf16 logits', rel=BF16_LOGITS_REL)


def _gather_form_case(dtype, skew):
    g = torch.Generator().manual_seed(5)
    p = {'moe/router/w': torch.randn(D, 2 * E, generator=g) * 0.5,
         'moe/gate/w': torch.randn(2 * E, D, FF, generator=g) * 0.3,
         'moe/up/w': torch.randn(2 * E, D, FF, generator=g) * 0.3,
         'moe/down/w': torch.randn(2 * E, FF, D, generator=g) * 0.3}
    p['moe/router/w'][:, 0] += skew
    x = torch.randn(2, 12, D, generator=g) + skew
    d_out = {'router': 2 * E, 'gate': FF, 'up': FF, 'down': D}
    taps = {f'moe/{n}/w': torch.zeros((d,) if n == 'router' else (2 * E, d))
            for n, d in d_out.items()}
    return ({k: v.to(dtype) for k, v in p.items()}, x.to(dtype),
            {k: v.to(dtype) for k, v in taps.items()})


def _run_gather_form(monkeypatch, p, x, taps, factor, groups, plain):
    """moe_apply at top-4 of 8 experts in ``groups`` groups (an abstract
    mesh: plain tensors), on the gather-form path or, with ``plain``
    False, the advanced-index gathers: (y, aux, stats, tracker, the
    gradients of x, the weights, the taps and the expert FFN's output)."""
    outs = []
    expert_linear = moe._expert_linear

    def keep(w, h, **kw):
        out = expert_linear(w, h, **kw)
        if kw['wpath'].endswith('/down/w'):
            outs.append(out)
        return out
    with monkeypatch.context() as m:
        m.setattr(moe, '_expert_linear', keep)
        if not plain:
            m.setattr(moe, '_plain', lambda *ts: False)
        leaves = [x, *p.values(), *taps.values()]
        leaves = [v.detach().requires_grad_(True) for v in leaves]
        tx, tp = leaves[0], dict(zip(p, leaves[1:1 + len(p)]))
        tt = dict(zip(taps, leaves[1 + len(p):]))
        col = {}
        with compat.set_mesh(compat.AbstractMesh((groups, 1),
                                                 ('data', 'model'))), \
                spans.recording(spans.SpanTracker()) as tracker:
            y, aux = moe.moe_apply(tp, tx, top_k=4, capacity_factor=factor,
                                   path='moe', col=col, taps=tt,
                                   capture=kv.EVA_CAPTURE, aux_coef=1e-2)
        loss = torch.sin(y.float()).sum() + 10 * aux
        grads = torch.autograd.grad(loss, [*leaves, outs[0]])
    return y, aux, col, tracker, grads


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('groups', [1, 2])
@pytest.mark.parametrize('factor', [1.0, 4.0])
def test_gather_form_against_advanced_index(monkeypatch, factor, groups,
                                            dtype):
    """Capacity factor 1.0 with a skewed router (drops) and 4.0 (many
    empty slots), one and two groups, f32 and bf16."""
    dt = getattr(torch, dtype)
    p, x, taps = _gather_form_case(dt, skew=1.0 if factor == 1.0 else 0.0)
    got = _run_gather_form(monkeypatch, p, x, taps, factor, groups, True)
    want = _run_gather_form(monkeypatch, p, x, taps, factor, groups, False)
    (y, aux, col, tracker, grads), (wy, waux, wcol, wtracker, wgrads) = \
        got, want
    assert y.dtype == dt
    assert torch.equal(y, wy) and torch.equal(aux, waux)
    assert tracker.counters['moe.gather_form/moe'] == [1]
    assert 'moe.gather_form/moe' not in wtracker.counters
    dropped = int(tracker.total('moe.dropped/moe'))
    assert dropped == int(wtracker.total('moe.dropped/moe'))
    assert (dropped > 0) == (factor == 1.0), dropped
    assert set(col) == set(wcol) == set(taps)
    for k in col:
        assert torch.equal(col[k].a_mean, wcol[k].a_mean), k
        assert torch.equal(col[k].count, wcol[k].count), k
    names = ['x', *p, *(f'tap {k}' for k in taps), 'combine']
    for name, g, w in zip(names[1:], grads[1:], wgrads[1:]):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    gx, wx = grads[0].float(), wgrads[0].float()
    scale = float(wx.abs().max())
    tol = TOKEN_GRAD_ULPS * 4 * torch.finfo(dt).eps * scale
    assert float((gx - wx).abs().max()) <= tol


@pytest.mark.parametrize('groups', [1, 2])
def test_gather_rows_gradcheck(groups):
    """``gather_rows``' backward is the adjoint of its gather behind the
    masks ``moe_apply`` puts there: the dispatch's slot mask and the
    combine's gate weights, zero on a dropped assignment.  Tiny shapes,
    f64; expert 0 takes every token's first pick, past its capacity."""
    top_k, n_exp, tg = 2, 4, 10
    gen = torch.Generator().manual_seed(6)
    second = 1 + torch.randint(0, n_exp - 1, (groups, tg), generator=gen)
    ids = torch.stack([torch.zeros_like(second), second], -1)
    cap = moe.capacity(tg, top_k, n_exp, 1.0)
    slot_token, slot_mask, flat_slot, ok = moe.route(
        ids.reshape(groups, tg * top_k), n_exp, top_k, cap)
    assert not ok.all()
    slot_src, a_row, ok_tk, assign, filled = moe.gather_tables(
        slot_token, slot_mask, flat_slot, ok, top_k)
    mask = slot_mask.movedim(0, 1).reshape(-1, 1).double()
    w = torch.rand(groups * tg, top_k, generator=gen, dtype=torch.float64)
    w = w * ok_tk

    def dispatch(x):
        return moe.gather_rows(x, slot_src, a_row, ok_tk) * mask

    def combine(o):
        y = moe.gather_rows(o, a_row.reshape(-1), assign, filled)
        return (y.reshape(-1, top_k, 3) * w.unsqueeze(-1)).sum(1)
    x = torch.randn(groups * tg, 3, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    o = torch.randn(mask.shape[0], 3, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(dispatch, (x,))
    assert torch.autograd.gradcheck(combine, (o,))
