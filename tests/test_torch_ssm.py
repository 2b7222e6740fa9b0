"""The Mamba-2 SSD block of the port against the reference on the same
inputs: ``_causal_conv``; ``ssd_chunked`` (output and final state) with
lengths that fill the chunks and one that needs right-padding, and against
a step-by-step recurrence; ``mamba_block``'s output, stats and tap
gradients, its prefill cache (``return_cache``) and one decode step; and,
within the port, a prefill followed by decode steps against a prefill over
the whole sequence.  The kernels of ``kernels/ssd.py`` run only on the
card (``chip_smoke.py`` holds them to ``ssd_plain``); here: CPU tensors take
``ssd_plain`` bit for bit, the kernels' wrapper raises on what they do not
take, and the ``ssd`` span and ``ssd.kernel/<path>`` counter.

Both sides run f32 on the CPU.  Stated tolerances: each output, state and
gradient within 1e-5 of its largest magnitude (``_close_rel``); the
recurrence and decode against the chunked prefill within 1e-4 of it (they
add up the same terms in another order, over the whole sequence).
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kv as jkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.core import kv  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from test_torch_lm_modules import _close_rel, _np_tree, _t  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

D_MODEL, HEADDIM, D_STATE, D_CONV = 16, 8, 6, 4


def test_ssm_dims_and_spec():
    assert ssm.ssm_dims(1536, 2, 64, 128, 4) == \
        jssm.ssm_dims(1536, 2, 64, 128, 4) == (3072, 48, 3328)
    tspec = M.flatten_specs(ssm.mamba_spec(D_MODEL, headdim=HEADDIM,
                                           d_state=D_STATE))
    jspec = jkv.flatten_params(jssm.mamba_spec(D_MODEL, headdim=HEADDIM,
                                               d_state=D_STATE))
    assert {k: s.shape for k, s in tspec.items()} == \
        {k: s.shape for k, s in jspec.items()}
    assert {k: s.init for k, s in tspec.items()} == \
        {k: s.init for k, s in jspec.items()}


def test_causal_conv():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 10)).astype(np.float32)
    w = rng.standard_normal((D_CONV, 10)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    _close_rel(ssm._causal_conv(_t(x), _t(w), _t(b)),
               jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b)), 'conv')


def _ssd_inputs(rng, s, b=2, h=3, p=4, n=5):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a, bm, cm, d


def _recurrence(x, dt, a, bm, cm, d):
    """y_t = C_t·S_t + D·x_t with S_t = exp(dt_t·A)·S_{t-1} + dt_t·B_t⊗x_t,
    one step at a time in float64."""
    b, s, h, p = x.shape
    state = np.zeros((b, h, bm.shape[-1], p))
    ys = []
    for t in range(s):
        da = np.exp(dt[:, t] * a)                          # (b,h)
        state = state * da[:, :, None, None] + np.einsum(
            'bn,bh,bhp->bhnp', bm[:, t], dt[:, t], x[:, t])
        ys.append(np.einsum('bn,bhnp->bhp', cm[:, t], state)
                  + x[:, t] * d[:, None])
    return np.stack(ys, 1), state


@pytest.mark.parametrize('s,chunk', [(16, 4), (16, 16), (13, 4), (5, 8)],
                         ids=['4_chunks', 'one_chunk', 'padded', 'short'])
def test_ssd_chunked(s, chunk):
    rng = np.random.default_rng(s + chunk)
    args = _ssd_inputs(rng, s)
    jy, jstate = jssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    y, state = ssm.ssd_chunked(*map(_t, args), chunk=chunk)
    _close_rel(y, jy, 'y')
    _close_rel(state, jstate, 'final state')
    ry, rstate = _recurrence(*(a.astype(np.float64) for a in args))
    _close_rel(y, ry, 'y vs recurrence', rel=1e-4)
    _close_rel(state, rstate, 'state vs recurrence', rel=1e-4)


def _block_case(rng):
    spec = jssm.mamba_spec(D_MODEL, headdim=HEADDIM, d_state=D_STATE,
                           d_conv=D_CONV)
    jp = _np_tree(spec, rng, scale=0.3)
    return jp, M.add_prefix(M.params_from_numpy(jp, 'cpu'), 'mixer')


KW = dict(headdim=HEADDIM, d_state=D_STATE, d_conv=D_CONV, chunk=4)


@pytest.mark.parametrize('s', [12, 2], ids=['12_tokens', '2_tokens'])
def test_mamba_block_prefill(s):
    """Output, the stats of in_proj's and out_proj's inputs, their tap
    gradients and the prefill cache (final state and conv tail, padded at
    the front when the prompt is shorter than the conv)."""
    rng = np.random.default_rng(s)
    jp, tp = _block_case(rng)
    x = rng.standard_normal((2, s, D_MODEL)).astype(np.float32)
    d_in = jp['in_proj']['w'].shape[1]
    taps = {'mixer/in_proj/w': np.zeros(d_in, np.float32),
            'mixer/out_proj/w': np.zeros(D_MODEL, np.float32)}

    def jloss(t):
        col = {}
        y, cache = jssm.mamba_block(jp, jnp.asarray(x), return_cache=True,
                                    path='mixer', col=col, taps=t,
                                    capture=jkv.EVA_CAPTURE, **KW)
        return jnp.sum(jnp.sin(y)), (y, col, cache)
    (_, (jy, jcol, jcache)), jtg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in taps.items()})
    tt = {k: _t(v).requires_grad_(True) for k, v in taps.items()}
    col = {}
    y, cache = ssm.mamba_block(tp, _t(x), return_cache=True, path='mixer',
                               col=col, taps=tt, capture=kv.EVA_CAPTURE, **KW)
    tg = torch.autograd.grad(torch.sin(y).sum(), list(tt.values()))
    _close_rel(y, jy, 'out')
    for k, g in zip(tt, tg):
        _close_rel(g, jtg[k], f'tap grad {k}')
    assert set(col) == set(jcol) == set(taps)
    for k in taps:
        _close_rel(col[k].a_mean, jcol[k].a_mean, f'{k} a_mean')
    for k in ('conv', 'ssm'):
        _close_rel(cache[k].detach(), jcache[k], f'cache {k}')


def test_mamba_block_decode_matches_reference_and_prefill():
    """Prefill 9 tokens, then decode tokens 10-12 one at a time: each
    decode step equals the reference's from the same cache, and the
    decoded outputs equal a prefill over all 12 at those positions."""
    rng = np.random.default_rng(9)
    jp, tp = _block_case(rng)
    x = rng.standard_normal((2, 12, D_MODEL)).astype(np.float32)
    with torch.no_grad():
        full, _ = ssm.mamba_block(tp, _t(x), path='mixer', **KW)
        _, cache = ssm.mamba_block(tp, _t(x[:, :9]), return_cache=True,
                                   path='mixer', **KW)
        _, jcache = jssm.mamba_block(jp, jnp.asarray(x[:, :9]),
                                     return_cache=True, path='mixer', **KW)
        for t in range(9, 12):
            y, cache = ssm.mamba_block(tp, _t(x[:, t:t + 1]), cache=cache,
                                       path='mixer', **KW)
            jy, jcache = jssm.mamba_block(jp, jnp.asarray(x[:, t:t + 1]),
                                          cache=jcache, path='mixer', **KW)
            _close_rel(y, jy, f'decode {t}')
            for k in ('conv', 'ssm'):
                _close_rel(cache[k], jcache[k], f'decode {t} cache {k}')
            _close_rel(y[:, 0], full[:, t].numpy(), f'decode {t} vs prefill',
                       rel=1e-4)


def test_ssd_gradients_finite_at_a_long_chunk():
    """At a chunk of 256 (mamba2-780m's) with strong decay the upper
    triangle's seg_q - seg_k reaches hundreds: its exp overflows f32.  The
    port masks it before the exp, so the gradients stay finite, and equal
    those of the same function cut into chunks of 8 (where nothing
    overflows) within 1e-3 of their scale (a chunk of 256 sums up to 256
    decayed terms in another order; measured 1.1e-4)."""
    rng = np.random.default_rng(11)
    x, dt, a, bm, cm, d = _ssd_inputs(rng, 256)
    dt = dt + 1.0                          # dt·A sums past 88 in a chunk
    assert float((dt * -a).sum(1).max()) > 88

    def grads(chunk):
        ins = [_t(v).requires_grad_(True) for v in (x, dt, bm, cm)]
        y, _ = ssm.ssd_chunked(ins[0], ins[1], _t(a), ins[2], ins[3], _t(d),
                               chunk=chunk)
        return torch.autograd.grad(torch.sin(y).sum(), ins)
    for name, g, w in zip(('x', 'dt', 'B', 'C'), grads(256), grads(8)):
        assert torch.isfinite(g).all(), name
        _close_rel(g, w.numpy(), f'd{name}', rel=1e-3)


@pytest.mark.parametrize('s,chunk', [(16, 4), (13, 4)], ids=['4_chunks',
                                                              'padded'])
def test_ssd_cpu_route_is_the_plain_version(s, chunk):
    """CPU tensors take ``ssd_plain``: the same outputs and autograd
    gradients, bit for bit, and no kernel launch."""
    from repro_torch.kernels import ssd as ssd_kernels
    args = _ssd_inputs(np.random.default_rng(s), s)
    before = dict(ssd_kernels.LAUNCHES)

    def run(fn):
        ins = [_t(v).requires_grad_(True) for v in args]
        y, state = fn(*ins, chunk=chunk)
        return [y, state, *torch.autograd.grad(
            torch.sin(y).sum() + state.square().sum(), ins)]
    for got, want in zip(run(ssm.ssd_chunked), run(ssm.ssd_plain)):
        assert torch.equal(got, want)
    assert ssd_kernels.LAUNCHES == before


def _kernel_args(**change):
    """Arguments the kernels take (chunk 8, d_state 16, headdim 16, f32),
    on the CPU, with ``change`` applied."""
    rng = np.random.default_rng(5)
    x, dt, a, bm, cm, d = (_t(v) for v in _ssd_inputs(rng, 5, b=1, h=2,
                                                        p=16, n=16))
    args = dict(x=x, dt=dt, a=a, bmat=bm, cmat=cm, d_skip=d, chunk=8)
    for k, f in change.items():
        args[k] = f(args[k])
    return args


@pytest.mark.parametrize('change,error,match', [
    (dict(x=lambda t: t.half()), TypeError, 'x must be float32 or bfloat16'),
    (dict(dt=lambda t: t.bfloat16()), TypeError, 'dt must be'),
    (dict(bmat=lambda t: t.bfloat16()), TypeError, 'bmat must be'),
    (dict(x=lambda t: t.reshape(1, 5, 32)), ValueError, 'x must have 4'),
    (dict(d_skip=lambda t: t[None]), ValueError, 'd_skip must have 1'),
    (dict(x=lambda t: t.transpose(2, 3).contiguous().transpose(2, 3)),
     ValueError, 'must be contiguous'),
    (dict(cmat=lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)),
     ValueError, 'must be contiguous'),
    (dict(chunk=lambda c: 128), ValueError, 'no kernel for chunk 128'),
    ({}, ValueError, 'take CUDA tensors'),
], ids=['x_float16', 'dt_bfloat16', 'bmat_unlike_x', 'x_rank', 'd_rank',
        'x_strided_within_a_row', 'cmat_strided_within_a_row',
        'shape_not_compiled', 'cpu_tensor'])
def test_ssd_kernel_checks(change, error, match):
    """The kernels' wrapper raises on what they do not take, before any
    launch."""
    from repro_torch.kernels import ssd as ssd_kernels
    with pytest.raises(error, match=match):
        ssd_kernels.ssd(**_kernel_args(**change))


def test_ssd_span_and_kernel_counter():
    """Under a tracker the scan of each cache-free ``mamba_block`` call
    records a span ``ssd`` inside the block's, on the CPU route too, and
    counts 0 in ``ssd.kernel/<path>`` there (1 on the kernels' route);
    decode records neither."""
    from repro_torch.obs import spans
    rng = np.random.default_rng(4)
    _, tp = _block_case(rng)
    x = _t(rng.standard_normal((2, 12, D_MODEL)).astype(np.float32))
    with spans.recording(spans.SpanTracker()) as tracker:
        with spans.span('forward'):
            y, cache = ssm.mamba_block(tp, x, return_cache=True,
                                       path='mixer', **KW)
        ssm.mamba_block(tp, x[:, :1], cache=cache, path='mixer', **KW)
    recs = [r for r in tracker.records if r['name'] == 'ssd']
    assert [(r['parent'], r['depth']) for r in recs] == [('forward', 1)]
    assert tracker.counters == {'ssd.kernel/mixer': [0]}
    assert tracker.total('ssd.kernel/mixer') == 0
