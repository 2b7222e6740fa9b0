"""The demo transformer LM's modules in the port against the reference, on
the same inputs (numpy-seeded, or the reference's own ``init_params``):
the layers, the attends and the attention block, ``TransformerLM.loss_fn``
with its gradients, tap gradients and layer-stacked stats, the parameter
specs and inits, ``LMStream``'s bytes, remat, and ``finalize_stats``'
per-lead-item rescale of b̄.

Both sides run f32 on the CPU and sum in other orders.  Stated tolerances:
elementwise layers rtol 1e-5, atol 1e-6; attention outputs and the block's
stats atol 1e-5 of the output's largest magnitude; the LM's loss rtol 1e-6,
and each gradient, tap gradient and stats field within 1e-5 of its own
largest magnitude (measured: up to 2e-6); the embedding gradient, a
scatter-add over repeated ids in another order, atol 1e-6.  LMStream's
bytes, the shapes and the remat variants within the port are exact.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.registry import demo_lm as jdemo_lm  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.configs.registry import demo_lm  # noqa: E402
from repro_torch.core import kv  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

NARROW = dict(name='narrow', family='dense', n_layers=3, d_model=32,
              n_heads=4, n_kv_heads=2, d_ff=48, vocab=64, qkv_bias=True,
              norm='layer')
# a VLM-family variant: frontend embeddings in, the head tied to the table
NARROW_VLM = dict(NARROW, name='narrow-vlm', family='vlm',
                  input_is_embeds=True, tie_embeddings=True)
CONFIGS = {'small': (jdemo_lm('small'), demo_lm('small'), (8, 32)),
           'narrow': (JArchConfig(**NARROW), ArchConfig(**NARROW), (4, 16)),
           'narrow-vlm': (JArchConfig(**NARROW_VLM), ArchConfig(**NARROW_VLM),
                          (4, 16))}
REL = 1e-5          # of a leaf's largest magnitude


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close_rel(got, want, what, rel=REL, floor=1e-30):
    """Within ``rel`` of the largest magnitude of ``want`` (or of
    ``floor``, for a value that is zero but for rounding)."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _np_tree(spec, rng, scale=0.2):
    """Random f32 values for every leaf of a reference spec tree (biases
    and norm scales included, so none sits at its zero or one init)."""
    return JM.spec_tree_map(
        lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
        spec)


# ---------------------------------------------------------------------------
# layers


def test_norms_rope_positions():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 2 + 0.5
    p = {'scale': rng.standard_normal(16).astype(np.float32),
         'bias': rng.standard_normal(16).astype(np.float32)}
    tp = {k: _t(v) for k, v in p.items()}
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(L.rmsnorm(tp, _t(x)).numpy(),
                               np.asarray(JL.rmsnorm(p, jnp.asarray(x))), **tol)
    np.testing.assert_allclose(L.layernorm(tp, _t(x)).numpy(),
                               np.asarray(JL.layernorm(p, jnp.asarray(x))),
                               **tol)
    for kind in ('rms', 'layer'):
        (jspec, _), (tspec, _) = JL.make_norm(kind), L.make_norm(kind)
        assert {k: s.shape for k, s in jspec(16).items()} == \
            {k: s.shape for k, s in tspec(16).items()}
    q = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    for pos in (np.arange(7), rng.integers(0, 50, (2, 7))):
        np.testing.assert_allclose(
            L.apply_rope(_t(q), _t(pos), 500.0).numpy(),
            np.asarray(JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), 500.0)),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(L.sinusoidal_positions(9, 12).numpy(),
                               np.asarray(JL.sinusoidal_positions(9, 12)),
                               **tol)


def test_embed_value_and_gradient():
    """Rows at the ids, and the gradient summed over repeated ids."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((20, 6)).astype(np.float32)
    ids = np.array([[3, 3, 7, 0], [7, 3, 19, 3]], np.int32)
    w = rng.standard_normal((2, 4, 6)).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(JL.embed({'table': t}, jnp.asarray(ids))
                                    * w))(jnp.asarray(table))
    tt = _t(table).requires_grad_(True)
    out = L.embed({'table': tt}, _t(ids))
    np.testing.assert_array_equal(out.detach().numpy(), table[ids])
    (tg,) = torch.autograd.grad((out * _t(w)).sum(), tt)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


@pytest.mark.parametrize('kind', ['mlp', 'gelu_mlp'])
def test_mlps_with_capture(kind):
    """Output, the captured input stats and the tap gradients (b̄)."""
    rng = np.random.default_rng(2)
    spec = getattr(JL, f'{kind}_spec')(16, 24)
    jp = _np_tree(spec, rng)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    names = ('gate', 'up', 'down') if kind == 'mlp' else ('fc1', 'fc2')
    d_out = {'gate': 24, 'up': 24, 'down': 16, 'fc1': 24, 'fc2': 16}
    taps = {f'ff/{n}/w': np.zeros(d_out[n], np.float32) for n in names}
    jfn, tfn = getattr(JL, kind), getattr(L, kind)

    def jloss(t):
        col = {}
        y = jfn(jp, jnp.asarray(x), path='ff', col=col, taps=t,
                capture=jkv.EVA_CAPTURE)
        return jnp.sum(y * y), (y, col)
    (_, (jy, jcol)), jtg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in taps.items()})
    tt = {k: _t(v).requires_grad_(True) for k, v in taps.items()}
    tcol = {}
    ty = tfn(M.add_prefix(M.params_from_numpy(jp, 'cpu'), 'ff'), _t(x),
             path='ff', col=tcol, taps=tt, capture=kv.EVA_CAPTURE)
    tg = torch.autograd.grad((ty * ty).sum(), list(tt.values()))
    _close_rel(ty, jy, f'{kind} out')
    assert set(tcol) == set(jcol) == set(taps)
    for k in taps:
        _close_rel(tcol[k].a_mean, jcol[k].a_mean, f'{k} a_mean')
        assert float(tcol[k].count) == float(jcol[k].count) == 15.0
    for k, g in zip(tt, tg):
        _close_rel(g, jtg[k], f'{k} tap grad')


# ---------------------------------------------------------------------------
# attention


def _qkv(rng, b=2, sq=16, sk=16, h=4, kvh=2, dh=8):
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize('causal', [True, False])
def test_attends(causal):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(JA.attend_naive(jq, jk, jv, causal=causal))
    _close_rel(A.attend_naive(_t(q), _t(k), _t(v), causal=causal), want,
               'naive')
    for qc, kc in ((4, 8), (16, 4), (8, 16)):
        got = A.attend_chunked(_t(q), _t(k), _t(v), causal=causal,
                               q_chunk=qc, k_chunk=kc)
        ref = JA.attend_chunked(jq, jk, jv, causal=causal, q_chunk=qc,
                                k_chunk=kc)
        _close_rel(got, ref, f'chunked {qc}x{kc}')
        _close_rel(got, want, f'chunked {qc}x{kc} vs naive')
        _close_rel(A.attend(_t(q), _t(k), _t(v), causal=causal,
                            impl='chunked', q_chunk=qc, k_chunk=kc), ref,
                   'attend chunked')
    for qc, kc in ((4, 8), (16, 4)):
        _close_rel(A.attend(_t(q), _t(k), _t(v), causal=causal,
                            impl='flash', q_chunk=qc, k_chunk=kc),
                   JA.attend(jq, jk, jv, causal=causal, impl='flash',
                             q_chunk=qc, k_chunk=kc), f'attend flash {qc}x{kc}')


def test_attend_decode():
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, sq=1, sk=12)
    for pos in (0, 5, 11):
        want = JA.attend_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos, jnp.int32))
        _close_rel(A.attend_decode(_t(q), _t(k), _t(v), pos), want,
                   f'decode pos {pos}')
        _close_rel(A.attend_decode(_t(q), _t(k), _t(v),
                                   torch.tensor(pos, dtype=torch.int32)),
                   want, f'decode pos {pos} as a tensor')


def _block_case(rng, qkv_bias=True):
    spec = JA.attention_spec(16, 4, 2, 8, qkv_bias=qkv_bias)
    jp = _np_tree(spec, rng)
    tp = M.add_prefix(M.params_from_numpy(jp, 'cpu'), 'attn')
    return jp, tp


BLOCK_KW = dict(n_heads=4, n_kv_heads=2, head_dim=8, rope_theta=1000.0)


@pytest.mark.parametrize('mode', ['self', 'cross'])
def test_attention_block_train(mode):
    """No cache: the output, the stats of q/k/v/o's inputs and the tap
    gradients; cross-attention takes K/V from ``kv_x``."""
    rng = np.random.default_rng(5)
    jp, tp = _block_case(rng)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    kv_x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    cross = mode == 'cross'
    taps = {f'attn/{n}/w': np.zeros(d, np.float32)
            for n, d in (('q', 32), ('k', 16), ('v', 16), ('o', 16))}

    def jloss(t):
        col = {}
        y, cache = JA.attention_block(
            jp, jnp.asarray(x), positions=jnp.asarray(pos), rope=not cross,
            is_cross=cross, kv_x=jnp.asarray(kv_x) if cross else None,
            path='attn', col=col, taps=t, capture=jkv.EVA_CAPTURE,
            **BLOCK_KW)
        return jnp.sum(jnp.sin(y)), (y, col, cache)
    (_, (jy, jcol, jcache)), jtg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in taps.items()})
    tt = {k: _t(v).requires_grad_(True) for k, v in taps.items()}
    tcol = {}
    ty, tcache = A.attention_block(
        tp, _t(x), positions=_t(pos), rope=not cross, is_cross=cross,
        kv_x=_t(kv_x) if cross else None, path='attn', col=tcol, taps=tt,
        capture=kv.EVA_CAPTURE, **BLOCK_KW)
    assert jcache is None and tcache is None
    tg = torch.autograd.grad(torch.sin(ty).sum(), list(tt.values()))
    _close_rel(ty, jy, f'{mode} out')
    assert set(tcol) == set(jcol) == set(taps)
    for k in taps:
        _close_rel(tcol[k].a_mean, jcol[k].a_mean, f'{k} a_mean')
        assert float(tcol[k].count) == float(jcol[k].count)
    # cross-attention's k tap shifts every key's score by the same amount,
    # which the softmax cancels: its gradient is rounding, held against the
    # largest tap gradient of the block
    floor = max(float(np.abs(np.asarray(g)).max()) for g in jtg.values())
    for k, g in zip(tt, tg):
        _close_rel(g, jtg[k], f'{k} tap grad', floor=floor)


@pytest.mark.parametrize('mode', ['self_prefill', 'self_decode',
                                  'cross_prefill', 'cross_decode'])
def test_attention_block_with_cache(mode):
    """Cache writes: prefill writes from 0, decode at ``cache_pos`` (RoPE of
    the new key at that position), cross prefill writes the encoder K/V,
    cross decode reads them.  The port never writes the cache passed in."""
    rng = np.random.default_rng(6)
    jp, tp = _block_case(rng)
    s = 1 if mode.endswith('decode') else 5
    x = rng.standard_normal((2, s, 16)).astype(np.float32)
    kv_x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    cache = {n: rng.standard_normal((2, 7 if mode.startswith('cross') else 12,
                                     2, 8)).astype(np.float32)
             for n in ('k', 'v')}
    pos = 8 if mode == 'self_decode' else 0
    positions = np.broadcast_to(np.arange(pos, pos + s), (2, s))
    cross = mode.startswith('cross')
    kw = dict(BLOCK_KW, is_cross=cross, rope=not cross,
              cross_prefill=mode == 'cross_prefill', cache_pos=pos)
    jy, jc = JA.attention_block(
        jp, jnp.asarray(x), positions=jnp.asarray(positions),
        kv_x=jnp.asarray(kv_x), cache={k: jnp.asarray(v)
                                       for k, v in cache.items()},
        path='attn', **kw)
    tcache = {k: _t(v) for k, v in cache.items()}
    kept = {k: v.clone() for k, v in tcache.items()}
    ty, tc = A.attention_block(tp, _t(x), positions=_t(positions),
                               kv_x=_t(kv_x), cache=tcache, path='attn',
                               **kw)
    _close_rel(ty, jy, f'{mode} out')
    for k in ('k', 'v'):
        _close_rel(tc[k], jc[k], f'{mode} cache {k}')
        assert torch.equal(tcache[k], kept[k]), f'{mode}: cache {k} written'


# ---------------------------------------------------------------------------
# the LM


def _models(name):
    jcfg, tcfg, token_shape = CONFIGS[name]
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return jcfg, jm, tm, jp, M.params_from_numpy(jp, 'cpu'), token_shape


def _batch(cfg, token_shape, step=3):
    """The reference stream's batch (numpy); frontend embeddings too for
    an ``input_is_embeds`` config."""
    b, s = token_shape
    jb = jsyn.LMStream(cfg.vocab, s, b, seed=1).batch_at(step)
    out = {k: np.asarray(v) for k, v in jb.items()}
    if cfg.input_is_embeds:
        rng = np.random.default_rng(step)
        out['embeds'] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return out


def _taps(pkg_kv, params, paths, capture, token_shape):
    if capture.b == 'outer':
        return pkg_kv.make_full_taps(params, paths, token_shape)
    if capture.b == 'mean':
        return pkg_kv.make_vector_taps(params, paths)
    return None


def _ref_grads(jm, jp, batch, capture, token_shape):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    taps = _taps(jkv, jp, jm.precon_paths(), capture, token_shape)

    @jax.jit
    def run(p, t):
        def lf(p, t):
            return jm.loss_fn(p, t, jb, capture)
        (loss, aux), (g, tg) = jax.value_and_grad(
            lf, argnums=(0, 1), has_aux=True)(p, t)
        st = jkv.finalize_stats(aux['stats'], tg, capture,
                                n_tokens=jnp.asarray(aux['n_tokens'],
                                                     jnp.float32))
        return loss, g, tg, st
    loss, g, tg, st = run(jp, taps)
    return float(loss), jkv.flatten_params(g), tg, st


def _port_grads(tm, tp, batch, capture, token_shape):
    """(loss, grads, tap grads, stats) of one forward and backward."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in tp.items()}
    taps = _taps(kv, tp, tm.precon_paths(), capture, token_shape)
    taps = {k: t.requires_grad_(True) for k, t in taps.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    loss, aux = tm.loss_fn(leaves, taps, tb, capture)
    got = torch.autograd.grad(loss, list(leaves.values()) + list(taps.values()))
    grads = dict(zip(leaves, got[:len(leaves)]))
    tap_grads = dict(zip(taps, got[len(leaves):]))
    stats = kv.finalize_stats(aux['stats'], tap_grads, capture,
                              n_tokens=aux['n_tokens'])
    assert aux['n_tokens'] == token_shape[0] * token_shape[1]
    return loss, grads, tap_grads, stats


@pytest.mark.parametrize('cap', ['EVA_CAPTURE', 'KFAC_CAPTURE'])
@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_loss_grads_taps_and_stats_match_reference(name, cap):
    jcfg, jm, tm, jp, tp, token_shape = _models(name)
    assert tm.precon_paths() == jm.precon_paths()
    batch = _batch(jcfg, token_shape)
    jl, jg, jtg, jst = _ref_grads(jm, jp, batch, getattr(jkv, cap),
                                  token_shape)
    tl, tg, ttg, tst = _port_grads(tm, tp, batch, getattr(kv, cap),
                                   token_shape)
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-6)
    assert set(tg) == set(jg)
    for k in jg:
        _close_rel(tg[k], jg[k], f'grad {k}')
    assert set(ttg) == set(jtg)
    for k in jtg:
        _close_rel(ttg[k], jtg[k], f'tap grad {k}')
    assert set(tst) == set(jst) == tm.precon_paths()
    n_layers = jcfg.n_layers
    for k in jst:
        for field in kv.LayerStats._fields:
            want, got = getattr(jst[k], field), getattr(tst[k], field)
            assert (want is None) == (got is None), (k, field)
            if want is None:
                continue
            if k.startswith('blocks/'):   # the layer stack leads every field
                assert got.shape[0] == n_layers, (k, field, got.shape)
            _close_rel(got, want, f'stats {k} {field}')


def test_init_params_shapes_and_inits():
    """The port's specs and draws: the reference's shapes and parameter
    count; norm scales at one, biases at zero, the embedding at std 0.02 and
    the weights at std 1/sqrt(d_in), the layer stack leading each block
    leaf; one seed, one set of weights."""
    for name in CONFIGS:
        jcfg, jm, tm, jp, _, _ = _models(name)
        specs = tm.param_specs()
        assert M.count_params(specs) == JM.count_params(jm.param_specs())
        p = M.init_params(specs, torch.Generator().manual_seed(0),
                          device='cpu')
        want = {k: tuple(v.shape) for k, v in jkv.flatten_params(jp).items()}
        assert {k: tuple(v.shape) for k, v in p.items()} == want
        again = M.init_params(specs, torch.Generator().manual_seed(0),
                              device='cpu')
        assert all(torch.equal(p[k], again[k]) for k in p)
        for k, v in p.items():
            leaf = k.rsplit('/', 1)[-1]
            if k.startswith('blocks/'):
                assert v.shape[0] == jcfg.n_layers
            if leaf == 'scale':
                assert torch.equal(v, torch.ones_like(v)), k
            elif leaf in ('b', 'bias'):
                assert torch.equal(v, torch.zeros_like(v)), k
            elif leaf == 'table':
                assert abs(v.std().item() - 0.02) < 0.002, k
            else:
                std = 1.0 / v.shape[-2] ** 0.5
                assert abs(v.std().item() - std) < 0.1 * std, k
    assert M.stack_specs({'w': M.ParamSpec((3, 4))}, 5)['w'].shape == \
        (5, 3, 4)


def test_params_from_numpy_takes_the_nested_tree():
    _, _, _, jp, tp, _ = _models('small')
    flat = jkv.flatten_params(jp)
    assert set(tp) == set(flat)
    assert 'blocks/attn/q/w' in tp
    for k, v in flat.items():
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v))
    assert set(M.params_from_numpy(flat, 'cpu')) == set(tp)


def test_registry_and_unported_paths():
    assert isinstance(build_model(demo_lm('100m')), TransformerLM)
    assert demo_lm('100m').remat == 'dots'
    assert M.count_params(build_model(demo_lm('100m')).param_specs()) == \
        125_848_320
    # every family of the reference builds, the class of the reference's
    for family, cls in (('moe', 'TransformerLM'), ('ssm', 'MambaLM'),
                        ('hybrid', 'JambaLM'), ('encdec', 'EncDecLM')):
        cfg = demo_lm('small').replace(family=family, attn_period=2)
        assert type(build_model(cfg)).__name__ == cls == \
            type(jbuild(JArchConfig(**vars(cfg)))).__name__
    moe = TransformerLM(demo_lm('small').replace(n_experts=4, top_k=2))
    assert 'blocks/moe/gate/w' in moe.precon_paths()
    with pytest.raises(ValueError, match='unknown family'):
        build_model(demo_lm('small').replace(family='rnn'))
    with pytest.raises(KeyError):
        demo_lm('huge')


# ---------------------------------------------------------------------------
# LMStream


@pytest.mark.parametrize('block_entries', [None, 3 * 1000 + 7])
@pytest.mark.parametrize('vocab', [512, 1000])
def test_lmstream_bytes(vocab, block_entries, monkeypatch):
    """The reference's tokens and labels, byte for byte, with the chain
    built in one block or in blocks of a few rows; its CDF table and
    entropies equal."""
    if block_entries is not None:
        monkeypatch.setattr(tsyn, '_BLOCK_ENTRIES', block_entries)
    ref = jsyn.LMStream(vocab=vocab, seq_len=24, batch=5, seed=7)
    port = tsyn.LMStream(vocab=vocab, seq_len=24, batch=5, seed=7,
                         device='cpu')
    assert np.array_equal(port._cum, ref._cum)
    assert port.bigram_ce == ref.bigram_ce
    assert port.uniform_ce == ref.uniform_ce
    for step in (0, 1, 9):
        want, got = ref.batch_at(step), port.batch_at(step)
        for k in ('tokens', 'labels'):
            assert got[k].dtype == torch.int32 and got[k].is_contiguous()
            assert np.asarray(want[k]).tobytes() == got[k].numpy().tobytes()


# ---------------------------------------------------------------------------
# remat and finalize_stats


@pytest.mark.parametrize('cap', ['EVA_CAPTURE', 'KFAC_CAPTURE',
                                 'NO_CAPTURE'])
def test_remat_changes_no_bit(cap):
    """'none', 'full' and 'dots' give the same loss, gradients, tap
    gradients and stats, bit for bit; under remat the stats come from the
    first forward alone (one entry per path and layer)."""
    capture = getattr(kv, cap)
    _, jm, _, jp, tp, token_shape = _models('small')
    batch = _batch(jdemo_lm('small'), token_shape)
    runs = {}
    for remat in ('none', 'full', 'dots'):
        tm = build_model(demo_lm('small').replace(remat=remat))
        if capture.b is None:
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in tp.items()}
            loss, aux = tm.loss_fn(leaves, None, {k: _t(v) for k, v in
                                                  batch.items()}, capture)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            runs[remat] = (loss, grads, {}, aux['stats'])
        else:
            runs[remat] = _port_grads(tm, tp, batch, capture, token_shape)
    loss0, g0, tg0, st0 = runs['none']
    for remat in ('full', 'dots'):
        loss, g, tg, st = runs[remat]
        assert torch.equal(loss, loss0), remat
        for a, b in ((g, g0), (tg, tg0)):
            assert set(a) == set(b)
            assert all(torch.equal(a[k], b[k]) for k in a), remat
        assert set(st) == set(st0)
        for k in st:
            for x, y in zip(st[k], st0[k]):
                assert (x is None) == (y is None)
                assert x is None or torch.equal(x, y), (remat, k)


def test_finalize_stats_rescales_per_lead_item():
    """b̄ of a layer with an (E,) count is rescaled by n_tokens / max(count,
    1) per item, as the reference does (unequal counts, one of them 0); a
    layer stack that saw every token keeps its tap gradient's bits."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((4, 6)).astype(np.float32)
    tap = rng.standard_normal((4, 5)).astype(np.float32)
    count = np.array([3.0, 0.0, 7.0, 1.0], np.float32)
    jst = jkv.finalize_stats(
        {'e/w': jkv.LayerStats(a_mean=jnp.asarray(a),
                               count=jnp.asarray(count))},
        {'e/w': jnp.asarray(tap)}, jkv.EVA_CAPTURE,
        n_tokens=jnp.asarray(11.0, jnp.float32))
    tst = kv.finalize_stats(
        {'e/w': kv.LayerStats(a_mean=_t(a), count=_t(count))},
        {'e/w': _t(tap)}, kv.EVA_CAPTURE, n_tokens=11)
    want = np.asarray(jst['e/w'].b_mean)
    assert not np.allclose(want, tap)
    np.testing.assert_allclose(tst['e/w'].b_mean.numpy(), want, rtol=1e-6,
                               atol=0)
    stack = kv.finalize_stats(
        {'l/w': kv.LayerStats(a_mean=_t(a), count=torch.full((4,), 11.0))},
        {'l/w': _t(tap)}, kv.EVA_CAPTURE, n_tokens=11)
    assert torch.equal(stack['l/w'].b_mean, _t(tap))
