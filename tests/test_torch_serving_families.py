"""Serving of the four architectures of ``tests/test_serving_consistency
.py`` in the port (attention with RoPE and a KV cache, SSM recurrent state,
the hybrid's two kinds of cache side by side, MoE), at their reduced
configs, from the reference's weights: ``prefill_fn`` over the whole prompt
and ``decode_fn`` of the last token after a prefill of the rest (the cache
grown to hold it) against the reference's logits, and within the port
decode against the full prefill, as the reference's test holds the
reference.  Then 8 greedy decode steps stay finite and repeatable.

MoE runs at capacity factor 8.0, as there: capacity drops differ between a
batched prefill and a one-token decode by design.  Both sides run f32 on
the CPU.  Stated tolerances: logits against the reference within 1e-5 of
their largest magnitude (``_close_rel``); decode against prefill within the
reference test's rtol = atol = 2e-2, with the same argmax.
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
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.core import kv  # noqa: E402
from repro_torch.launch.serve import grow_cache  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from test_torch_lm_modules import _close_rel  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

ARCHS = ['qwen2-0.5b', 'mamba2-780m', 'jamba-v0.1-52b', 'qwen3-moe-30b-a3b']
N, B = 16, 2


def _jgrow(model, cache, batch, total):
    grown = model.init_cache(batch, total)
    return jax.tree_util.tree_map(
        lambda full, part: jax.lax.dynamic_update_slice(
            full, part.astype(full.dtype), (0,) * full.ndim), grown, cache)


def _setup(arch):
    jcfg = jget_reduced(arch).replace(capacity_factor=8.0)
    tcfg = get_reduced(arch).replace(capacity_factor=8.0)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, N)
                                             ).astype(np.int32)
    return jcfg, jm, tm, jp, M.params_from_numpy(jp, 'cpu'), toks


@pytest.mark.parametrize('arch', ARCHS)
def test_decode_matches_prefill_and_reference(arch):
    cfg, jm, tm, jp, tp, toks = _setup(arch)
    jfull, _ = jax.jit(jm.prefill_fn)(jp, {'tokens': jnp.asarray(toks)})
    _, jc = jax.jit(jm.prefill_fn)(jp, {'tokens': jnp.asarray(toks[:, :-1])})
    if cfg.family != 'ssm':
        jc = _jgrow(jm, jc, B, N)
    jdec, jc2 = jax.jit(jm.decode_fn)(jp, jc, jnp.asarray(toks[:, -1]),
                                      jnp.asarray(N - 1, jnp.int32))

    t = torch.from_numpy(toks)
    full, _ = tm.prefill_fn(tp, {'tokens': t})
    _, cache = tm.prefill_fn(tp, {'tokens': t[:, :-1]})
    _close_rel(full, jfull, f'{arch} prefill logits')
    jflat = jkv.flatten_params(jc)
    if cfg.family != 'ssm':
        cache = grow_cache(tm, cache, B, N, device='cpu')
    tflat = kv.flatten_params(cache)
    assert set(tflat) == set(jflat)
    for k in tflat:
        _close_rel(tflat[k], jflat[k], f'{arch} prefill cache {k}')
    got, cache2 = tm.decode_fn(tp, cache, t[:, -1], N - 1)
    _close_rel(got, jdec, f'{arch} decode logits')
    jflat2 = jkv.flatten_params(jc2)
    for k, v in kv.flatten_params(cache2).items():
        _close_rel(v, jflat2[k], f'{arch} decode cache {k}')
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(got.argmax(-1), full.argmax(-1))


@pytest.mark.parametrize('arch', ['qwen2-0.5b', 'mamba2-780m'])
def test_multi_step_decode_stable(arch):
    """8 greedy decode steps after an 8-token prefill stay finite, and a
    second run gives the same tokens."""
    cfg, _, tm, _, tp, toks = _setup(arch)
    plen, gen = 8, 8

    def run():
        logits, cache = tm.prefill_fn(
            tp, {'tokens': torch.from_numpy(toks[:, :plen])})
        if cfg.family != 'ssm':
            cache = grow_cache(tm, cache, B, plen + gen, device='cpu')
        tok, out = logits.argmax(-1).to(torch.int32), []
        for i in range(gen):
            logits, cache = tm.decode_fn(tp, cache, tok, plen + i)
            assert torch.isfinite(logits).all()
            tok = logits.argmax(-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out)
    assert torch.equal(run(), run())


def test_encdec_decode_matches_prefill_and_reference():
    """whisper-tiny's reduced config: encode 16 frames, prefill 3 decoder
    tokens, grow the self cache, decode the 4th: the reference's logits and
    caches, and the port's own prefill over all 4."""
    jcfg, tcfg = jget_reduced('whisper-tiny'), get_reduced('whisper-tiny')
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tp = M.params_from_numpy(jp, 'cpu')
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((B, 16, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, 4)).astype(np.int32)
    jfull, _ = jm.prefill_fn(jp, {'embeds': jnp.asarray(emb),
                                  'tokens': jnp.asarray(toks)})
    _, jc = jm.prefill_fn(jp, {'embeds': jnp.asarray(emb),
                               'tokens': jnp.asarray(toks[:, :-1])})
    jgrown = jm.init_cache(B, 4, enc_len=16)
    jgrown = jax.tree_util.tree_map(
        lambda full, part: jax.lax.dynamic_update_slice(
            full, part, (0,) * full.ndim), jgrown, jc)
    jdec, _ = jm.decode_fn(jp, jgrown, jnp.asarray(toks[:, -1]),
                           jnp.asarray(3, jnp.int32))
    e, t = torch.from_numpy(emb), torch.from_numpy(toks)
    full, _ = tm.prefill_fn(tp, {'embeds': e, 'tokens': t})
    _, cache = tm.prefill_fn(tp, {'embeds': e, 'tokens': t[:, :-1]})
    for k, v in kv.flatten_params(cache).items():
        _close_rel(v, jkv.flatten_params(jc)[k], f'prefill cache {k}')
    grown = grow_cache(tm, cache, B, 4, device='cpu', enc_len=16)
    got, _ = tm.decode_fn(tp, grown, t[:, -1], 3)
    _close_rel(full, jfull, 'prefill logits')
    _close_rel(got, jdec, 'decode logits')
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(got.argmax(-1), full.argmax(-1))


def test_serve_launcher_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch ... --reduced --device
    cpu`` for one arch of each family: finite, in-vocab tokens, as many as
    the reference's loop makes (min(gen, prompt) tokens)."""
    import sys
    from repro_torch.launch import serve
    for arch, want in (('qwen3-moe-30b-a3b', 16), ('mamba2-780m', 16),
                       ('jamba-v0.1-52b', 16), ('whisper-tiny', 8),
                       ('llava-next-34b', 16)):
        cfg, tokens, _ = serve.serve(arch, reduced=True, device='cpu')
        assert tokens.shape == (4, want), arch
        assert ((tokens >= 0) & (tokens < cfg.vocab)).all(), arch
    argv = sys.argv
    sys.argv = ['serve', '--arch', 'qwen2-0.5b', '--reduced', '--batch', '2',
                '--device', 'cpu']
    try:
        serve.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert 'qwen2-0.5b: 2×16 tokens' in out and 'first row:' in out

