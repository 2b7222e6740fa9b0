"""The demo LM's serving entry points in the port against the reference:
``prefill_fn`` (naive and chunked attention) and ``decode_fn`` after a
prefill whose cache was grown, from the same weights and tokens; within the
port, decode matches prefill over the full prompt as
``tests/test_serving_consistency.py`` holds the reference, and greedy
decoding stays finite and repeatable.

Stated tolerances: logits and caches against the reference within 1e-5 of
their largest magnitude (f32, other summation orders); decode against
prefill within the reference test's rtol = atol = 2e-2, with the same
argmax.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import demo_lm as jdemo_lm  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro_torch.configs.registry import demo_lm  # noqa: E402
from repro_torch.launch.serve import grow_cache  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from test_torch_lm_modules import _close_rel  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

N, B = 16, 2


def _setup(**over):
    jcfg, tcfg = jdemo_lm('small'), demo_lm('small')
    if over:
        jcfg, tcfg = jcfg.replace(**over), tcfg.replace(**over)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, N)
                                             ).astype(np.int32)
    return jm, tm, jp, M.params_from_numpy(jp, 'cpu'), toks


@pytest.mark.parametrize('attn', ['naive', 'chunked'])
def test_prefill_matches_reference(attn):
    over = dict(attn_impl='chunked', q_chunk=4, k_chunk=8) \
        if attn == 'chunked' else {}
    jm, tm, jp, tp, toks = _setup(**over)
    jl, jc = jax.jit(jm.prefill_fn)(jp, {'tokens': jnp.asarray(toks)})
    tl, tc = tm.prefill_fn(tp, {'tokens': torch.from_numpy(toks)})
    _close_rel(tl, jl, 'prefill logits')
    for k in ('k', 'v'):
        _close_rel(tc['blocks'][k], jc['blocks'][k], f'prefill cache {k}')


def test_decode_matches_reference_and_prefill():
    """Prefill N-1, grow the cache to N, decode token N-1: the reference's
    logits and cache, and within 2e-2 of the port's own prefill over all N
    with the same argmax.  The cache passed in is not written."""
    jm, tm, jp, tp, toks = _setup()
    _, jc = jax.jit(jm.prefill_fn)(jp, {'tokens': jnp.asarray(toks[:, :-1])})
    jgrown = jm.init_cache(B, N)
    jgrown = jax.tree_util.tree_map(
        lambda full, part: jax.lax.dynamic_update_slice(
            full, part, (0,) * full.ndim), jgrown, jc)
    jl, jc2 = jax.jit(jm.decode_fn)(jp, jgrown, jnp.asarray(toks[:, -1]),
                                    jnp.asarray(N - 1, jnp.int32))

    t = torch.from_numpy(toks)
    full, _ = tm.prefill_fn(tp, {'tokens': t})
    _, tc = tm.prefill_fn(tp, {'tokens': t[:, :-1]})
    grown = grow_cache(tm, tc, B, N, device='cpu')
    kept = {k: v.clone() for k, v in grown['blocks'].items()}
    for pos in (N - 1, torch.tensor(N - 1, dtype=torch.int32)):
        tl, tc2 = tm.decode_fn(tp, grown, t[:, -1], pos)
        _close_rel(tl, jl, 'decode logits')
        for k in ('k', 'v'):
            _close_rel(tc2['blocks'][k], jc2['blocks'][k], f'decode cache {k}')
            assert torch.equal(grown['blocks'][k], kept[k])
        np.testing.assert_allclose(tl.numpy(), full.numpy(), rtol=2e-2,
                                   atol=2e-2)
        assert torch.equal(tl.argmax(-1), full.argmax(-1))


def test_greedy_decode_finite_and_repeatable():
    """8 greedy decode steps after an 8-token prefill stay finite, and a
    second run gives the same tokens."""
    _, tm, _, tp, toks = _setup()
    plen, gen = 8, 8

    def run():
        logits, cache = tm.prefill_fn(
            tp, {'tokens': torch.from_numpy(toks[:, :plen])})
        cache = grow_cache(tm, cache, B, plen + gen, device='cpu')
        tok, out = logits.argmax(-1).to(torch.int32), []
        for i in range(gen):
            logits, cache = tm.decode_fn(tp, cache, tok, plen + i)
            assert torch.isfinite(logits).all()
            tok = logits.argmax(-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out)
    assert torch.equal(run(), run())
