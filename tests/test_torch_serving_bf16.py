"""Serving of the four architectures of ``tests/test_serving_consistency
.py`` at their reduced configs in the published dtypes, bf16 parameters,
compute and cache, the port against the reference from the reference's
weights: ``prefill_fn`` over the whole prompt and ``decode_fn`` of the last
token after a prefill of the rest (the cache grown to hold it), and each
side's decode against the f32-compute prefill.  MoE runs at capacity
factor 8.0, as there.  Tolerances are stated beside their constants and
measured in the test's docstring.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.launch.serve import grow_cache  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401
from test_torch_moe import check_routing, record_topk, replay_topk  # noqa: E402,E501
from test_torch_serving_families import ARCHS, B, N, _jgrow  # noqa: E402

# bf16 compute (test_bf16_decode_matches_reference), each about twice what
# was measured there: the port's logits against the op-by-op reference, as
# a share of the largest logit; router probabilities (largest gap 6.4e-2 on
# jamba, 4.1e-3 on qwen3-moe)
BF16_SERVE_REL = {'qwen2-0.5b': 2.5e-2, 'mamba2-780m': 3e-2,
                  'jamba-v0.1-52b': 1.2e-1, 'qwen3-moe-30b-a3b': 1.5e-2}
BF16_SERVE_PROB_TOL = {'jamba-v0.1-52b': 0.13, 'qwen3-moe-30b-a3b': 1e-2}
# decode's bf16 error over the prefill's, against the f32-compute prefill:
# twice the largest ratio measured (1.41, the reference's on jamba)
BF16_DECODE_RATIO = 3.0


def _jserve(jm, jp, toks):
    """The reference's prefill over all of ``toks``, and its decode of the
    last token after a prefill of the rest: (full, decode) logits, f32."""
    full, _ = jm.prefill_fn(jp, {'tokens': jnp.asarray(toks)})
    _, jc = jm.prefill_fn(jp, {'tokens': jnp.asarray(toks[:, :-1])})
    if jm.cfg.family != 'ssm':
        jc = _jgrow(jm, jc, B, N)
    dec, _ = jm.decode_fn(jp, jc, jnp.asarray(toks[:, -1]),
                          jnp.asarray(N - 1, jnp.int32))
    return np.asarray(full, np.float32), np.asarray(dec, np.float32)


def _serve(tm, tp, toks):
    t = torch.from_numpy(toks)
    full, _ = tm.prefill_fn(tp, {'tokens': t})
    _, cache = tm.prefill_fn(tp, {'tokens': t[:, :-1]})
    if tm.cfg.family != 'ssm':
        cache = grow_cache(tm, cache, B, N, device='cpu')
    dec, _ = tm.decode_fn(tp, cache, t[:, -1], N - 1)
    return full.float().numpy(), dec.float().numpy()


@pytest.mark.parametrize('arch', ARCHS)
def test_bf16_decode_matches_reference(monkeypatch, arch):
    """The published dtypes, bf16 parameters, compute and cache, on both
    sides, the reference op by op (``jax.disable_jit``: each op rounds to
    bf16 as the port's eager ops do) and the port routed as it was
    (``replay_topk``): the port's prefill and decode logits within
    BF16_SERVE_REL[arch] of the largest f32-compute logit of the
    reference's, so the two decode-vs-prefill gaps agree within twice
    that.  On both sides decode's distance to the f32-compute prefill
    (the same weights) is at most BF16_DECODE_RATIO times the bf16
    prefill's own plus two bf16 roundings of the largest logit, the limit
    the card holds its published-width bf16 serving to.

    Measured, as shares of the largest logit, port against reference,
    prefill / decode: qwen2 1.2e-2 / 1.2e-2, mamba2 1.3e-2 / 1.3e-2, jamba
    5.1e-2 / 3.5e-2, qwen3-moe 2.2e-3 / 2.2e-3.  Jamba's 8 sublayers carry
    the most rounding: op by op JAX's SiLU rounds twice in bf16 (a sigmoid,
    then a product) where PyTorch's rounds once.  Decode against prefill:
    0 (qwen2, qwen3-moe), 1.0e-2 (mamba2, both sides), 1.7e-2 (port) and
    2.4e-2 (reference) for jamba.  Decode's distance to the f32 prefill
    over the bf16 prefill's, port / reference: qwen2 1.0 / 1.0, mamba2
    0.90 / 0.96, jamba 0.92 / 1.41, qwen3-moe 1.0 / 1.0."""
    bf16 = dict(param_dtype='bfloat16', compute_dtype='bfloat16',
                cache_dtype='bfloat16')
    jcfg = jget_reduced(arch).replace(capacity_factor=8.0, **bf16)
    tcfg = get_reduced(arch).replace(capacity_factor=8.0, **bf16)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tp = M.params_from_numpy(jp, 'cpu')
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, N)
                                             ).astype(np.int32)
    f32 = dict(compute_dtype='float32', cache_dtype='float32')
    truth, _ = _jserve(jbuild(jcfg.replace(**f32)), jp, toks)
    calls = record_topk(monkeypatch)
    with jax.disable_jit():
        jfull, jdec = _jserve(jm, jp, toks)
    seen = replay_topk(monkeypatch, calls)
    full, dec = _serve(tm, tp, toks)
    check_routing(seen, calls, BF16_SERVE_PROB_TOL.get(arch, 0.0))
    scale = float(np.abs(truth).max())
    atol = BF16_SERVE_REL[arch] * scale
    np.testing.assert_allclose(full, jfull, rtol=0, atol=atol,
                               err_msg=f'{arch} bf16 prefill')
    np.testing.assert_allclose(dec, jdec, rtol=0, atol=atol,
                               err_msg=f'{arch} bf16 decode')
    for side, (f, d) in (('port', (full, dec)), ('reference', (jfull, jdec))):
        err_dec = float(np.abs(d - truth).max())
        err_pre = float(np.abs(f - truth).max())
        assert err_dec <= BF16_DECODE_RATIO * err_pre + 2 ** -7 * scale, \
            (arch, side, err_dec, err_pre)
