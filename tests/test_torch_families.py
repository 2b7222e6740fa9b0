"""Every assigned architecture at its reduced config in the port against
the reference (the port's counterpart of ``tests/test_models_smoke.py``):
``build_model`` gives the reference's class with the same parameter specs
and preconditioned paths; ``loss_fn``'s loss, gradients, tap gradients and
stats from the same weights (the reference's ``init_params``) and batch;
and 3 Eva steps (composed, the reference's default kernel path).

Batches follow ``test_models_smoke.py::tiny_batch``'s shapes (2 x 16
tokens; enc-dec 16 frames and 4 decoder tokens; VLM frame embeddings),
drawn with numpy.  Both sides run f32 on the CPU and sum in other orders.
Stated tolerances: the loss rtol 1e-6; each gradient, tap gradient and
stats field within 1e-5 of its largest magnitude (``_close_rel``; measured
up to 2e-6), jamba's gradients, tap gradients and stats within 1e-4 (measured 2.4e-5: 8 sublayers of
SSD, attention and MoE sum in other orders), and the attention's key bias and key tap, whose exact gradients are zero (a shift
of every key's score that the softmax cancels), within 1e-5 of the largest
gradient of the key weight and of all taps.  The 3 Eva steps are in ``test_torch_families_train.py``.
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_reduced)
from repro_torch.core import kv  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from test_torch_lm_modules import _close_rel, _t  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

REL = 1e-5
# jamba's reduced model stacks 8 sublayers of SSD, attention and MoE in f32:
# its gradients differ by up to 2.4e-5 of a leaf's largest magnitude
# (blocks/sub_5/mixer/in_proj/w); every other arch by up to 2e-6
REL_BY_ARCH = {'jamba-v0.1-52b': 1e-4}


def batch_for(cfg, b=2, s=16, seed=0):
    """numpy inputs of ``tiny_batch``'s shapes."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == 'encdec':
        dec = s // cfg.dec_ratio
        out['embeds'] = rng.standard_normal((b, s, cfg.d_model))
        out['tokens'] = rng.integers(0, cfg.vocab, (b, dec))
        out['labels'] = rng.integers(0, cfg.vocab, (b, dec))
    elif cfg.input_is_embeds:
        out['embeds'] = rng.standard_normal((b, s, cfg.d_model))
        out['labels'] = rng.integers(0, cfg.vocab, (b, s))
    else:
        out['tokens'] = rng.integers(0, cfg.vocab, (b, s))
        out['labels'] = rng.integers(0, cfg.vocab, (b, s))
    return {k: v.astype(np.float32 if k == 'embeds' else np.int32)
            for k, v in out.items()}


def _setup(arch):
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return jcfg, jm, tm, jp, M.params_from_numpy(jp, 'cpu')


def test_the_ten_configs():
    """The same ids, and field for field the same full and reduced
    configs."""
    from repro.configs import get_config as jget_config
    assert ARCH_IDS == JARCH_IDS and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        for jc, tc in ((jget_config(arch), get_config(arch)),
                       (jget_reduced(arch), get_reduced(arch))):
            assert vars(jc) == vars(tc), arch
    with pytest.raises(KeyError):
        get_config('gpt-5')


@pytest.mark.parametrize('arch', ARCH_IDS)
def test_loss_and_gradients(arch):
    jcfg, jm, tm, jp, tp = _setup(arch)
    assert type(tm).__name__ == type(jm).__name__
    assert tm.precon_paths() == jm.precon_paths()
    tspec = M.flatten_specs(tm.param_specs())
    jspec = jkv.flatten_params(jm.param_specs())
    assert {k: s.shape for k, s in tspec.items()} == \
        {k: s.shape for k, s in jspec.items()}
    batch = batch_for(jcfg)
    jtaps = jkv.make_vector_taps(jp, jm.precon_paths())

    def jloss(p, t):
        loss, aux = jm.loss_fn(p, t, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                               jkv.EVA_CAPTURE)
        return loss, (aux['stats'], aux['n_tokens'])
    (jl, (jst, jn)), (jg, jtg) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jtaps)
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tt = {k: torch.zeros(v.shape, requires_grad=True)
          for k, v in jtaps.items()}
    loss, aux = tm.loss_fn(leaves, tt, {k: _t(v) for k, v in batch.items()},
                           kv.EVA_CAPTURE)
    # a VLM's token table is not read by the loss: no gradient (zeros in
    # the reference)
    grads = torch.autograd.grad(loss, [*leaves.values(), *tt.values()],
                                allow_unused=True)
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    assert aux['n_tokens'] == int(jn)
    jflat = jkv.flatten_params(jg)
    for k, g in zip(leaves, grads[:len(leaves)]):
        want = np.asarray(jflat[k])
        if g is None:
            assert k == 'embed/table' and jcfg.input_is_embeds, k
            assert not want.any(), k
            continue
        rel, floor = REL_BY_ARCH.get(arch, REL), 1e-30
        if k.endswith('k/b'):
            floor = np.abs(np.asarray(jflat[k[:-1] + 'w'])).max()
        _close_rel(g, want, f'{arch} grad {k}', rel=rel, floor=floor)
    tap_floor = max(np.abs(np.asarray(g)).max() for g in jtg.values())
    for k, g in zip(tt, grads[len(leaves):]):
        _close_rel(g, jtg[k], f'{arch} tap grad {k}',
                   rel=REL_BY_ARCH.get(arch, REL),
                   floor=tap_floor if k.endswith('/k/w') else 1e-30)
    assert set(aux['stats']) == set(jst)
    for k, st in jst.items():
        _close_rel(aux['stats'][k].a_mean, st.a_mean, f'{arch} {k} a_mean',
                   rel=REL_BY_ARCH.get(arch, REL))
        np.testing.assert_array_equal(aux['stats'][k].count.numpy(),
                                      np.asarray(st.count), err_msg=k)
