"""Flash attention of the port (``models/flash.py``, a
``torch.autograd.Function`` with a hand-written backward) against the
reference's ``flash_attention`` (a ``jax.custom_vjp``) and against the
port's own ``attend_naive``: the output and dQ, dK, dV, causal and not,
with GQA (and plain multi-head), at sizes where the chunks divide the
lengths; and ``attend(impl='flash')`` in the attention block.

Both sides run f32 on the CPU.  Stated tolerance: each output and gradient
within 1e-5 of its largest magnitude (``_close_rel``).
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import flash  # noqa: E402
from test_torch_lm_modules import _close_rel, _qkv, _t  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

# (h, kvh, sq, sk, q_chunk, k_chunk)
CASES = [(4, 2, 16, 16, 4, 8), (4, 2, 16, 16, 16, 4), (6, 2, 24, 24, 8, 8),
         (4, 4, 8, 8, 8, 8), (4, 1, 12, 24, 4, 6)]


# causal attention is square here, as in the models
PARAMS = [(c, causal) for c in CASES for causal in (True, False)
          if not causal or c[2] == c[3]]


def _ids(p):
    return 'h{}kv{}_{}x{}_q{}k{}'.format(*p[0]) + ('_causal' if p[1] else '')


@pytest.mark.parametrize('case,causal', PARAMS, ids=[_ids(p) for p in PARAMS])
def test_flash_value_and_gradients(case, causal):
    h, kvh, sq, sk, qc, kc = case
    rng = np.random.default_rng(sum(case))
    q, k, v = _qkv(rng, sq=sq, sk=sk, h=h, kvh=kvh)
    w = rng.standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, causal, qc, kc)
        return jnp.sum(out * w), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    def grads(fn):
        tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
        out = fn(tq, tk, tv)
        return out, torch.autograd.grad((out * _t(w)).sum(), [tq, tk, tv])
    out, tg = grads(lambda a, b, c: flash.flash_attention(a, b, c, causal,
                                                          qc, kc))
    nout, ng = grads(lambda a, b, c: A.attend_naive(a, b, c, causal=causal))
    _close_rel(out, jout, 'out vs reference')
    _close_rel(out, nout.detach().numpy(), 'out vs naive')
    for name, g, jg, gn in zip('qkv', tg, jgrads, ng):
        _close_rel(g, jg, f'd{name} vs reference')
        _close_rel(g, gn.numpy(), f'd{name} vs naive')


def test_flash_rejects_chunks_that_do_not_divide():
    q, k, v = (_t(x) for x in _qkv(np.random.default_rng(0), sq=12, sk=12))
    with pytest.raises(ValueError, match='do not divide'):
        flash.flash_attention(q, k, v, True, 8, 8)


def test_flash_in_the_attention_block():
    """``attention_block(impl='flash')`` with RoPE and biases: the output
    and the gradient of the block's input, against the reference's."""
    rng = np.random.default_rng(7)
    spec = JA.attention_spec(16, 4, 2, 8, qkv_bias=True)
    jp = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
        spec, is_leaf=lambda s: hasattr(s, 'shape'))
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    kw = dict(n_heads=4, n_kv_heads=2, head_dim=8, impl='flash', q_chunk=4,
              k_chunk=8)

    def jloss(xx):
        y, _ = JA.attention_block(jp, xx, positions=jnp.asarray(pos),
                                  path='attn', **kw)
        return jnp.sum(jnp.sin(y)), y
    (_, jy), jgx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    from repro_torch.models import module as M
    tp = M.add_prefix(M.params_from_numpy(jp, 'cpu'), 'attn')
    tx = _t(x).requires_grad_(True)
    y, _ = A.attention_block(tp, tx, positions=_t(pos), path='attn', **kw)
    (gx,) = torch.autograd.grad(torch.sin(y).sum(), [tx])
    _close_rel(y, jy, 'block out')
    _close_rel(gx, jgx, 'block grad x')
