"""Mamba-2 language model (family ``ssm``): pre-norm residual blocks of one
Mamba-2 mixer each (input projection to z, x, B, C and dt; a depthwise
causal convolution over x, B and C; the state-space dual scan computed in
chunks; a gated RMSNorm; the output projection), a final RMSNorm and the
head tied to the embedding."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (F32, Tape, cross_entropy, linear,
                                        rmsnorm, run_layers, stack_tapes)


def dims(cfg: dict) -> tuple[int, int, int, int]:
    """(d_inner, heads, conv channels, in_proj width), one group of B and
    C."""
    d_inner = cfg['ssm_expand'] * cfg['d_model']
    heads = d_inner // cfg['ssm_headdim']
    conv_ch = d_inner + 2 * cfg['ssm_state']
    return d_inner, heads, conv_ch, 2 * d_inner + 2 * cfg['ssm_state'] + heads


def _check(cfg: dict) -> None:
    if not cfg.get('tie_embeddings') or cfg.get('norm', 'rms') != 'rms':
        raise ValueError('the ssm reference has a tied head and RMSNorm')


def param_specs(cfg: dict) -> dict:
    """{path: (shape, dtype name, init, arg)} (``harness/weights.py``), the
    weights drawn as the published Mamba-2 initialises them: the embedding
    N(0, 0.02²); the projections and the conv PyTorch's default U(±1/√fan_in)
    (the conv's fan-in is its width), out_proj then divided by √n_layers
    (``rescale_prenorm_residual``); A = −exp(A_log) with A ~ U(1, 16); dt_bias
    the inverse softplus of dt = exp(U(log 1e-3, log 1e-1)); D and the norms
    1.  The scan's A_log, dt_bias and D are float32 whatever the parameter
    dtype."""
    _check(cfg)
    n, d, pd = cfg['n_layers'], cfg['d_model'], cfg['param_dtype']
    d_inner, heads, conv_ch, d_proj = dims(cfg)
    k = cfg['ssm_conv']
    return {
        'embed/table': ((cfg['vocab'], d), pd, 'normal', 0.02),
        'blocks/norm/scale': ((n, d), pd, 'ones', None),
        'blocks/mixer/in_proj/w': ((n, d, d_proj), pd, 'uniform', d ** -0.5),
        'blocks/mixer/conv_w': ((n, k, conv_ch), pd, 'uniform', k ** -0.5),
        'blocks/mixer/conv_b': ((n, conv_ch), pd, 'uniform', k ** -0.5),
        'blocks/mixer/A_log': ((n, heads), 'float32', 'log_uniform',
                               (1.0, 16.0)),
        'blocks/mixer/dt_bias': ((n, heads), 'float32', 'inv_softplus',
                                 (1e-3, 1e-1)),
        'blocks/mixer/D': ((n, heads), 'float32', 'ones', None),
        'blocks/mixer/norm/scale': ((n, d_inner), pd, 'ones', None),
        'blocks/mixer/out_proj/w': ((n, d_inner, d), pd, 'uniform',
                                    (d_inner * n) ** -0.5),
        'norm_f/scale': ((d,), pd, 'ones', None),
    }


def precon_paths(cfg: dict) -> list:
    """Eva preconditions the two projections; the tied head is the
    embedding, which it leaves alone."""
    return ['blocks/mixer/in_proj/w', 'blocks/mixer/out_proj/w']


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """out[t] = b + Σ_j w[j] · x[t − (K−1) + j], zeros before the start.
    x (B, S, C); w (K, C)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return b + sum(w[j] * xp[:, j:j + s] for j in range(k))


def ssd(x, dt, a, bm, cm, chunk: int):
    """y_t = Σ_{r≤t} (C_t·B_r) exp(Σ_{r<u≤t} dt_u a) dt_r x_r, worked in
    chunks of ``chunk`` positions: within a chunk as a masked product, across
    chunks through the state carried from one to the next.  x (B, S, H, P),
    dt (B, S, H), a (H,), bm and cm (B, S, N)."""
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:     # dt = 0 past the end: the state passes through unchanged
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    c = (s + pad) // q
    x, dt = x.reshape(bsz, c, q, h, p), dt.reshape(bsz, c, q, h)
    bm, cm = bm.reshape(bsz, c, q, n), cm.reshape(bsz, c, q, n)
    cum = torch.cumsum(dt * a, dim=2)                        # (b, c, q, h)

    lower = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b, c, q, r, h)
    decay = torch.exp(rel.masked_fill(~lower[:, :, None], float('-inf')))
    cb = torch.einsum('bcqn,bcrn->bcqr', cm, bm)
    y = torch.einsum('bcqrh,bcrhp->bcqhp',
                     cb[..., None] * decay * dt[:, :, None], x)

    to_end = torch.exp(cum[:, :, -1:, :] - cum) * dt         # (b, c, q, h)
    local = torch.einsum('bcrn,bcrh,bcrhp->bchnp', bm, to_end, x)
    state = torch.zeros((bsz, h, n, p), dtype=F32, device=x.device)
    entering = []
    for i in range(c):
        entering.append(state)
        state = state * torch.exp(cum[:, i, -1])[:, :, None, None] \
            + local[:, i]
    y = y + torch.einsum('bcqn,bchnp,bcqh->bcqhp', cm,
                         torch.stack(entering, 1), torch.exp(cum))
    return y.reshape(bsz, c * q, h, p)[:, :s]


def _block(cfg, p, tape, x):
    bsz, s, _ = x.shape
    d_inner, heads, _, _ = dims(cfg)
    n = cfg['ssm_state']
    r = tape.r
    zxbcdt = linear(r(rmsnorm(x, p['norm/scale'])), p['mixer/in_proj/w'],
                    'mixer/in_proj/w', tape)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, heads], -1)
    xbc = r(F.silu(r(causal_conv(xbc, p['mixer/conv_w'],
                                 p['mixer/conv_b']))))
    xs, bm, cm = torch.split(xbc, [d_inner, n, n], -1)
    xh = xs.reshape(bsz, s, heads, cfg['ssm_headdim'])
    a = -torch.exp(p['mixer/A_log'])
    dt = F.softplus(dt + p['mixer/dt_bias'])
    y = r(ssd(xh, dt, a, bm, cm, cfg['ssm_chunk'])
          + xh * p['mixer/D'][:, None])
    y = r(rmsnorm(r(y.reshape(bsz, s, d_inner) * r(F.silu(z))),
                  p['mixer/norm/scale']))
    return r(x + linear(y, p['mixer/out_proj/w'], 'mixer/out_proj/w',
                        tape)), torch.zeros((), dtype=F32, device=x.device)


def loss(cfg: dict, params: dict, batch: dict, taps, quant=None):
    """(loss, ā, counts, tokens) as ``moe.loss`` gives them."""
    tokens = batch['tokens'].long()
    b, s = tokens.shape
    table, top = params['embed/table'], Tape(None, quant)
    x = top.r(F.embedding(tokens, table))
    x, _, tapes = run_layers(lambda p, tape, h: _block(cfg, p, tape, h), x,
                             cfg['n_layers'], params, taps, quant)
    a, count = stack_tapes(tapes)
    h = top.r(rmsnorm(x, params['norm_f/scale']))
    logits = top.r(h @ top.r(table.T))
    return cross_entropy(logits, batch['labels']), a, count, b * s


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one forward and backward: 6 x the matmul weights a
    token passes through (in_proj, out_proj, the tied head) x tokens, plus
    the scan's chunk products, forward and backward (3x): C·Bᵀ (2 q² N), the
    masked product with x (2 q² H P), the chunk states and their read-out
    (2 x 2 q N H P), a chunk of q positions.  Recomputation is not
    counted."""
    d_inner, heads, _, d_proj = dims(cfg)
    d, n, p = cfg['d_model'], cfg['ssm_state'], cfg['ssm_headdim']
    weights = cfg['n_layers'] * (d * d_proj + d_inner * d) \
        + d * cfg['vocab']
    q = min(cfg['ssm_chunk'], seq)
    chunks = batch * (-(-seq // q))
    scan = 2 * q * q * n + 2 * q * q * heads * p + 4 * q * n * heads * p
    return 6.0 * weights * batch * seq + 3.0 * cfg['n_layers'] * chunks * scan
