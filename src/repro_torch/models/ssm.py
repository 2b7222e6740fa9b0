"""Mamba-2 (SSD, state-space duality) block — PyTorch port of
``repro/models/ssm.py``.

SSD runs in its chunked matmul form: attention-like matmuls inside each
chunk, and the state carried from chunk to chunk by a recurrence (the
reference's ``lax.scan`` over chunks is a loop here).  The chunk length is
a config knob.  ``ssd_chunked`` runs CUDA tensors through the kernels of
``kernels/ssd.py``; CPU tensors and DTensors (the sharded layouts) take the
plain version, ``ssd_plain``, which the tests hold the kernels to.

Preconditioning: ``in_proj`` and ``out_proj`` are capture-aware linears
(Eva applies); conv, ``A_log``, ``D`` and ``dt_bias`` are SSM-internal and
take the first-order fall-through.

Decode is O(1) in context length: the whole history lives in the (H, N, P)
state and the (K-1)-deep conv buffer.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import launch
from repro_torch.kernels import ssd as ssd_kernels
from repro_torch.models.layers import linear, linear_spec, rmsnorm
from repro_torch.models.module import ParamSpec
from repro_torch.obs import spans as obs_spans
from repro_torch.sharding.constraints import constrain

F32 = torch.float32


def ssm_dims(d_model: int, expand: int = 2, headdim: int = 64,
             d_state: int = 128, d_conv: int = 4):
    d_inner = expand * d_model
    nheads = d_inner // headdim
    conv_ch = d_inner + 2 * d_state  # x + B + C (ngroups=1)
    return d_inner, nheads, conv_ch


def mamba_spec(d_model: int, *, expand: int = 2, headdim: int = 64,
               d_state: int = 128, d_conv: int = 4,
               dtype=torch.float32) -> dict:
    d_inner, nheads, conv_ch = ssm_dims(d_model, expand, headdim, d_state,
                                        d_conv)
    d_in_proj = 2 * d_inner + 2 * d_state + nheads  # z, x, B, C, dt
    return {
        'in_proj': linear_spec(d_model, d_in_proj, False, dtype,
                               ('embed', 'inner')),
        'conv_w': ParamSpec((d_conv, conv_ch), dtype, init='scaled',
                            axes=(None, 'inner')),
        'conv_b': ParamSpec((conv_ch,), dtype, init='zeros',
                            axes=('inner',)),
        'A_log': ParamSpec((nheads,), torch.float32, init='ones',
                           axes=('heads',)),
        'dt_bias': ParamSpec((nheads,), torch.float32, init='zeros',
                             axes=('heads',)),
        'D': ParamSpec((nheads,), torch.float32, init='ones',
                       axes=('heads',)),
        'norm': {'scale': ParamSpec((d_inner,), dtype, init='ones',
                                    axes=('inner',))},
        'out_proj': linear_spec(d_inner, d_model, False, dtype,
                                ('inner', 'embed')),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d in f32.  x: (B, S, Ch); w: (K, Ch)."""
    k, ch = w.shape
    xp = F.pad(x.to(F32).transpose(1, 2), (k - 1, 0))        # (B, Ch, S+K-1)
    out = F.conv1d(xp, w.to(F32).T[:, None, :], groups=ch)    # (B, Ch, S)
    return (out.transpose(1, 2) + b.to(F32)).to(x.dtype)


def _takes_kernels(x: torch.Tensor) -> bool:
    """A CUDA tensor that is not a DTensor (a DTensor keeps the plain scan,
    which DTensor lays out on the mesh)."""
    from torch.distributed.tensor import DTensor
    return x.is_cuda and not isinstance(x, DTensor)


def ssd_chunked(x, dt, a, bmat, cmat, d_skip, chunk: int = 256):
    """SSD forward.  x: (B,S,H,P); dt: (B,S,H); a: (H,) (negative);
    bmat/cmat: (B,S,N); d_skip: (H,).  Returns (y, final_state (B,H,N,P)).
    CUDA tensors take the kernels (a fake one, the cost trace's, records
    one custom call); the rest ``ssd_plain``."""
    if not _takes_kernels(x):
        return ssd_plain(x, dt, a, bmat, cmat, d_skip, chunk)
    if launch.is_fake_cuda(x):
        return launch.fake_call('ssd', ssd_plain, x, dt, a, bmat, cmat,
                                d_skip, chunk)
    return ssd_kernels.ssd(x, dt, a, bmat, cmat, d_skip, chunk)


def ssd_plain(x, dt, a, bmat, cmat, d_skip, chunk: int = 256):
    """The plain version of ``ssd_chunked``, in f32."""
    return ssd_plain_in(F32, x, dt, a, bmat, cmat, d_skip, chunk)


def ssd_plain_in(dtype, x, dt, a, bmat, cmat, d_skip, chunk: int = 256):
    """``ssd_plain`` computed in ``dtype`` (float64 on float64 inputs: the
    truth ``chip_smoke.py`` holds the f32 versions to)."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        # right-pad with dt=0 steps: exp(dt·A)=1 and dt·B·x=0, so padded
        # positions are identities on the carried state (outputs sliced off)
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    s_padded = s + pad
    nc = s_padded // chunk

    xc = x.reshape(bsz, nc, chunk, h, p).to(dtype)
    dtc = dt.reshape(bsz, nc, chunk, h).to(dtype)
    bc = bmat.reshape(bsz, nc, chunk, n).to(dtype)
    cc = cmat.reshape(bsz, nc, chunk, n).to(dtype)

    dta = dtc * a                                            # (b,c,q,h) ≤ 0
    seg = torch.cumsum(dta, dim=2)                           # within-chunk
    total = seg[:, :, -1, :]                                 # (b,c,h)

    # intra-chunk (attention-like): L[q,k] = exp(seg_q - seg_k) for q >= k.
    # The mask goes in before the exp: above the diagonal seg_q - seg_k > 0
    # grows with the chunk (hundreds at 256), its exp overflows, and the
    # backward of a mask applied after it is inf·0 = NaN.  The reference
    # masks after the exp; the values are the same.
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]      # (b,c,q,k,h)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    l_mat = torch.exp(torch.where(causal[:, :, None], rel, -torch.inf))
    cb = torch.einsum('bcqn,bckn->bcqk', cc, bc)
    m = cb[..., None] * l_mat * dtc[:, :, None, :, :]        # (b,c,q,k,h)
    y_intra = torch.einsum('bcqkh,bckhp->bcqhp', m, xc)

    # chunk -> carried state:  S_c = Σ_k exp(total - seg_k)·dt_k·B_k ⊗ x_k
    decay_out = torch.exp(total[:, :, None, :] - seg)        # (b,c,q,h)
    s_chunk = torch.einsum('bckn,bckh,bckhp->bchnp', bc, decay_out * dtc, xc)

    # inter-chunk recurrence: the state *entering* each chunk
    state = torch.zeros((bsz, h, n, p), dtype=dtype, device=x.device)
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * torch.exp(total[:, c])[:, :, None, None] + \
            s_chunk[:, c]
    states_in = torch.stack(states_in, 1)                    # (b,c,h,n,p)

    y_inter = torch.einsum('bcqn,bchnp,bcqh->bcqhp', cc, states_in,
                           torch.exp(seg))
    y = (y_intra + y_inter).reshape(bsz, s_padded, h, p)
    y = y + x.to(dtype) * d_skip[:, None]
    if pad:
        y = y[:, :s]
    return y.to(x.dtype), state


def mamba_block(p, x, *, headdim: int = 64, d_state: int = 128,
                d_conv: int = 4, chunk: int = 256,
                cache: Optional[dict] = None, return_cache: bool = False,
                path: str = '', col=None, taps=None, capture=None,
                compute_dtype=None):
    """Returns (y, new_cache).  ``p`` is a flat dict holding
    ``f'{path}/in_proj/w'``, ``f'{path}/conv_w'`` and the rest.  cache =
    {'conv': (B,K-1,Ch), 'ssm': (B,H,N,P)}: with one, x is one token (decode:
    the conv buffer rolls and the state takes one recurrent step).
    ``return_cache=True`` (prefill) emits the cache from a cache-free
    forward: the final SSD state and the last (K-1) pre-conv inputs.
    Without a cache the scan runs under a span ``ssd``, and while tracing
    is on (``obs/spans.py``) each call counts 1 in ``ssd.kernel/<path>``
    where it takes the kernels, else 0.  On the card the kernels take
    (chunk, d_state, headdim) in ``kernels/ssd.py::SHAPES`` (the defaults
    among them), and raise on any other, naming it; a config's
    ``ssm_chunk`` (128 unless it sets one) must be one of them there."""
    col = col if col is not None else {}
    bsz, s, _ = x.shape
    d_inner = p[f'{path}/norm/scale'].shape[0]
    nheads = p[f'{path}/A_log'].shape[0]
    conv_w, conv_b = p[f'{path}/conv_w'], p[f'{path}/conv_b']
    d_skip = p[f'{path}/D'].to(F32)
    kw = dict(col=col, taps=taps, capture=capture, compute_dtype=compute_dtype)

    zxbcdt = linear(p, x, path=f'{path}/in_proj', **kw)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * d_state,
                                      nheads], dim=-1)

    if cache is None:
        xbc_raw = xbc
        xbc = F.silu(_causal_conv(xbc, conv_w, conv_b))
        if _takes_kernels(xbc):
            # the conv leaves the channels along the positions; the scan's
            # kernels read each position's channels as one row (faster
            # than reading the conv's layout in place, with this copy)
            xbc = xbc.contiguous()
    else:
        # decode: roll the conv buffer (S == 1)
        buf = torch.cat([cache['conv'], xbc.to(cache['conv'].dtype)], 1)
        conv_out = torch.einsum('bkc,kc->bc', buf.to(F32), conv_w.to(F32)) \
            + conv_b.to(F32)
        xbc = F.silu(conv_out)[:, None, :].to(x.dtype)
        new_conv = buf[:, 1:, :]

    xs, bmat, cmat = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    xh = xs.reshape(bsz, s, nheads, headdim)
    # the SSD heads are a batch dim of the chunk products: pin them to the
    # model axis so those products shard instead of replicating
    xh = constrain(xh, 'data', None, 'model', None)
    a = -torch.exp(p[f'{path}/A_log'].to(F32))
    dt = F.softplus(dt.to(F32) + p[f'{path}/dt_bias'].to(F32))
    dt = constrain(dt, 'data', None, 'model')

    if cache is None:
        tracker = obs_spans.tracing()
        if tracker is not None:
            tracker.count(f'ssd.kernel/{path}', int(_takes_kernels(xh)))
        with obs_spans.span('ssd'):
            y, final_state = ssd_chunked(xh, dt, a, bmat, cmat, d_skip,
                                         chunk=chunk)
        new_cache = None
        if return_cache:
            pad = d_conv - 1
            tail = xbc_raw[:, -pad:, :] if s >= pad else \
                F.pad(xbc_raw, (0, 0, pad - s, 0))
            new_cache = {'conv': tail, 'ssm': final_state}
    else:
        # recurrent single-step update
        da = torch.exp(dt[:, 0, :] * a)                      # (B,H)
        dbx = torch.einsum('bn,bh,bhp->bhnp', bmat[:, 0].to(F32), dt[:, 0],
                           xh[:, 0].to(F32))
        state = cache['ssm'] * da[:, :, None, None] + dbx
        y0 = torch.einsum('bn,bhnp->bhp', cmat[:, 0].to(F32), state)
        y0 = y0 + xh[:, 0].to(F32) * d_skip[:, None]
        y = y0[:, None].to(x.dtype)
        new_cache = {'conv': new_conv,
                     'ssm': state.to(cache['ssm'].dtype)}

    y = y.reshape(bsz, s, d_inner)
    y = rmsnorm({'scale': p[f'{path}/norm/scale']},
                y.to(x.dtype) * F.silu(z).to(x.dtype))
    return linear(p, y, path=f'{path}/out_proj', **kw), new_cache
