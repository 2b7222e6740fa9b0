"""The port's Eva-f kernel dispatch against the JAX Pallas kernels
(interpret mode), kernel rows 6-8: matvec[_stacked] and eva_f_fused_stacked,
and the composed Eq. 21 op built on them.  On a CPU tensor ``impl='auto'``
runs the plain PyTorch versions (``matvec_ref``, ``eva_f_precondition_ref``,
``eva_f_fused_ref``) and launches nothing; ``impl='cuda'`` and the kernel
wrappers raise.  The CUDA kernels are held against the same plain versions
on the card (marked ``gpu``, and by ``chip_smoke.py``).

Tolerances: a matvec column is held to 1e-5 (f32) or 3e-2 (bf16) of its own
scale Σ|a_i G_ij|, as the bilinear sums of ``tests/test_kernels.py``; the
composed P to the same on the γ-scaled values; the fused output to 1e-6 on
the γ-scaled values and its aux to rtol 2e-5 / atol 1e-4, as
``tests/test_fused.py``.
"""
import pytest

torch = pytest.importorskip('torch')

import numpy as np  # noqa: E402

from test_torch_kernels import (BLOCK, DTYPES, GAMMA, MU, SHAPES,  # noqa: E402
                                TOL, _mk, _repeats_and_replays, _same_bits)

from repro.kernels import fused as jfused  # noqa: E402
from repro.kernels import matvec as jmv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import dispatch, launches, ops, ref  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.kernels import matvec as mv  # noqa: E402


@pytest.fixture(autouse=True)
def _no_launches():
    """On CPU tensors the dispatch must take the plain path: no launches."""
    launches.reset()
    yield
    assert launches.snapshot() == {k: 0 for k in launches.COUNTS}


def _matvec_scale(g, a):
    return ref.matvec_ref(g.abs(), a.abs()).numpy()


@pytest.mark.parametrize('stacked', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', SHAPES)
def test_matvec_matches_pallas(shape, dtype, stacked):
    lead = (2,) if stacked else ()
    (jg, ja, _, _), (g, a, _, _) = _mk(shape, dtype, lead, seed=5)
    if stacked:
        want = np.asarray(jmv.matvec_stacked(jg, ja, **BLOCK))
        u, asq = dispatch.matvec_and_norm_stacked(g, a)
    else:
        want = np.asarray(jmv.matvec(jg, ja, **BLOCK))
        u, asq = dispatch.matvec_and_norm(g, a)
    assert u.dtype == torch.float32 and u.shape == want.shape
    assert torch.equal(u, ref.matvec_ref(g, a))
    assert np.all(np.abs(u.numpy() - want) <= TOL[dtype] * _matvec_scale(g, a))
    np.testing.assert_allclose(asq.numpy(), np.sum(a.numpy() ** 2, -1),
                               rtol=1e-6)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', SHAPES)
def test_eva_f_precondition_matches_pallas(shape, dtype):
    """Eq. 21 composed from the matvec and rank-one kernels, a stack of two;
    and ``eva_f_precondition_ref``, the formula written out, beside it."""
    (jg, ja, _, _), (g, a, _, _) = _mk(shape, dtype, (2,), seed=6)
    want = np.asarray(jops.eva_f_precondition(jg, ja, GAMMA,
                                              impl='pallas_interpret'),
                      np.float32)
    for got in (ops.eva_f_precondition(g, a, GAMMA),
                ref.eva_f_precondition_ref(g, a, GAMMA)):
        assert got.dtype == g.dtype and got.shape == g.shape
        np.testing.assert_allclose(GAMMA * got.float().numpy(), GAMMA * want,
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', SHAPES)
def test_eva_f_fused_matches_pallas(shape, dtype, fold):
    (jg, ja, _, jm), (g, a, _, m) = _mk(shape, dtype, (2,), seed=7)
    want, want_aux = jfused.eva_f_fused_stacked(jg, ja, GAMMA, jm, MU,
                                                fold_momentum=fold, **BLOCK)
    got, aux = dispatch.eva_f_fused_stacked(g, a, GAMMA, m, MU, fold)
    assert got.dtype == torch.float32 and aux.shape == (2, 3)
    np.testing.assert_allclose(GAMMA * got.numpy(),
                               GAMMA * np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux),
                               rtol=2e-5, atol=1e-4)
    # the op layer folds a bucket's lead dims and keeps them on the way out
    o2, a2 = ops.eva_f_fused(g[None], a[None], GAMMA, m[None], MU, fold)
    assert torch.equal(o2[0], got) and torch.equal(a2[0], aux)


@pytest.mark.parametrize('method', ['eva', 'eva_f'])
def test_fused_without_fold_needs_no_momentum(method):
    """Without the fold the fused ops read no momentum buffer: m=None gives
    the same bits as any m, and the update path passes None."""
    _, (g, a, b, m) = _mk((64, 48), 'float32', (3,), seed=10)
    if method == 'eva':
        call = lambda m_: ops.eva_fused(g, a, b, GAMMA, m_, MU, False)
    else:
        call = lambda m_: ops.eva_f_fused(g, a, GAMMA, m_, MU, False)
    out, aux = call(None)
    want, want_aux = call(m)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)


@pytest.mark.parametrize('impl', ['auto', 'cuda', 'torch'])
def test_eva_f_dispatch_impls_on_cpu(impl):
    """'auto' and 'torch' take the plain path for CPU tensors, bit for bit;
    'cuda' refuses them."""
    _, (g, a, _, m) = _mk((64, 48), 'float32', (3,), seed=8)
    if impl == 'cuda':
        for call in (lambda: dispatch.matvec_and_norm_stacked(g, a, impl),
                     lambda: dispatch.eva_f_fused_stacked(g, a, GAMMA, m, MU,
                                                          impl=impl),
                     lambda: ops.eva_f_precondition(g, a, GAMMA, impl)):
            with pytest.raises(ValueError, match="'cuda' needs CUDA tensors"):
                call()
        return
    u, asq = dispatch.matvec_and_norm_stacked(g, a, impl=impl)
    want_u, want_asq = ref.matvec_and_norm_ref(g, a)
    assert torch.equal(u, want_u) and torch.equal(asq, want_asq)
    out, aux = dispatch.eva_f_fused_stacked(g, a, GAMMA, m, MU, impl=impl)
    r_out, r_aux = ref.eva_f_fused_ref(g, a, GAMMA, m, MU)
    assert torch.equal(out, r_out) and torch.equal(aux, r_aux)


@pytest.mark.gpu
@pytest.mark.parametrize('shape', [(3, 1000, 1000), (1, 250, 30),
                                   (2, 129, 127), (1, 1000, 513)])
def test_eva_f_kernels_match_plain_on_card(shape):
    """The CUDA matvec and fused Eva-f kernels against their plain versions,
    the fused kernel against the composed kernels, and stacked against per
    item bit for bit (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    _, (g, a, _, m) = _mk(shape[1:], 'float32', shape[:1], seed=9)
    g, a, m = (x.cuda() for x in (g, a, m))
    u, asq = mv.matvec_and_norm_stacked(g, a)
    assert torch.all((u - ref.matvec_ref(g, a)).abs()
                     <= 1e-5 * ref.matvec_ref(g.abs(), a.abs()))
    torch.testing.assert_close(asq, (a * a).sum(-1), atol=0, rtol=1e-5)
    for fold in (False, True):
        out, aux = fused.eva_f_fused_stacked(g, a, GAMMA, m, MU, fold)
        r_out, r_aux = ref.eva_f_fused_ref(g, a, GAMMA, m, MU, fold)
        torch.testing.assert_close(GAMMA * out, GAMMA * r_out, atol=1e-6,
                                   rtol=1e-6)
        torch.testing.assert_close(aux, r_aux, atol=1e-4, rtol=2e-5)
    out, _ = fused.eva_f_fused_stacked(g, a, GAMMA, m, MU, False)
    assert torch.equal(fused.eva_f_fused_stacked(g, a, GAMMA, None, MU,
                                                 False)[0], out)
    comp = ops.eva_f_precondition(g, a, GAMMA, impl='cuda')
    torch.testing.assert_close(GAMMA * out, GAMMA * comp, atol=1e-6,
                               rtol=1e-6)
    for i in range(shape[0]):
        sl = slice(i, i + 1)
        u1, asq1 = mv.matvec_and_norm_stacked(g[sl], a[sl])
        assert torch.equal(u1, u[sl]) and torch.equal(asq1, asq[sl])
        o1, _ = fused.eva_f_fused_stacked(g[sl], a[sl], GAMMA, m[sl], MU,
                                          False)
        assert torch.equal(o1, out[sl])
    launches.reset()


@pytest.mark.parametrize('shape', [(784, 1000), (1000, 784), (250, 30),
                                   (30, 250), (129, 127), (1000, 513),
                                   (3000, 2)])
def test_matvec_plan(shape):
    """The matvec partition depends on (d_in, d_out) alone: one block per
    strip of MV_COLS columns, a warp for every MV_SUB chunks of MV_ROWS
    rows, at most MV_WARPS warps a block (more chunks take more rounds)."""
    d_in, d_out = shape
    blocks, warps = mv.matvec_plan(d_in, d_out)
    assert (blocks - 1) * mv.MV_COLS < d_out <= blocks * mv.MV_COLS
    chunks = -(-d_in // mv.MV_ROWS)
    assert 1 <= warps <= mv.MV_WARPS
    assert warps == mv.MV_WARPS or (warps - 1) * mv.MV_SUB < chunks
    assert warps * mv.MV_SUB >= min(chunks, mv.MV_WARPS * mv.MV_SUB)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(3, 1000, 1000), (2, 129, 127)])
def test_matvec_stacked_repeats_and_replays_on_card(shape, dtype):
    """The one-launch matvec: u within 1e-5 of each column's scale and ‖a‖²
    within rtol 1e-5 of the plain version, a stack equal to its items and
    to the unstacked form bit for bit, and repeated calls and graph replays
    the same bits (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    _, (g, a, _, _) = _mk(shape[1:], dtype, shape[:1], seed=12)
    g, a = g.cuda(), a.cuda()
    u, asq = _repeats_and_replays(lambda: mv.matvec_and_norm_stacked(g, a))
    assert torch.all((u - ref.matvec_ref(g, a)).abs()
                     <= 1e-5 * ref.matvec_ref(g.abs(), a.abs()))
    torch.testing.assert_close(asq, (a * a).sum(-1), atol=0, rtol=1e-5)
    for i in range(shape[0]):
        sl = slice(i, i + 1)
        assert _same_bits(mv.matvec_and_norm_stacked(g[sl], a[sl]),
                          (u[sl], asq[sl]))
        assert _same_bits(mv.matvec_and_norm(g[i], a[i]), (u[i], asq[i]))
    launches.reset()


@pytest.mark.parametrize('shape', [(784, 1000), (1000, 784), (250, 30),
                                   (30, 250), (129, 127), (1000, 513),
                                   (3000, 2)])
def test_eva_f_fused_plan(shape):
    """The two launches of fused Eva-f: matvec's partition, then eva_fused's
    emit partition of EF_TILE-element blocks; the workspace holds u, ‖a‖²
    and one aux partial of three values a block, and one counter an item.
    Depends on (d_in, d_out) alone."""
    d_in, d_out = shape
    blocks, scratch = fused.eva_f_fused_plan(d_in, d_out)
    assert blocks == fused.eva_fused_plan(d_in, d_out)[2]
    assert ((blocks - 1) * fused.EF_TILE < d_in * d_out
            <= blocks * fused.EF_TILE)
    assert scratch == d_out + 1 + 3 * blocks
    if shape == (784, 1000):
        assert blocks >= 4 * mv.H100_SMS


@pytest.mark.gpu
@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(1, 784, 1000), (3, 1000, 1000),
                                   (2, 129, 127)])
def test_eva_f_fused_repeats_replays_and_matches_composed_on_card(
        shape, dtype, fold):
    """The two-launch fused Eva-f kernel: repeated calls and graph replays
    give the same bits, a stack equals its items bit for bit (the second
    item of 2 x 129 x 127 sits 4 bytes off a 16-byte boundary), and on f32
    G without the fold out equals composed Eva-f (matvec + rank1_update)
    bit for bit (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    _, (g, a, _, m) = _mk(shape[1:], dtype, shape[:1], seed=14)
    g, a, m = g.cuda(), a.cuda(), m.cuda()
    m = m if fold else None
    out, aux = _repeats_and_replays(
        lambda: fused.eva_f_fused_stacked(g, a, GAMMA, m, MU, fold))
    r_out, r_aux = ref.eva_f_fused_ref(g, a, GAMMA, m, MU, fold)
    torch.testing.assert_close(GAMMA * out, GAMMA * r_out, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(aux, r_aux, atol=1e-4, rtol=2e-5)
    for i in range(shape[0]):
        sl = slice(i, i + 1)
        assert _same_bits(fused.eva_f_fused_stacked(
            g[sl], a[sl], GAMMA, None if m is None else m[sl], MU, fold),
            (out[sl], aux[sl]))
    if dtype == 'float32' and not fold:
        assert torch.equal(ops.eva_f_precondition(g, a, GAMMA, impl='cuda'),
                           out)
    launches.reset()
