"""The port's band partial ``matvec_cols[_stacked]`` (kernel rows 9-10)
against the JAX Pallas kernels in interpret mode, and the port's own band
split (``factor_sharded._band`` / ``_matvec_partial``) at W = 1, 2, 4.

On a CPU tensor ``impl='auto'`` runs the plain version ``matvec_cols_ref``
and launches nothing; ``impl='cuda'`` and the kernel wrappers raise.  The
CUDA kernel is held against the same plain version on the card (marked
``gpu``, and by ``chip_smoke.py``).

Tolerances: an output is held to 1e-5 of its own scale Σ_k |a_rk G_kc|
against the Pallas kernel (both add in f32, in other orders; the bf16 G is
the same bf16 values in both), as the matvec rows of
``tests/test_torch_eva_f_kernels.py``.  Band partials summed over W bands
are held to the W=1 product within the same 1e-5 of scale, and to the
float64 product within ``tests/test_kernels.py``'s atol 1e-4·√m,
rtol 1e-4.  Stacked against per item: bit for bit.
"""
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import matvec as jmv  # noqa: E402
from repro_torch.core import factor_sharded as fsh  # noqa: E402
from repro_torch.kernels import dispatch, launches, ref  # noqa: E402
from repro_torch.kernels import matvec as mv  # noqa: E402

SHAPES = [(64, 48), (200, 136), (512, 384)]   # tests/test_kernels.py
DTYPES = ['float32', 'bfloat16']
R = 5
BLOCK = dict(block_in=128, block_out=128)
SCALE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_launches():
    """On CPU tensors the dispatch must take the plain path: no launches."""
    launches.reset()
    yield
    assert launches.snapshot() == {k: 0 for k in launches.COUNTS}


def _mk(m, n, dtype, lead=(), seed=0):
    """The same band g (m, n) and vectors a (R, m) for both packages, from
    numpy f32 draws; g rounded to ``dtype`` by each framework."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(lead + (m, n), dtype=np.float32)
    a = rng.standard_normal(lead + (R, m), dtype=np.float32)
    jx = (jnp.asarray(g, dtype), jnp.asarray(a))
    tx = (torch.from_numpy(g).to(getattr(torch, dtype)), torch.from_numpy(a))
    assert np.array_equal(np.asarray(jx[0], np.float32), tx[0].float().numpy())
    return jx, tx


def _scale(g, a):
    return ref.matvec_cols_ref(g.abs(), a.abs()).numpy()


@pytest.mark.parametrize('world', [1, 2, 4])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', SHAPES)
def test_matvec_cols_matches_pallas(shape, dtype, world):
    """Each band of a W-way split, through the dispatch, against the Pallas
    kernel on the same band; the partials summed against the whole
    product."""
    m, n = shape
    (jg, ja), (g, a) = _mk(m, n, dtype, seed=world)
    blk = -(-m // world)
    gp = torch.nn.functional.pad(g.float(), (0, 0, 0, world * blk - m))
    ap = torch.nn.functional.pad(a, (0, world * blk - m))
    jgp = jnp.pad(jg, ((0, world * blk - m), (0, 0)))
    jap = jnp.pad(ja, ((0, 0), (0, world * blk - m)))
    total = np.zeros((R, n), np.float32)
    for w in range(world):
        rows = slice(w * blk, (w + 1) * blk)
        band, vecs = gp[rows].to(g.dtype).contiguous(), ap[:, rows]
        want = np.asarray(jmv.matvec_cols(jgp[rows], jap[:, rows], **BLOCK))
        got = dispatch.matvec_cols(band, vecs.contiguous()).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape == (R, n)
        assert np.all(np.abs(got - want) <= SCALE_TOL * _scale(band, vecs))
        total += got
    whole = np.asarray(a, np.float64) @ np.asarray(g.float(), np.float64)
    np.testing.assert_allclose(total, whole, atol=1e-4 * m ** 0.5,
                               rtol=1e-4)


@pytest.mark.parametrize('dtype', DTYPES)
def test_matvec_cols_stacked_matches_pallas(dtype):
    (jg, ja), (g, a) = _mk(100, 136, dtype, lead=(3,), seed=4)
    want = np.asarray(jmv.matvec_cols_stacked(jg, ja, block_in=64,
                                              block_out=64))
    got = dispatch.matvec_cols_stacked(g, a).numpy()
    assert got.shape == want.shape == (3, R, 136)
    assert np.all(np.abs(got - want) <= SCALE_TOL * _scale(g, a))
    for i in range(3):
        assert np.array_equal(dispatch.matvec_cols(g[i], a[i]).numpy(),
                              got[i])


@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('lead', [(), (3,)])
def test_band_partials_sum_to_the_whole_product(world, lead):
    """``_band`` + ``_matvec_partial`` with explicit ranks, summed over the
    W bands, equal the W=1 product — the factor-sharding invariant, on a
    symmetric factor whose dim W does not divide."""
    rng = np.random.default_rng(7)
    d = 203
    x = rng.standard_normal(lead + (d, d), dtype=np.float32)
    fac = torch.from_numpy(x + np.swapaxes(x, -1, -2))
    y = torch.from_numpy(rng.standard_normal(lead + (R, d), dtype=np.float32))
    one = fsh._matvec_partial(fsh._band(fac, 1, None), y, 1, None)
    parts = [fsh._matvec_partial(fsh._band(fac, world, r), y, world, r)
             for r in range(world)]
    blk = -(-d // world)
    assert all(p.shape == lead + (R, d) for p in parts)
    assert fsh._band(fac, world, world - 1).shape == lead + (blk, d)
    total = sum(parts)
    assert torch.all((total - one).abs()
                     <= SCALE_TOL * ref.matvec_cols_ref(fac.abs(), y.abs()))
    whole = np.asarray(y, np.float64) @ np.asarray(fac, np.float64)
    np.testing.assert_allclose(total.numpy(), whole, atol=1e-4 * d ** 0.5,
                               rtol=1e-4)


def test_cuda_impl_refuses_cpu_tensors():
    g, a = torch.zeros(4, 6), torch.zeros(2, 4)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.matvec_cols(g, a, impl='cuda')
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.matvec_cols_stacked(g[None], a[None], impl='cuda')
    with pytest.raises(ValueError, match='CUDA tensor'):
        mv.matvec_cols(g, a)
    with pytest.raises(ValueError, match='CUDA tensor'):
        mv.matvec_cols_stacked(g[None], a[None])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fsh._matvec_partial(g[:, :4], a, 1, None, impl='cuda')


def _outputs_per_cell(R, n, plan):
    """How many (block, thread, register) slots of the kernel's tiling
    write each output of U (R, n): block (x, y), thread (ty, tx), register
    (i, h, j) owns row y·BM + ty·TM + i and column x·BN + 4·tx + h·BN/2 + j
    (csrc/matvec_cols.cu), written only inside (R, n)."""
    cfg, bm, bn, gx, gy = plan
    tm, tn, ty, tx = mv.COLS_TILES[cfg]
    assert (bm, bn) == (tm * ty, tn * tx)
    rows = (np.arange(gy)[:, None, None] * bm + np.arange(ty)[None, :, None]
            * tm + np.arange(tm)[None, None, :]).ravel()
    cols = (np.arange(gx)[:, None, None, None] * bn
            + 4 * np.arange(tx)[None, :, None, None]
            + np.arange(tn // 4)[None, None, :, None] * (bn // 2)
            + np.arange(4)[None, None, None, :]).ravel()
    count = np.zeros((R, n), np.int64)
    rr, cc = rows[rows < R], cols[cols < n]
    np.add.at(count, (rr[:, None], cc[None, :]), 1)
    return count


@pytest.mark.parametrize('rn', [(784, 1000), (500, 1000), (5, 48), (5, 136),
                                (5, 384), (10, 1000), (37, 131), (1, 1),
                                (3000, 77), (57, 129)])
def test_cols_plan_covers_every_output_once(rn):
    """The tile plan of ``matvec_cols_stacked`` writes each output exactly
    once, with no block wholly outside U, and is a function of (R, n) and
    the SM count alone."""
    R, n = rn
    for sms in (132, 114, 7):
        plan = mv.cols_plan(R, n, sms)
        _, bm, bn, gx, gy = plan
        assert (gx - 1) * bn < n <= gx * bn and (gy - 1) * bm < R <= gy * bm
        assert np.all(_outputs_per_cell(R, n, plan) == 1)
        assert plan == mv.cols_plan(R, n, sms)


def test_cols_plan_on_the_autoencoder_path():
    """On 132 SMs the two band products of the sharded autoencoder each
    fill one wave: 56x112 tiles at R = 784 (126 blocks), 64x64 at R = 500
    (128 blocks)."""
    assert mv.cols_plan(784, 1000) == (1, 56, 112, 9, 14)
    assert mv.cols_plan(500, 1000) == (0, 64, 64, 16, 8)


@pytest.mark.gpu
@pytest.mark.parametrize('rmn', [(784, 1000, 1000), (5, 200, 136),
                                 (3, 17, 5), (500, 1000, 1000),
                                 (37, 129, 131)])
def test_matvec_cols_matches_plain_on_card(rmn):
    """The CUDA kernel against its plain version, f32 and bf16, and stacked
    against per item bit for bit (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    r, m, n = rmn
    for dtype in DTYPES:
        rng = np.random.default_rng(11)
        g = torch.from_numpy(rng.standard_normal((2, m, n), dtype=np.float32))
        a = torch.from_numpy(rng.standard_normal((2, r, m), dtype=np.float32))
        g, a = g.to(getattr(torch, dtype)).cuda(), a.cuda()
        u = mv.matvec_cols_stacked(g, a)
        assert torch.all((u - ref.matvec_cols_ref(g, a)).abs()
                         <= SCALE_TOL * ref.matvec_cols_ref(g.abs(), a.abs()))
        for i in range(2):
            assert torch.equal(mv.matvec_cols(g[i], a[i]), u[i])
    launches.reset()
