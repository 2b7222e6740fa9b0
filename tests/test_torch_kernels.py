"""The port's kernel dispatch against the JAX Pallas kernels (interpret
mode), kernel rows 1-5: bilinear[_stacked], rank1_update[_stacked] and
eva_fused_stacked.  On a CPU tensor ``impl='auto'`` runs the plain PyTorch
version and launches nothing, ``impl='cuda'`` and the kernel wrappers raise;
the CUDA kernels themselves are held against the same plain versions on the
card (marked ``gpu``, and by ``chip_smoke.py``).

Tolerances: 1e-5 (f32) and 3e-2 (bf16) as ``tests/test_kernels.py``; a
bilinear sum is held against its own scale Σ|a_i G_ij b_j|; the fused output
to 1e-6 on the γ-scaled values and its aux to rtol 2e-5 / atol 1e-4, as
``tests/test_fused.py``.
"""
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import bilinear as jbil  # noqa: E402
from repro.kernels import fused as jfused  # noqa: E402
from repro.kernels import rank1_update as jr1  # noqa: E402
from repro_torch.kernels import bilinear as bil  # noqa: E402
from repro_torch.kernels import dispatch, launch, launches, ref  # noqa: E402
from repro_torch.kernels import fused  # noqa: E402
from repro_torch.kernels import matvec as mv  # noqa: E402
from repro_torch.kernels import rank1_update as r1  # noqa: E402

SHAPES = [(8, 8), (64, 48), (128, 128), (200, 136), (512, 384), (1000, 513)]
DTYPES = ['float32', 'bfloat16']
TOL = {'float32': 1e-5, 'bfloat16': 3e-2}
GAMMA, MU = 0.03, 0.9
BLOCK = dict(block_in=128, block_out=128)


def _mk(shape, dtype, lead=(), seed=0):
    """Same inputs for both packages: numpy f32 draws, g rounded to
    ``dtype`` by each framework (both round to nearest even)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(lead + shape, dtype=np.float32)
    a = rng.standard_normal(lead + shape[:1], dtype=np.float32)
    b = rng.standard_normal(lead + shape[1:], dtype=np.float32)
    m = rng.standard_normal(lead + shape, dtype=np.float32)
    jx = (jnp.asarray(g, dtype), jnp.asarray(a), jnp.asarray(b),
          jnp.asarray(m))
    tx = (torch.from_numpy(g).to(getattr(torch, dtype)), torch.from_numpy(a),
          torch.from_numpy(b), torch.from_numpy(m))
    assert np.array_equal(np.asarray(jx[0], np.float32), tx[0].float().numpy())
    return jx, tx


def _bilinear_scale(g, a, b):
    return ref.bilinear_ref(g.abs(), a.abs(), b.abs()).numpy()


@pytest.fixture(autouse=True)
def _no_launches():
    """On CPU tensors the wrappers must take the plain path: no launches."""
    launches.reset()
    yield
    assert launches.snapshot() == {k: 0 for k in launches.COUNTS}


@pytest.mark.parametrize('stacked', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', SHAPES)
def test_bilinear_matches_pallas(shape, dtype, stacked):
    lead = (2,) if stacked else ()
    (jg, ja, jb, _), (g, a, b, _) = _mk(shape, dtype, lead)
    if stacked:
        want = np.asarray(jbil.bilinear_stacked(jg, ja, jb, **BLOCK))
        got = dispatch.bilinear_and_norms_stacked(g, a, b)[0].numpy()
    else:
        want = np.asarray(jbil.bilinear(jg, ja, jb, **BLOCK))
        got = dispatch.bilinear_and_norms(g, a, b)[0].numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all(np.abs(got - want) <= TOL[dtype] * _bilinear_scale(g, a, b))


@pytest.mark.parametrize('stacked', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', SHAPES)
def test_rank1_update_matches_pallas(shape, dtype, stacked):
    lead = (2,) if stacked else ()
    (jg, ja, jb, _), (g, a, b, _) = _mk(shape, dtype, lead, seed=1)
    coeff = np.float32(0.37) + np.zeros(lead, np.float32)
    scale = np.float32(2.5) + np.zeros(lead, np.float32)
    c, s = torch.as_tensor(coeff), torch.as_tensor(scale)
    if stacked:
        want = jr1.rank1_update_stacked(jg, ja, jb, jnp.asarray(coeff),
                                        jnp.asarray(scale), **BLOCK)
        got = dispatch.rank1_update_stacked(g, a, b, c, s)
    else:
        want = jr1.rank1_update(jg, ja, jb, jnp.float32(0.37),
                                jnp.float32(2.5), **BLOCK)
        got = dispatch.rank1_update(g, a, b, c, s)
    assert got.dtype == g.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize('stacked', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(64, 48), (129, 127), (1000, 513)])
def test_rank1_update_coefficient_forms_agree(shape, dtype, stacked):
    """The two-tensor form (coeff, scale) and the reference's pair form
    (cs, None) of the dispatch give the same bits, and both match the
    Pallas kernel; the pair form may be a strided view."""
    lead = (3,) if stacked else ()
    (jg, ja, jb, _), (g, a, b, _) = _mk(shape, dtype, lead, seed=5)
    rng = np.random.default_rng(6)
    coeff = rng.standard_normal(lead, dtype=np.float32)
    scale = np.float32(1.5) + rng.random(lead, dtype=np.float32)
    c, s = torch.as_tensor(coeff), torch.as_tensor(scale)
    wide = torch.stack([c, torch.zeros_like(c), s], -1)
    cs = wide[..., ::2]                       # stride 2 between the pair
    fn = dispatch.rank1_update_stacked if stacked else dispatch.rank1_update
    jfn = jr1.rank1_update_stacked if stacked else jr1.rank1_update
    two, pair = fn(g, a, b, c, s), fn(g, a, b, cs)
    assert torch.equal(two, pair) and two.dtype == g.dtype
    want = jfn(jg, ja, jb, jnp.asarray(coeff), jnp.asarray(scale), **BLOCK)
    np.testing.assert_allclose(two.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', SHAPES)
def test_eva_fused_matches_pallas(shape, dtype, fold):
    (jg, ja, jb, jm), (g, a, b, m) = _mk(shape, dtype, (2,), seed=2)
    want, want_aux = jfused.eva_fused_stacked(jg, ja, jb, GAMMA, jm, MU,
                                              fold_momentum=fold, **BLOCK)
    got, aux = dispatch.eva_fused_stacked(g, a, b, GAMMA, m, MU, fold)
    assert got.dtype == torch.float32 and aux.shape == (2, 3)
    np.testing.assert_allclose(GAMMA * got.numpy(),
                               GAMMA * np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux),
                               rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize('impl', ['auto', 'cuda', 'torch'])
def test_dispatch_impls_agree_on_cpu(impl):
    """'auto' and 'torch' take the plain path for CPU tensors, bit for bit;
    'cuda' refuses them instead of running the plain path in its place."""
    _, (g, a, b, m) = _mk((64, 48), 'float32', (3,), seed=3)
    if impl == 'cuda':
        with pytest.raises(ValueError, match="'cuda' needs CUDA tensors"):
            dispatch.bilinear_and_norms_stacked(g, a, b, impl=impl)
        return
    dot, sq = dispatch.bilinear_and_norms_stacked(g, a, b, impl=impl)
    want_dot, want_sq = ref.bilinear_and_norms_ref(g, a, b)
    assert torch.equal(dot, want_dot) and torch.equal(sq, want_sq)
    c, s = dot / 7.0, torch.full_like(dot, 1 / GAMMA)
    assert torch.equal(dispatch.rank1_update_stacked(g, a, b, c, s, impl=impl),
                       ref.rank1_update_ref(g, a, b, c, s))
    out, aux = dispatch.eva_fused_stacked(g, a, b, GAMMA, m, MU, impl=impl)
    r_out, r_aux = ref.eva_fused_ref(g, a, b, GAMMA, m, MU)
    assert torch.equal(out, r_out) and torch.equal(aux, r_aux)


@pytest.mark.parametrize('wrapper', [
    lambda g, a, b, m: bil.bilinear_and_norms_stacked(g, a, b),
    lambda g, a, b, m: bil.bilinear_and_norms(g[0], a[0], b[0]),
    lambda g, a, b, m: bil.bilinear(g[0], a[0], b[0]),
    lambda g, a, b, m: r1.rank1_update_stacked(g, a, b, torch.ones(3, 2)),
    lambda g, a, b, m: r1.rank1_update_stacked(g, a, b, torch.ones(3),
                                               torch.ones(3)),
    lambda g, a, b, m: r1.rank1_update(g[0], a[0], b[0], torch.ones(()),
                                       torch.ones(())),
    lambda g, a, b, m: r1.rank1_update(g[0], a[0], b[0], torch.ones(2)),
    lambda g, a, b, m: fused.eva_fused_stacked(g, a, b, GAMMA, m, MU),
    lambda g, a, b, m: mv.matvec_and_norm_stacked(g, a),
    lambda g, a, b, m: fused.eva_f_fused_stacked(g, a, GAMMA, m, MU),
    lambda g, a, b, m: mv.matvec_cols_stacked(g, a[:, None]),
    lambda g, a, b, m: mv.matvec_cols(g[0], a[:2]),
    lambda g, a, b, m: fused.eva_f_fused_stacked(g, a, GAMMA, None, MU,
                                                 False),
], ids=['bilinear', 'bilinear_and_norms_unstacked', 'bilinear_unstacked',
        'rank1_update', 'rank1_update_two_tensors', 'rank1_update_unstacked',
        'rank1_update_unstacked_pair', 'eva_fused', 'matvec', 'eva_f_fused',
        'matvec_cols_stacked', 'matvec_cols', 'eva_f_fused_no_fold'])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper launches its kernel or raises: it has no CPU path."""
    _, (g, a, b, m) = _mk((64, 48), 'float32', (3,), seed=3)
    with pytest.raises(ValueError, match='must be a CUDA tensor'):
        wrapper(g, a, b, m)


@pytest.mark.parametrize('dtype', [torch.float16, torch.float64, torch.int32])
@pytest.mark.parametrize('wrapper', [
    lambda g, a, b: r1.rank1_update_stacked(g, a, b, torch.ones(3, 2)),
    lambda g, a, b: r1.rank1_update(g[0], a[0], b[0], torch.ones(()),
                                    torch.ones(())),
    lambda g, a, b: mv.matvec_cols_stacked(g, a[:, None]),
    lambda g, a, b: mv.matvec_cols(g[0], a[:2]),
    lambda g, a, b: mv.matvec_and_norm_stacked(g, a),
    lambda g, a, b: mv.matvec_and_norm(g[0], a[0]),
    lambda g, a, b: fused.eva_fused_stacked(g, a, b, GAMMA, None, MU, False),
    lambda g, a, b: fused.eva_f_fused_stacked(g, a, GAMMA, None, MU, False),
    lambda g, a, b: bil.bilinear_and_norms_stacked(g, a, b),
    lambda g, a, b: bil.bilinear_and_norms(g[0], a[0], b[0]),
], ids=['rank1_update_stacked', 'rank1_update', 'matvec_cols_stacked',
        'matvec_cols', 'matvec_and_norm_stacked', 'matvec_and_norm',
        'eva_fused_stacked', 'eva_f_fused_stacked',
        'bilinear_and_norms_stacked', 'bilinear_and_norms'])
def test_lean_wrappers_refuse_wrong_dtypes(wrapper, dtype):
    """The lean launch path takes g in f32 or bf16 only, whatever its
    device."""
    _, (g, a, b, _) = _mk((64, 48), 'float32', (3,), seed=3)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        wrapper(g.to(dtype), a, b)


@pytest.mark.parametrize('shape', [(784, 1000), (1000, 784), (250, 30),
                                   (30, 250), (129, 127), (1000, 513),
                                   (3000, 2)])
def test_eva_fused_plan(shape):
    """The two launches' partition depends on (d_in, d_out) alone: launch
    1 covers the rows in whole-row blocks of about EF_TILE elements,
    launch 2 the flattened item in EF_TILE chunks; the scratch holds the
    two norms and both launches' partials."""
    d_in, d_out = shape
    rows, dot_blocks, emit_blocks, scratch = fused.eva_fused_plan(d_in, d_out)
    assert rows >= 1 and (rows == 1 or rows * d_out <= fused.EF_TILE)
    assert (dot_blocks - 1) * rows < d_in <= dot_blocks * rows
    assert ((emit_blocks - 1) * fused.EF_TILE < d_in * d_out
            <= emit_blocks * fused.EF_TILE)
    assert scratch == 2 + dot_blocks + 3 * emit_blocks
    if shape == (784, 1000):
        # at least four blocks on each of an H100's 132 SMs
        assert min(dot_blocks, emit_blocks) >= 4 * mv.H100_SMS


@pytest.mark.parametrize('shape', [(784, 1000), (1000, 784), (250, 30),
                                   (30, 250), (129, 127), (1000, 513),
                                   (3000, 2)])
def test_bilinear_plan(shape):
    """The one-launch bilinear kernel takes launch 1 of eva_fused's row
    partition, so that the dot it finishes is eva_fused's: one f32 partial
    a row block in the workspace, and one counter an item."""
    d_in, d_out = shape
    rows, blocks, scratch = bil.bilinear_plan(d_in, d_out)
    assert (rows, blocks) == fused.eva_fused_plan(d_in, d_out)[:2]
    assert (blocks - 1) * rows < d_in <= blocks * rows
    assert scratch == blocks
    if shape == (784, 1000):
        # 785 blocks with the norms' block: about six on each of 132 SMs
        assert blocks + 1 >= 4 * mv.H100_SMS


def test_workspace_grows_and_never_shrinks():
    """The workspace grows to the largest call seen, across calls of mixed
    shapes and stack sizes, keeps its buffers when nothing grows, and hands
    out zeroed counters."""
    ws = launch.Workspace(torch.device('cpu'))
    seen, growths = (0, 0), 0
    for L, d_in, d_out in [(1, 250, 30), (1, 784, 1000), (3, 129, 127),
                           (1, 30, 250), (3, 1000, 1000), (1, 784, 1000)]:
        need = (L * fused.eva_fused_plan(d_in, d_out)[3], L)
        before = ws.ptrs
        ptrs = ws.reserve(*need)
        grew = need[0] > seen[0] or need[1] > seen[1]
        growths += grew
        seen = (max(seen[0], need[0]), max(seen[1], need[1]))
        assert (ws.n_f32, ws.n_i32) == seen
        assert (ptrs != before) == grew
        assert not ws.buffers[-1].any()
    # buffers that graphs may still point at are kept
    assert growths == 4 and len(ws.buffers) == 2 * growths


def test_dispatch_rejects_unknown_impl():
    _, (g, a, b, _) = _mk((8, 8), 'float32')
    with pytest.raises(ValueError, match='unknown kernel impl'):
        dispatch.bilinear_and_norms(g, a, b, impl='pallas')


@pytest.mark.gpu
@pytest.mark.parametrize('shape', [(3, 1000, 1000), (1, 250, 30),
                                   (2, 129, 127)])
def test_cuda_kernels_match_plain_on_card(shape):
    """The CUDA kernels against their plain versions, and stacked against
    per item bit for bit (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    _, (g, a, b, m) = _mk(shape[1:], 'float32', shape[:1], seed=4)
    g, a, b, m = (x.cuda() for x in (g, a, b, m))
    dot = bil.bilinear_stacked(g, a, b)
    assert torch.all((dot - ref.bilinear_ref(g, a, b)).abs()
                     <= 1e-5 * ref.bilinear_ref(g.abs(), a.abs(), b.abs()))
    cs = torch.stack([dot / 11.0, torch.full_like(dot, 1 / GAMMA)], -1)
    p = r1.rank1_update_stacked(g, a, b, cs)
    torch.testing.assert_close(p, ref.rank1_update_ref(g, a, b, cs[:, 0],
                                                       cs[:, 1]),
                               atol=1e-5, rtol=1e-5)
    out, aux = fused.eva_fused_stacked(g, a, b, GAMMA, m, MU)
    r_out, r_aux = ref.eva_fused_ref(g, a, b, GAMMA, m, MU)
    torch.testing.assert_close(GAMMA * out, GAMMA * r_out, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(aux, r_aux, atol=1e-4, rtol=2e-5)
    for i in range(shape[0]):
        sl = slice(i, i + 1)
        assert torch.equal(bil.bilinear_stacked(g[sl], a[sl], b[sl]), dot[sl])
        assert torch.equal(r1.rank1_update_stacked(g[sl], a[sl], b[sl],
                                                   cs[sl]), p[sl])
    launches.reset()


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(1000, 513), (129, 127), (7, 3)])
def test_rank1_update_misaligned_on_card(shape, dtype):
    """The vectorised rank-one kernel on a G that starts one element past a
    16-byte boundary and whose length is no multiple of the vector width:
    the plain version's bits, and the two coefficient forms alike (needs a
    card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    _, (g, a, b, _) = _mk(shape, dtype, seed=7)
    flat = torch.cat([torch.zeros(1, dtype=g.dtype), g.reshape(-1)]).cuda()
    g, a, b = flat[1:].view(shape), a.cuda(), b.cuda()
    c = torch.tensor(0.37, device='cuda')
    s = torch.tensor(2.5, device='cuda')
    p = r1.rank1_update(g, a, b, c, s)
    assert torch.equal(p, ref.rank1_update_ref(g, a, b, c, s))
    assert torch.equal(r1.rank1_update(g, a, b, torch.stack([c, s])), p)
    launches.reset()


def _same_bits(got, want):
    return all(torch.equal(x, y) for x, y in zip(got, want))


def _repeats_and_replays(fn):
    """Three calls of ``fn`` in a row, then a CUDA graph of one call
    replayed three times: each gives the first call's bits (the kernels
    that finish a sum by ticket keep their arrival counters at zero).  The
    graph is captured on a side stream after an eager call there, which
    grows that stream's workspace before the capture."""
    want = [x.clone() for x in fn()]
    for _ in range(2):
        assert _same_bits(fn(), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert _same_bits(fn(), want)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = fn()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(outs, want)
    return want


@pytest.mark.gpu
@pytest.mark.parametrize('fold', [False, True])
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(3, 1000, 1000), (2, 129, 127)])
def test_eva_fused_stacked_repeats_and_replays_on_card(shape, dtype, fold):
    """The two-launch fused kernel: a stack equals its items bit for bit
    (the second item of 2 x 129 x 127 sits 4 bytes off a 16-byte
    boundary), and repeated calls and graph replays give the same bits
    (needs a card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    _, (g, a, b, m) = _mk(shape[1:], dtype, shape[:1], seed=11)
    g, a, b, m = (x.cuda() for x in (g, a, b, m))
    m = m if fold else None
    out, aux = _repeats_and_replays(
        lambda: fused.eva_fused_stacked(g, a, b, GAMMA, m, MU, fold))
    for i in range(shape[0]):
        sl = slice(i, i + 1)
        assert _same_bits(fused.eva_fused_stacked(
            g[sl], a[sl], b[sl], GAMMA, None if m is None else m[sl], MU,
            fold), (out[sl], aux[sl]))
    launches.reset()


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(1, 784, 1000), (3, 1000, 1000),
                                   (2, 129, 127)])
def test_bilinear_repeats_replays_and_matches_fused_on_card(shape, dtype):
    """The one-launch bilinear kernel: repeated calls and graph replays give
    the same bits, a stack equals its items and the unstacked form bit for
    bit, and on f32 G its dot and norms are the ones fused Eva forms, so
    composed Eva equals fused Eva without the fold bit for bit (needs a card
    and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    _, (g, a, b, _) = _mk(shape[1:], dtype, shape[:1], seed=13)
    g, a, b = g.cuda(), a.cuda(), b.cuda()
    dot, sq = _repeats_and_replays(
        lambda: bil.bilinear_and_norms_stacked(g, a, b))
    assert torch.all((dot - ref.bilinear_ref(g, a, b)).abs()
                     <= TOL[dtype] * ref.bilinear_ref(g.abs(), a.abs(),
                                                      b.abs()))
    torch.testing.assert_close(sq, ref.bilinear_and_norms_ref(g, a, b)[1],
                               atol=0, rtol=1e-5)
    for i in range(shape[0]):
        sl = slice(i, i + 1)
        assert _same_bits(bil.bilinear_and_norms_stacked(g[sl], a[sl], b[sl]),
                          (dot[sl], sq[sl]))
        assert _same_bits(bil.bilinear_and_norms(g[i], a[i], b[i]),
                          (dot[i], sq[i]))
    if dtype == 'float32':
        from repro_torch.kernels import ops
        out, _ = fused.eva_fused_stacked(g, a, b, GAMMA, None, MU, False)
        assert torch.equal(ops.eva_precondition(g, a, b, GAMMA, impl='cuda'),
                           out)
    launches.reset()
