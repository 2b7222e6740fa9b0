"""The demo transformer LM trained by the port against the reference, from
the same weights (the reference's ``init_params``) and batches (``LMStream
(vocab=512, seq_len=32, batch=8, seed=1)``, the reference's own
``tests/test_train_integration.py::_setup``): 10 steps of ``demo_lm('small')``
with Eva, Eva-f and Eva-s, composed and fused (the reference runs its Pallas
kernels in interpret mode).  K-FAC and SGD are in
``test_torch_lm_train_solvers.py``, Shampoo in
``test_torch_lm_train_shampoo.py``.

Both sides run f32 on the CPU and sum in other orders; each second-order
step amplifies the difference a little.  Stated tolerances: per-step loss
rtol 1e-4 (atol 1e-6); final parameters and every float leaf of the
optimizer state rtol 1e-4, atol 1e-5, except two kinds of Shampoo leaf.
Its cached roots are held to atol 2e-2 (``test_torch_kfac_shampoo.py`` says
why: here the embedding rows of tokens a batch lacks and the head's null
direction keep eigenvalues at ε_init).  Its factor statistics M_in, M_out
are held to rtol 1e-4 and atol 1e-4 of the leaf's largest magnitude: the
embedding's gradient is a scatter-add over repeated tokens, summed in
another order, and the roots at ε_init carry that into the parameters
(9e-6 after 10 steps) and so into the next G Gᵀ, whose small entries then
differ by up to 1.35e-5 of the leaf's largest (8.8).  Integer leaves equal.
Measured on the LM: losses within 6.1e-7 relative, parameters within 9e-6
(Shampoo; 1.2e-7 for the rest).
"""
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import demo_lm as jdemo_lm  # noqa: E402
from repro.core import factor_sharded as jfsh  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.configs.registry import demo_lm  # noqa: E402
from repro_torch.core import factor_sharded as fsh  # noqa: E402
from repro_torch.core import kv  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.core.transform import tree_leaves_with_path  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa

RTOL, ATOL = 1e-4, 1e-5
ROOT_ATOL = 2e-2
STEPS, LR = 10, 0.05
STREAM = dict(vocab=512, seq_len=32, batch=8, seed=1)
RANK_ONE = ('eva', 'eva_f', 'eva_s')
# head_policy='shard' at 512 trips the head's 512-wide output side alone
SHARD = dict(head_policy='shard', shard_threshold=512, solve_iters=32)
SOLVER = {'kfac': 'cg', 'shampoo': 'binomial'}


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """One intra-op torch thread for this module, restored after: torch's
    thread pool beside JAX's own slows these CPU runs several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_launches():
    """On CPU tensors every kernel op takes its plain version."""
    launches.reset()
    yield
    assert launches.snapshot() == {k: 0 for k in launches.COUNTS}


def _full_taps(kvmod, paths):
    """K-FAC's taps as the reference's launcher makes them, sized from the
    batch's (batch, seq) tokens."""
    return lambda p, b: kvmod.make_full_taps(p, paths,
                                             tuple(b['tokens'].shape))


def run_both(name, fused=False, shard=False):
    """10 steps of each package: ((losses, flat params, state) of the
    reference, the same of the port)."""
    jm, tm = jbuild(jdemo_lm('small')), build_model(demo_lm('small'))
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tp = M.params_from_numpy(jp, 'cpu')
    jdata = jsyn.LMStream(**STREAM)
    tdata = tsyn.LMStream(**STREAM, device='cpu')
    kw = {} if name == 'sgd' else dict(fused=fused)
    jopt, jcap = jmake(name, lr=LR, **(dict(kw, kernel_impl='pallas_interpret')
                                       if name in RANK_ONE else kw))
    topt, tcap = make_optimizer(name, lr=LR, **kw)
    paths = jm.precon_paths()
    jtaps = ttaps = None
    if jcap.b == 'outer':
        shape = (STREAM['batch'], STREAM['seq_len'])
        jtaps = lambda p: jkv.make_full_taps(p, paths, shape)  # noqa: E731
        ttaps = _full_taps(kv, paths)
    jf = tf = None
    if shard:
        jf = jfsh.FactorShardConfig(**SHARD, solver=SOLVER[name])
        tf = fsh.FactorShardConfig(**SHARD, solver=SOLVER[name])
    jst = jinit(jm, jopt, jcap, jp, jdata.batch_at(0), taps_fn=jtaps,
                factor=jf)
    jstep = jax.jit(jstep_fn(jm, jopt, jcap, taps_fn=jtaps, factor=jf))
    tst = init_opt_state(tm, topt, tcap, tp, tdata.batch_at(0),
                         taps_fn=ttaps, factor=tf, device='cpu')
    tstep = make_train_step(tm, topt, tcap, taps_fn=ttaps, factor=tf,
                            device='cpu')
    jl, tl = [], []
    for i in range(STEPS):
        jp, jst, jmet = jstep(jp, jst, jdata.batch_at(i))
        tp, tst, tmet = tstep(tp, tst, tdata.batch_at(i))
        jl.append(float(jmet['loss']))
        tl.append(float(tmet['loss']))
    return (np.array(jl), jkv.flatten_params(jp), jst), \
        (np.array(tl), M.params_to_numpy(tp), M.state_to_numpy(tst))


def check(ref, port, name):
    (jl, jp, jst), (tl, tp, tst) = ref, port
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=1e-6)
    assert jl[-1] < jl[0]
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    want = {k: np.asarray(v) for k, v in tree_leaves_with_path(jst).items()}
    assert set(tst) == set(want)
    for k, w in want.items():
        assert tst[k].shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(tst[k], w, err_msg=k)
            continue
        atol = ATOL
        if name == 'shampoo' and ('/p_in/' in k or '/p_out/' in k):
            atol = ROOT_ATOL
        elif name == 'shampoo' and ('/m_in/' in k or '/m_out/' in k):
            atol = max(ATOL, 1e-4 * float(np.abs(w).max()))
        np.testing.assert_allclose(tst[k], w, rtol=RTOL, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize('fused', [False, True], ids=['composed', 'fused'])
@pytest.mark.parametrize('name', RANK_ONE)
def test_rank_one_matches_reference(name, fused):
    check(*run_both(name, fused=fused), name)
