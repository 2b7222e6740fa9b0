"""The port's kernel dispatch layer (``repro_torch/kernels/dispatch.py``)
against the reference's ``tests/test_dispatch.py`` cases, on the CPU.

The impl names are the port's: ``'cuda'`` stands where the reference has
``'pallas'`` and ``'torch'`` where it has ``'xla'``.  No case needs the
card: ``resolve`` takes the device type as a string, and a CUDA tensor is
never made.  Across the packages: ``cache_key`` gives equal strings for f32
and bf16, and on the MLP (three steps of Eva and Eva-f, composed and fused)
the set of ops in ``choices_snapshot()`` after a step equals the
reference's, the reference at ``KernelConfig(impl='xla')`` and the port at
``KernelConfig(impl='torch')``, with every loss within rtol 1e-4 of the
reference's.  A fixture resets both packages' dispatch state around each
test: under ``--dist loadfile`` one worker runs many files.
"""
import json
import re

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.core.transform import Extras as JExtras  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.core.transform import Extras  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import dispatch, launches, ref  # noqa: E402
from repro_torch.kernels import matvec as mv  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa

F32 = torch.float32
LABEL = re.compile(r'^(cuda|torch) \d+x\d+ @ \d+x\d+$')


def _reset():
    for mod in (dispatch, jdispatch):
        mod.reset_cache()
        mod.set_default_impl('auto')
    # the reference's reset keeps its record of choices: cleared here
    jdispatch._choices.clear()


@pytest.fixture(autouse=True)
def _clean_dispatch_state():
    _reset()
    yield
    _reset()


def _mk(shape, seed=0):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    a = torch.from_numpy(rng.standard_normal(shape[-2], dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(shape[-1], dtype=np.float32))
    return g, a, b


# ---------------------------------------------------------------------------
# resolution rules


def test_resolve_auto_cpu_is_torch():
    c = dispatch.resolve('bilinear', 96, 80, F32, 'auto', device='cpu')
    assert c == dispatch.Choice('torch', 0, 0)
    assert dispatch.resolve('bilinear', 96, 80, F32, device='cpu').impl == \
        'torch'


def test_resolve_auto_cuda_is_cuda_with_the_default_plan():
    """No cache entry (shapes the shipped defaults do not name): each
    kernel's own plan (matvec_plan's warps; one fixed partition for
    bilinear, rank1_update and eva_fused)."""
    for d_in, d_out in ((64, 48), (200, 136), (4096, 100)):
        c = dispatch.resolve('matvec', d_in, d_out, F32, 'auto', 'cuda')
        warps = mv.matvec_plan(d_in, d_out)[1]
        assert c == dispatch.Choice('cuda', warps * mv.MV_SUB * mv.MV_ROWS,
                                    mv.MV_COLS)
        assert dispatch.resolve('eva_f_fused', d_in, d_out, F32, 'auto',
                                torch.device('cuda')) == c
    assert dispatch.resolve('bilinear', 768, 4096, F32, 'cuda', 'cuda') == \
        dispatch.Choice('cuda', 1, 4096)
    assert dispatch.resolve('bilinear', 768, 200, F32, 'cuda', 'cuda') == \
        dispatch.Choice('cuda', 5, 200)
    assert dispatch.resolve('matvec_cols', 1000, 1000, F32, 'auto',
                            'cuda') == dispatch.Choice('cuda', 0, 0)


def test_resolve_explicit_cuda_on_cpu_raises():
    with pytest.raises(ValueError, match='CUDA tensors'):
        dispatch.resolve('bilinear', 64, 48, F32, 'cuda', device='cpu')
    g, a, b = _mk((64, 48))
    with pytest.raises(ValueError, match='CUDA tensors'):
        dispatch.bilinear_and_norms(g, a, b, impl='cuda')


def test_resolve_unknown_impl_raises():
    with pytest.raises(ValueError, match='unknown kernel impl'):
        dispatch.resolve('bilinear', 64, 48, F32, 'pallas', device='cpu')
    with pytest.raises(ValueError, match='unknown kernel impl'):
        dispatch.set_default_impl('xla')
    with pytest.raises(ValueError, match='unknown kernel op'):
        dispatch.resolve('attention', 64, 48, F32, 'cuda', device='cuda')


def test_runtime_default_flip_no_reload():
    dispatch.set_default_impl('torch')
    assert dispatch.default_impl() == 'torch'
    assert dispatch.resolve('matvec', 64, 48, F32, device='cuda').impl == \
        'torch'
    with dispatch.impl_override('cuda'):
        assert dispatch.resolve('matvec', 64, 48, F32,
                                device='cuda').impl == 'cuda'
        # a CPU operand under a 'cuda' default raises, it never falls back
        g, a, _ = _mk((64, 48))
        with pytest.raises(ValueError, match='CUDA tensors'):
            dispatch.matvec_and_norm(g, a)
    assert dispatch.resolve('matvec', 64, 48, F32, device='cuda').impl == \
        'torch'
    # the override restores the default on an exception too
    with pytest.raises(RuntimeError):
        with dispatch.impl_override('auto'):
            raise RuntimeError('inside')
    assert dispatch.default_impl() == 'torch'


def test_choices_snapshot_has_the_reference_format():
    dispatch.resolve('bilinear', 200, 136, F32, 'cuda', device='cuda')
    dispatch.resolve('matvec', 200, 136, F32, 'torch', device='cuda')
    snap = dispatch.choices_snapshot()
    assert snap['bilinear'] == 'cuda 7x136 @ 200x136'
    assert snap['matvec'] == 'torch 0x0 @ 200x136'
    jdispatch.resolve('bilinear', 200, 136, jnp.float32, 'pallas_interpret')
    jsnap = jdispatch.choices_snapshot()['bilinear']
    assert LABEL.match(jsnap.replace('pallas/interpret', 'cuda'))
    assert all(LABEL.match(v) for v in snap.values())
    assert jsnap.endswith('@ 200x136')


def test_impl_from_extras_config_wins():
    cfg = dispatch.KernelConfig(impl='torch')
    assert dispatch.impl_from_extras(Extras(kernel=cfg), 'cuda') == 'torch'
    auto = dispatch.KernelConfig(impl='auto')
    assert dispatch.impl_from_extras(Extras(kernel=auto), None) == 'auto'
    assert dispatch.impl_from_extras(Extras(), 'cuda') == 'cuda'
    assert dispatch.impl_from_extras(None, None) is None
    # the reference's four cases give the same answers
    jcfg = jdispatch.KernelConfig(impl='xla')
    assert jdispatch.impl_from_extras(JExtras(kernel=jcfg), 'pallas') == 'xla'
    assert dispatch.KernelConfig() == dispatch.KernelConfig(
        impl='auto', autotune_cache=None, autotune=False)


# ---------------------------------------------------------------------------
# cache install / winner routing


def test_install_cache_routes_auto(tmp_path):
    key = dispatch.cache_key('matvec', 64, 48, F32, 'cuda')
    assert key == 'cuda/matvec/float32/64x48'
    cache = {'version': 1, 'entries': {
        key: {'impl': 'cuda', 'block_in': 256, 'block_out': 16, 'us': 1.0},
        dispatch.cache_key('bilinear', 64, 48, F32, 'cuda'): {
            'impl': 'torch', 'block_in': 0, 'block_out': 0, 'us': 2.0}}}
    path = tmp_path / 'cache.json'
    path.write_text(json.dumps(cache))
    assert dispatch.install_cache(str(path)) >= 2
    assert dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cuda') == \
        dispatch.Choice('cuda', 256, 16)
    assert dispatch.choices_snapshot()['matvec'] == 'cuda 256x16 @ 64x48'
    # a cache entry may send a CUDA operand to the plain version
    assert dispatch.resolve('bilinear', 64, 48, F32, 'auto', 'cuda').impl \
        == 'torch'
    # an explicit impl is not routed; other shapes keep the device rule
    assert dispatch.resolve('bilinear', 64, 48, F32, 'cuda', 'cuda').impl \
        == 'cuda'
    assert dispatch.resolve('matvec', 65, 48, F32, 'auto', 'cuda') == \
        dispatch.Choice('cuda', 128, 16)
    assert dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cpu').impl == \
        'torch'
    dispatch.reset_cache()
    assert dispatch.choices_snapshot() == {}
    assert dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cuda') == \
        dispatch.Choice('cuda', 128, 16)
    assert dispatch.resolve('bilinear', 64, 48, F32, 'auto', 'cuda').impl \
        == 'cuda'


def test_cache_entry_naming_no_configuration_raises():
    key = dispatch.cache_key('matvec', 64, 48, F32, 'cuda')
    dispatch.install_cache({key: {'impl': 'cuda', 'block_in': 512,
                                  'block_out': 512}})
    with pytest.raises(ValueError, match='no configuration'):
        dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cuda')
    key = dispatch.cache_key('matvec_cols', 1000, 1000, F32, 'cuda')
    dispatch.install_cache({key: {'impl': 'cuda', 'block_in': 64,
                                  'block_out': 112}})
    with pytest.raises(ValueError, match='no configuration'):
        dispatch.resolve('matvec_cols', 1000, 1000, F32, 'auto', 'cuda')
    # both tiles of COLS_TILES are configurations
    for bi, bo in ((64, 64), (56, 112)):
        dispatch.install_cache({key: {'impl': 'cuda', 'block_in': bi,
                                      'block_out': bo}})
        assert dispatch.resolve('matvec_cols', 1000, 1000, F32, 'auto',
                                'cuda') == dispatch.Choice('cuda', bi, bo)
    # the reference's impl names are not the port's
    with pytest.raises(ValueError, match="'cuda' or 'torch'"):
        dispatch.install_cache({key: {'impl': 'pallas'}})
    # a CPU key naming the kernels cannot run on the CPU
    cpu_key = dispatch.cache_key('bilinear', 64, 48, F32, 'cpu')
    dispatch.install_cache({cpu_key: {'impl': 'cuda', 'block_in': 16,
                                      'block_out': 48}})
    g, a, b = _mk((64, 48))
    with pytest.raises(ValueError, match='CUDA tensors'):
        dispatch.bilinear_and_norms(g, a, b)


def test_configurations_are_the_kernels_own():
    assert dispatch.configurations('matvec', 768, 2048) == tuple(
        (w * 128, 16) for w in range(1, 9))
    assert dispatch.configurations('eva_f_fused', 7, 3) == \
        dispatch.configurations('matvec', 768, 2048)
    assert dispatch.configurations('matvec_cols', 32768, 32768) == (
        (64, 64), (56, 112))
    assert dispatch.configurations('bilinear', 768, 2048) == ((1, 2048),)
    assert dispatch.configurations('eva_fused', 1000, 513) == ((1, 513),)
    assert dispatch.configurations('rank1_update', 30, 250) == ((1, 256),)


def test_cache_key_matches_the_reference_f32_and_bf16():
    for op in ('bilinear', 'matvec', 'rank1_update', 'eva_fused'):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            assert dispatch.cache_key(op, 768, 2048, tdt, 'cpu') == \
                jdispatch.cache_key(op, 768, 2048, jdt, 'cpu')
    assert dispatch.cache_key('matvec', 3, 4, 'bfloat16', 'cuda') == \
        'cuda/matvec/bfloat16/3x4'


def test_memo_builds_no_key_and_drops_on_changes(monkeypatch):
    first = dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cuda')
    g, a, _ = _mk((64, 48))
    dispatch.matvec_and_norm(g, a)

    def refuse(*a, **k):
        raise AssertionError('a key string was built on a memo hit')
    real = dispatch.cache_key
    monkeypatch.setattr(dispatch, 'cache_key', refuse)
    assert dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cuda') is first
    dispatch.matvec_and_norm(g, a)            # the 'auto' CPU choice, memo
    monkeypatch.setattr(dispatch, 'cache_key', real)
    key = dispatch.cache_key('matvec', 64, 48, F32, 'cuda')
    dispatch.install_cache({key: {'impl': 'torch'}})
    assert dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cuda').impl == \
        'torch'
    dispatch.set_default_impl('cuda')
    assert dispatch.resolve('matvec', 64, 48, F32, None, 'cuda').impl == \
        'cuda'


def test_shipped_defaults_name_only_cuda():
    """The warm-start file ships with the port and moves no kernel off its
    plan: by default the card runs each kernel's plan, the configuration
    the chip check times, on every shape of the autoencoder and demo-100m."""
    assert dispatch._DEFAULTS_FILE.exists()
    data = json.loads(dispatch._DEFAULTS_FILE.read_text())
    assert data['version'] == 1 and data['backend'] == 'cuda'
    for key, e in data['entries'].items():
        backend, op, dtype, shape = key.split('/')
        assert backend == 'cuda' and e['impl'] == 'cuda', key
    shapes = [(784, 1000), (1000, 500), (500, 250), (250, 30), (30, 250),
              (250, 500), (500, 1000), (1000, 784), (768, 768), (768, 256),
              (768, 2048), (2048, 768), (768, 32768)]
    for op in dispatch.KERNEL_OPS:
        for d_in, d_out in shapes:
            for dtype in (F32, torch.bfloat16):
                assert dispatch.resolve(op, d_in, d_out, dtype, 'auto',
                                        'cuda') == dispatch.Choice(
                    'cuda', *dispatch._default_blocks(op, d_in, d_out))


@pytest.mark.parametrize('impl', ['torch', None, 'pallas'])
def test_shipped_defaults_refuse_anything_but_cuda(tmp_path, monkeypatch,
                                                   impl):
    """A shipped entry that names anything but 'cuda' would send default
    calls on the card to the plain version: the first resolution raises,
    and an installed cache still may name 'torch'."""
    key = dispatch.cache_key('matvec', 64, 48, F32, 'cuda')
    bad = tmp_path / 'tile_defaults.json'
    bad.write_text(json.dumps({'version': 1, 'backend': 'cuda', 'entries': {
        key: {} if impl is None else {'impl': impl}}}))
    monkeypatch.setattr(dispatch, '_DEFAULTS_FILE', bad)
    dispatch.reset_cache()
    with pytest.raises(ValueError, match="may name only 'cuda'"):
        dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cuda')
    with pytest.raises(ValueError, match="may name only 'cuda'"):
        dispatch.install_cache({})
    bad.write_text(json.dumps({'version': 1, 'backend': 'cuda',
                               'entries': {}}))
    assert dispatch.install_cache({key: {'impl': 'torch'}}) == 1
    assert dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cuda') == \
        dispatch.Choice('torch', 0, 0)


# ---------------------------------------------------------------------------
# op wrappers on CPU tensors: the plain versions bit for bit, no launch


@pytest.mark.parametrize('impl', [None, 'auto', 'torch'])
def test_cpu_wrappers_are_the_plain_versions(impl):
    g, a, b = _mk((64, 48))
    launches.reset()
    c, s = torch.tensor(0.37), torch.tensor(2.5)
    m = torch.zeros((1, 64, 48))
    for got, want in (
            (dispatch.bilinear_and_norms(g, a, b, impl),
             ref.bilinear_and_norms_ref(g, a, b)),
            (dispatch.matvec_and_norm(g, a, impl),
             ref.matvec_and_norm_ref(g, a)),
            ((dispatch.rank1_update(g, a, b, c, s, impl=impl),),
             (ref.rank1_update_ref(g, a, b, c, s),)),
            (dispatch.matvec_cols(g, a[None, :], impl),
             (ref.matvec_cols_ref(g, a[None, :]),)),
            (dispatch.eva_fused_stacked(g[None], a[None], b[None], 0.03, m,
                                        0.9, impl=impl),
             ref.eva_fused_ref(g[None], a[None], b[None], 0.03, m, 0.9)),
            (dispatch.eva_f_fused_stacked(g[None], a[None], 0.03, m, 0.9,
                                          impl=impl),
             ref.eva_f_fused_ref(g[None], a[None], 0.03, m, 0.9))):
        got = got if isinstance(got, tuple) else (got,)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert not any(launches.snapshot().values())
    assert set(dispatch.choices_snapshot()) == set(dispatch.KERNEL_OPS)


# ---------------------------------------------------------------------------
# across the packages: the ops each optimizer dispatches, on the MLP

MLP = dict(dims=[16, 32, 32, 4], batch=64, lr=0.03, steps=3)


def _mlp_run(name, fused):
    """Three steps of ``name`` in both packages from the same weights and
    batches, the reference at impl 'xla', the port at 'torch', each through
    ``Extras.kernel``; returns both loss lists and both packages' ops seen
    in ``choices_snapshot`` after each step."""
    jm, tm = jsimple.MLP(MLP['dims']), simple.MLP(MLP['dims'])
    jm.loss_fn = jsimple.classifier_loss_fn(jm)
    tm.loss_fn = simple.classifier_loss_fn(tm)
    kw = dict(batch=MLP['batch'], dim=16, classes=4, spread=1.5, seed=0)
    jdata, tdata = jsyn.ClassStream(**kw), tsyn.ClassStream(**kw,
                                                            device='cpu')
    jp = JM.init_params(jm.param_specs(), jax.random.PRNGKey(0))
    tp = M.params_from_numpy({k: np.asarray(v) for k, v in
                              jkv.flatten_params(jp).items()}, 'cpu')
    jopt, jcap = jmake(name, lr=MLP['lr'], fused=fused)
    jkernel = jdispatch.KernelConfig(impl='xla')
    taps_fn = (lambda p: jm.make_taps(MLP['batch'], jcap)) \
        if jcap.needs_taps else None
    jst = jinit(jm, jopt, jcap, jp, jdata.batch_at(0), taps_fn=taps_fn,
                kernel=jkernel)
    jstep = jax.jit(jstep_fn(jm, jopt, jcap, taps_fn=taps_fn,
                             kernel=jkernel))
    topt, tcap = make_optimizer(name, lr=MLP['lr'], fused=fused)
    tkernel = dispatch.KernelConfig(impl='torch')
    tst = init_opt_state(tm, topt, tcap, tp, tdata.batch_at(0),
                         kernel=tkernel, device='cpu')
    tstep = make_train_step(tm, topt, tcap, kernel=tkernel, device='cpu')
    jl, tl, jops, tops = [], [], [], []
    for i in range(MLP['steps']):
        jp, jst, jmet = jstep(jp, jst, jdata.batch_at(i))
        tp, tst, tmet = tstep(tp, tst, tdata.batch_at(i))
        jl.append(float(jmet['loss']))
        tl.append(float(tmet['loss']))
        jops.append(set(jdispatch.choices_snapshot()))
        tops.append(set(dispatch.choices_snapshot()))
        assert all(v.startswith('torch ')
                   for v in dispatch.choices_snapshot().values())
    return np.array(jl), np.array(tl), jops, tops


@pytest.mark.parametrize('name,fused,ops', [
    ('eva', False, {'bilinear', 'rank1_update'}),
    ('eva', True, {'eva_fused'}),
    ('eva_f', False, {'matvec', 'rank1_update'}),
    ('eva_f', True, {'eva_f_fused'})])
def test_dispatched_ops_match_the_reference(name, fused, ops):
    jl, tl, jops, tops = _mlp_run(name, fused)
    # the reference resolves while its step traces: the ops of the first
    # step stand for every step
    assert jops[0] == ops
    assert all(t == ops for t in tops)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
