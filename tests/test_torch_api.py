"""The port's public API against the reference's.

* Each name the reference's package ``__init__`` files export (``core``,
  ``train``, ``data``, ``comm``, ``schedule``, ``models``, ``obs``,
  ``configs``) resolves in the port's package of the same name, and each
  public def/class of a reference module resolves in its port module (under
  the port's name where the port renamed it), apart from the names listed
  below by the ROADMAP item they wait for.
* The new functions match the reference on seeded numpy inputs, f32:
  ``eva_explicit``, ``eva_f_precondition`` and ``eva_s_precondition`` within
  1e-5 relative (of the output's largest magnitude), and ``eva_explicit``
  in f64 is the f32 Sherman–Morrison form within 1e-5; ``kl_clip`` equals the
  port's ``kl_clip_trace`` at momentum 0 exactly and the reference's
  ``kl_clip`` within 1e-6; ``map_bucket``, ``tree_scale``,
  ``tree_zeros_like``, ``scale`` within 1e-6; ``cells_for`` and
  ``cell_skip_reason`` agree on all ten arch configs.
* Importing the packages builds and loads no CUDA library.
"""
import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import clipping as jclip  # noqa: E402
from repro.core import precondition as jpre  # noqa: E402
from repro.core import transform as jtr  # noqa: E402
from repro_torch.core import clipping  # noqa: E402
from repro_torch.core import precondition as pre  # noqa: E402
from repro_torch.core import transform as tr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ('core', 'train', 'data', 'comm', 'schedule', 'models', 'obs',
            'configs')
# exported by a reference __init__, not yet ported: name -> ROADMAP item
WAITING_EXPORTS = {
    'train': {'abstract_opt_state': '13h'},
    'models': {'train_batch_specs': '13h', 'prefill_batch_specs': '13h',
               'decode_specs': '13h'},
    'obs': {'hlo_costs': '13f', 'compiled_fn_costs': '13f',
            'live_buffer_mb': '13f'},
}
# reference modules with no port module yet
WAITING_MODULES = {
    'kernels/autotune.py': '13d', 'kernels/tiles.py': '13d',
    'launch/dryrun.py': '13h', 'launch/hlo_analysis.py': '13h',
    'launch/mesh.py': '13g', 'sharding/__init__.py': '13g',
    'sharding/compat.py': '13g', 'sharding/constraints.py': '13g',
    'sharding/logical.py': '13g',
}
# public defs of a reference module that are not in its port module
WAITING_DEFS = {
    'kernels/dispatch.py': {n: '13d' for n in (
        'Choice', 'KernelConfig', 'backend', 'cache_key', 'choices_snapshot',
        'default_impl', 'impl_from_extras', 'impl_override', 'install_cache',
        'reset_cache', 'set_default_impl')},
    'models/module.py': {'abstract_params': '13h'},
    'models/registry.py': {'train_batch_specs': '13h',
                           'prefill_batch_specs': '13h',
                           'decode_specs': '13h'},
    'obs/spans.py': {'hlo_costs': '13f', 'compiled_fn_costs': '13f',
                     'live_buffer_mb': '13f'},
    'train/step.py': {'abstract_opt_state': '13h'},
}
# the port's name for a reference def: its kernels also return the norms
RENAMED = {
    'kernels/dispatch.py': {'bilinear': 'bilinear_and_norms',
                            'bilinear_stacked': 'bilinear_and_norms_stacked',
                            'matvec': 'matvec_and_norm',
                            'matvec_stacked': 'matvec_and_norm_stacked'},
    'kernels/matvec.py': {'matvec': 'matvec_and_norm',
                          'matvec_stacked': 'matvec_and_norm_stacked'},
}


def _exports(pkg):
    mod = importlib.import_module(f'repro.{pkg}')
    names = getattr(mod, '__all__', None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith('_')
                 and n != 'annotations']
    return mod, sorted(names)


@pytest.mark.parametrize('pkg', PACKAGES)
def test_reference_exports_resolve_in_the_port(pkg):
    ref, names = _exports(pkg)
    port = importlib.import_module(f'repro_torch.{pkg}')
    waiting = WAITING_EXPORTS.get(pkg, {})
    missing = [n for n in names if n not in waiting and not hasattr(port, n)]
    assert not missing, f'repro_torch.{pkg} lacks {missing}'
    assert all(n in names and not hasattr(port, n) for n in waiting)
    if hasattr(ref, '__all__'):
        assert sorted(port.__all__) == sorted(set(names) - set(waiting))


def _public_defs(path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith('_')}


REF_MODULES = sorted(str(p.relative_to(ROOT / 'src' / 'repro'))
                     for p in (ROOT / 'src' / 'repro').rglob('*.py'))


@pytest.mark.parametrize('rel', REF_MODULES)
def test_reference_module_defs_resolve_in_the_port(rel):
    if rel in WAITING_MODULES:
        assert not (ROOT / 'src' / 'repro_torch' / rel).exists()
        return
    name = 'repro_torch.' + rel[:-3].replace('/', '.').removesuffix(
        '.__init__')
    port = importlib.import_module(name)
    waiting = WAITING_DEFS.get(rel, {})
    renamed = RENAMED.get(rel, {})
    missing = [n for n in sorted(_public_defs(ROOT / 'src' / 'repro' / rel))
               if n not in waiting
               and not hasattr(port, renamed.get(n, n))]
    assert not missing, f'{name} lacks {missing}'
    assert not any(hasattr(port, n) for n in waiting)


def test_imports_build_no_kernel():
    """Importing every package (and the CLI) compiles and loads no CUDA
    library: the kernels build at their first launch."""
    code = (
        'from repro_torch.kernels import build\n'
        'def refuse(*a, **k):\n'
        '    raise AssertionError("a kernel was built at import")\n'
        'build.build_all = build.library = refuse\n'
        'import repro_torch.core, repro_torch.train, repro_torch.data\n'
        'import repro_torch.comm, repro_torch.schedule, repro_torch.models\n'
        'import repro_torch.obs, repro_torch.configs\n'
        'import repro_torch.obs.report, repro_torch.launch.train\n'
        'assert not build._loaded\n'
        'import sys\n'
        'assert not any(m == "jax" or m.startswith(("jax.", "repro."))'
        ' for m in sys.modules)\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120,
                         env={'PYTHONPATH': str(ROOT / 'src')})
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# The new functions against the reference

GAMMA = 0.03


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize('shape', [(6, 5), (3, 7)])
def test_eva_explicit_matches_reference_and_sherman_morrison(shape):
    rng = np.random.default_rng(10)
    g = rng.standard_normal(shape, dtype=np.float32)
    a = rng.standard_normal(shape[0], dtype=np.float32)
    b = rng.standard_normal(shape[1], dtype=np.float32)
    got = pre.eva_explicit(torch.from_numpy(g), torch.from_numpy(a),
                           torch.from_numpy(b), GAMMA)
    assert got.dtype == torch.float32 and got.shape == shape
    ref = jpre.eva_explicit(jnp.asarray(g), jnp.asarray(a), jnp.asarray(b),
                            GAMMA)
    assert _rel(got, ref) <= 1e-5
    # the f32 dense solve loses digits to C's condition number; in f64 it
    # is the oracle of the f32 Sherman-Morrison form
    exact = pre.eva_explicit(*(torch.from_numpy(x).double()
                               for x in (g, a, b)), GAMMA)
    assert exact.dtype == torch.float64
    sm = pre.eva_precondition(torch.from_numpy(g), torch.from_numpy(a),
                              torch.from_numpy(b), GAMMA, impl='torch')
    assert _rel(sm.double(), exact.numpy()) <= 1e-5


@pytest.mark.parametrize('lead', [(), (3,), (2, 2)])
def test_eva_f_and_eva_s_precondition_match_reference(lead):
    rng = np.random.default_rng(11)
    g = rng.standard_normal(lead + (24, 17), dtype=np.float32)
    a = rng.standard_normal(lead + (24,), dtype=np.float32)
    got = pre.eva_f_precondition(torch.from_numpy(g), torch.from_numpy(a),
                                 GAMMA, impl='torch')
    ref = jpre.eva_f_precondition(jnp.asarray(g), jnp.asarray(a), GAMMA)
    assert got.shape == g.shape and _rel(got, ref) <= 1e-5
    v_in, v_out = pre.grad_kvs(torch.from_numpy(g))
    got = pre.eva_s_precondition(torch.from_numpy(g), v_in, v_out, GAMMA,
                                 impl='torch')
    jv_in, jv_out = jpre.grad_kvs(jnp.asarray(g))
    ref = jpre.eva_s_precondition(jnp.asarray(g), jv_in, jv_out, GAMMA)
    assert got.shape == g.shape and _rel(got, ref) <= 1e-5


def test_map_bucket_matches_reference():
    rng = np.random.default_rng(12)
    m = rng.standard_normal((3, 5, 5), dtype=np.float32)
    m = m @ np.swapaxes(m, -1, -2) + 5 * np.eye(5, dtype=np.float32)
    v = rng.standard_normal((3, 5, 2), dtype=np.float32)
    got = pre.map_bucket(torch.linalg.solve, torch.from_numpy(m),
                         torch.from_numpy(v))
    ref = jpre.map_bucket(jnp.linalg.solve, jnp.asarray(m), jnp.asarray(v))
    assert got.shape == (3, 5, 2) and _rel(got, ref) <= 1e-6


def _kl_inputs(seed=13):
    rng = np.random.default_rng(seed)
    shapes = {'fc0/w': (8, 4), 'fc0/b': (4,), 'fc1/w': (4, 3)}
    upd = {k: rng.standard_normal(s, dtype=np.float32)
           for k, s in shapes.items()}
    raw = {k: (v + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in upd.items()}
    return upd, raw


@pytest.mark.parametrize('kappa', [1e-3, 1e4])   # clipped, and not
def test_kl_clip_is_kl_clip_trace_at_momentum_zero(kappa):
    upd, raw = _kl_inputs()
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa
    step = torch.tensor(0, dtype=torch.int32)
    extras = tr.Extras(raw_grads=t(raw), step=step)
    clip = clipping.kl_clip(kappa=kappa, lr=0.1)
    out, state = clip.update(t(upd), clip.init(t(upd)), None, extras)
    assert isinstance(state, tr.EmptyState)
    trace = clipping.kl_clip_trace(kappa=kappa, lr=0.1, momentum=0.0)
    out_t, _ = trace.update(t(upd), trace.init(t(upd)), None, extras)
    for k in upd:
        assert torch.equal(out[k], out_t[k]), k
    jextras = jtr.Extras(raw_grads={k: jnp.asarray(v) for k, v in raw.items()},
                         step=jnp.asarray(0, jnp.int32))
    jclip_t = jclip.kl_clip(kappa=kappa, lr=0.1)
    jupd = {k: jnp.asarray(v) for k, v in upd.items()}
    ref, _ = jclip_t.update(jupd, jclip_t.init(jupd), None, jextras)
    for k in upd:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)
    if kappa > 1:   # inside the region: the updates pass unchanged
        for k in upd:
            assert torch.equal(out[k], torch.from_numpy(upd[k]))


def test_tree_helpers_and_scale_match_reference():
    upd, _ = _kl_inputs(14)
    tree = {k: torch.from_numpy(v) for k, v in upd.items()}
    jtree = {k: jnp.asarray(v) for k, v in upd.items()}
    tree['half'] = torch.from_numpy(upd['fc1/w']).to(torch.bfloat16)
    jtree['half'] = jnp.asarray(upd['fc1/w']).astype(jnp.bfloat16)
    got, ref = tr.tree_scale(tree, 0.37), jtr.tree_scale(jtree, 0.37)
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(ref[k], np.float32), rtol=1e-6)
    zeros = tr.tree_zeros_like(tree)
    assert all(torch.count_nonzero(z) == 0 and z.dtype == tree[k].dtype
               for k, z in zeros.items())
    assert tr.tree_zeros_like(tree, torch.float64)['half'].dtype == \
        torch.float64
    sc = tr.scale(-2.0)
    out, state = sc.update(tree, sc.init(tree), None, None)
    assert isinstance(state, tr.EmptyState)
    jsc = jtr.scale(-2.0)
    jout, _ = jsc.update(jtree, jsc.init(jtree), None, None)
    for k in upd:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-6)
    assert tr.ScheduleState._fields == jtr.ScheduleState._fields == ()


def test_comm_metrics_scope_sees_only_its_sites():
    from repro_torch.comm import metrics
    metrics.record('outside/x', bytes_per_call=1, codec='f32', mode='psum')
    with metrics.scope() as s:
        metrics.record('inside/x', bytes_per_call=8, codec='f32',
                       mode='psum')
        assert set(s.snapshot()) == {'inside/x'}
        assert s.snapshot()['inside/x']['bytes_per_call'] == 8
    metrics.record('after/x', bytes_per_call=2, codec='f32', mode='psum')
    assert set(s.snapshot()) == {'inside/x'}
    assert {'outside/x', 'inside/x', 'after/x'} <= set(metrics.snapshot())


def test_is_spec_and_spec_tree_map_match_reference():
    from repro.models import module as JM
    from repro_torch.models import module as M
    specs = {'a': {'w': M.ParamSpec((3, 4)), 'b': M.ParamSpec((4,))},
             'c': M.ParamSpec((2,), init='zeros')}
    jspecs = {'a': {'w': JM.ParamSpec((3, 4), axes=(None, None)),
                    'b': JM.ParamSpec((4,), axes=(None,))},
              'c': JM.ParamSpec((2,), axes=(None,), init='zeros')}
    assert M.is_spec(specs['c']) and not M.is_spec(specs['a'])
    assert JM.is_spec(jspecs['c']) and not JM.is_spec(jspecs['a'])
    shapes = M.spec_tree_map(lambda s: s.shape, specs)
    assert shapes == JM.spec_tree_map(lambda s: s.shape, jspecs)
    assert shapes == {'a': {'w': (3, 4), 'b': (4,)}, 'c': (2,)}


def test_cells_for_and_skip_reasons_match_reference():
    from repro.configs import cells_for as jcells
    from repro.configs import get_config as jget
    from repro_torch.configs import ARCH_IDS, cell_skip_reason, cells_for
    from repro_torch.configs import get_config
    assert len(ARCH_IDS) == 10
    skipped = 0
    for arch in ARCH_IDS:
        got = [(s.name, s.seq_len, s.global_batch, s.kind, why)
               for s, why in cells_for(get_config(arch))]
        ref = [(s.name, s.seq_len, s.global_batch, s.kind, why)
               for s, why in jcells(jget(arch))]
        assert got == ref, arch
        for shape, why in cells_for(get_config(arch)):
            assert cell_skip_reason(get_config(arch), shape) == why
        skipped += sum(why is not None for *_, why in got)
    assert 0 < skipped < 10
