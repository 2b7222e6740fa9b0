"""The port's layouts (``repro_torch.sharding``, ``launch/mesh.py``) against
the reference's ``repro.sharding``, on the CPU.

* ``resolve_pspec`` through ``param_shardings``, ``input_shardings`` and
  ``cache_shardings`` give the reference's specs exactly, with the same
  fallback log lines, for every leaf of all ten full configs on the
  (16, 16) and (2, 16, 16) production shapes and of the reduced configs on
  (2, 2, 2); ``opt_state_shardings`` likewise for every optimizer's state
  on the reduced dense, MoE (K-FAC and Shampoo apart: their full taps do
  not fit expert stacks in either package) and SSM configs and Eva's on
  the other token-input configs (the reference's specs on its
  ``AbstractMesh``, no devices needed).
* The port's MoE at G = 2 and G = 4 groups (an abstract ('data', 'model')
  mesh, data = G) against the reference's grouped MoE jitted with
  ``in_shardings`` under a four-device mesh of the same shape (a
  subprocess): the slot tables equal as integers, the output and the aux
  loss within 1e-5 (f32).
* Four gloo ranks on a (2, 2) DeviceMesh: the reduced dense LM and the
  reduced qwen3-moe with DTensor parameters and batch give the
  one-process loss (the same abstract mesh) within 1e-5; measured: equal.
* ``constrain`` and ``shard_activations`` are the identity without a mesh,
  on plain tensors under an abstract one, and inside a data group in
  scope; the production meshes have the reference's shapes.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.core.registry import make_optimizer as jmake_optimizer  # noqa
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import decode_specs as jdecode_specs  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.sharding import logical as JL  # noqa: E402
from repro.train.step import init_opt_state as jinit_opt_state  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_reduced  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.models import build_model, decode_specs  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.sharding import compat  # noqa: E402
from repro_torch.sharding import logical as L  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).parent))
MESHES = {'single': ((16, 16), ('data', 'model')),
          'multi': ((2, 16, 16), ('pod', 'data', 'model'))}
MINI = ((2, 2, 2), ('pod', 'data', 'model'))
OPTIMIZERS = ('adagrad', 'adamw', 'eva', 'eva_f', 'eva_s', 'foof', 'kfac',
              'mfac', 'sgd', 'shampoo')


def _meshes(shape, names):
    return compat.AbstractMesh(shape, names), JAbstractMesh(shape, names)


def _spec(ns, ndim):
    """A reference NamedSharding's spec as the port's tuple."""
    s = tuple(ns.spec)
    return s + (None,) * (ndim - len(s))


def _ref_leaves(tree) -> dict:
    """{'/'-joined key path: leaf} of a reference tree, as the port's
    ``core.transform.tree_leaves_with_path`` walks its own."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for k in path:
            if isinstance(k, jax.tree_util.DictKey):
                parts.append(str(k.key))
            elif isinstance(k, jax.tree_util.GetAttrKey):
                parts.append(k.name)
            elif isinstance(k, jax.tree_util.SequenceKey):
                parts.append(str(k.idx))
        out['/'.join(parts)] = leaf
    return out


def _port_pairs(tree, spec, prefix='') -> dict:
    """{path: spec} of the port's tensor leaves, the spec tree walked beside
    the state (a spec is itself a tuple)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: spec}
    out = {}
    if isinstance(tree, dict):
        items = [(k, tree[k], spec[k]) for k in tree]
    elif isinstance(tree, tuple) and hasattr(tree, '_fields'):
        items = list(zip(tree._fields, tree, spec))
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), t, s) for i, (t, s) in enumerate(zip(tree, spec))]
    else:
        return out
    for k, t, s in items:
        out.update(_port_pairs(t, s, f'{prefix}/{k}' if prefix else str(k)))
    return out


@pytest.mark.parametrize('mesh_name', ['single', 'multi', 'mini'])
@pytest.mark.parametrize('arch', ARCH_IDS)
def test_param_input_cache_specs_equal_reference(arch, mesh_name):
    full = mesh_name != 'mini'
    shape, names = MINI if not full else MESHES[mesh_name]
    mesh, jmesh = _meshes(shape, names)
    cfg = get_config(arch) if full else get_reduced(arch)
    jcfg = jget_config(arch) if full else jget_reduced(arch)
    # parameters, with the fallback log
    log, jlog = [], []
    got = M.flatten_specs(L.param_shardings(
        build_model(cfg).param_specs(), mesh, log))
    jspecs = jbuild_model(jcfg).param_specs()
    want = JM.flatten_specs(JM.spec_tree_map(
        lambda s: JL.resolve_pspec(s.shape, s.axes, jmesh, jlog), jspecs))
    assert set(got) == set(want)
    for p in want:
        assert got[p] == tuple(want[p]) + (None,) * (
            len(got[p]) - len(tuple(want[p]))), p
    assert log == jlog
    # every input and cache of the four cells
    for cell in SHAPES:
        b, s = cell.global_batch, cell.seq_len
        for seq_dim in (1, None):
            got_b = L.batch_pspec((b, s), mesh, seq_dim)
            assert got_b == tuple(JL.batch_pspec((b, s), jmesh, seq_dim))
        if cell.kind != 'decode':
            continue
        cache, _, _ = decode_specs(cfg, cell)
        jcache, _, _ = jdecode_specs(jcfg, cell)
        got_c = _port_pairs(cache, L.cache_shardings(cache, mesh))
        want_c = _ref_leaves(JL.cache_shardings(jcache, jmesh))
        assert set(got_c) == set(want_c)
        for p, ns in want_c.items():
            assert got_c[p] == _spec(ns, len(got_c[p])), (cell.name, p)


def _opt_state_case(arch, name):
    mesh, jmesh = _meshes(*MINI)
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    b = 8
    toks = np.zeros((b, 16), np.int32)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device='cpu')
    opt, cap = make_optimizer(name)
    batch = {'tokens': torch.from_numpy(toks),
             'labels': torch.from_numpy(toks)}
    from repro_torch.core import kv
    from repro_torch.train.step import init_opt_state
    taps_fn = jtaps_fn = None
    if cap.b == 'outer':       # K-FAC-style capture: full z-shaped taps
        from repro.core import kv as jkv
        paths = set(model.precon_paths()) & set(params)
        taps_fn = lambda p, bt: kv.make_full_taps(  # noqa: E731
            p, paths, tuple(bt['tokens'].shape))
        jtaps_fn = lambda p, bt: jkv.make_full_taps(  # noqa: E731
            p, paths, tuple(bt['tokens'].shape))
    state = init_opt_state(model, opt, cap, params, batch, taps_fn,
                           device='cpu')
    got = _port_pairs(state, L.opt_state_shardings(
        state, model.param_specs(), mesh))
    jopt, jcap = jmake_optimizer(name)
    jparams = JM.abstract_params(jmodel.param_specs())
    jbatch = {k: jax.ShapeDtypeStruct((b, 16), jnp.int32)
              for k in ('tokens', 'labels')}
    jstate = jax.eval_shape(
        lambda p, bt: jinit_opt_state(jmodel, jopt, jcap, p, bt, jtaps_fn),
        jparams, jbatch)
    want = _ref_leaves(JL.opt_state_shardings(jstate, jmodel.param_specs(),
                                              jmesh))
    assert set(got) == set(want), (set(got) ^ set(want))
    for p, ns in want.items():
        assert got[p] == _spec(ns, len(got[p])), p


# K-FAC and Shampoo capture full z-shaped taps, sized (batch, seq) for
# every weight: in neither package do they fit the MoE's expert stacks
STATE_CASES = [(arch, name) for arch in ('qwen2-0.5b', 'qwen3-moe-30b-a3b',
                                         'mamba2-780m')
               for name in OPTIMIZERS
               if not (arch == 'qwen3-moe-30b-a3b'
                       and name in ('kfac', 'shampoo'))]


@pytest.mark.parametrize('arch,name', STATE_CASES)
def test_opt_state_specs_equal_reference(arch, name):
    _opt_state_case(arch, name)


@pytest.mark.parametrize('arch', [
    a for a in ARCH_IDS if a not in ('qwen2-0.5b', 'qwen3-moe-30b-a3b',
                                     'mamba2-780m')
    and get_reduced(a).family != 'encdec'
    and not get_reduced(a).input_is_embeds])
def test_eva_state_specs_equal_reference(arch):
    _opt_state_case(arch, 'eva')


# ---------------------------------------------------------------------------
# Grouped MoE against the reference's, jitted under a four-device mesh

D, FF, E, TOPK = 16, 24, 8, 2
_MOE_SCRIPT = textwrap.dedent("""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.models import moe as jmoe
    from repro.sharding import compat
    G = int(sys.argv[1])
    data = np.load(sys.argv[2])
    p = {'router': {'w': jnp.asarray(data['router'])},
         'gate': {'w': jnp.asarray(data['gate'])},
         'up': {'w': jnp.asarray(data['up'])},
         'down': {'w': jnp.asarray(data['down'])}}
    x = jnp.asarray(data['x'])
    seen = []

    def keep(*outs):
        if not seen:
            seen.append([np.asarray(o) for o in outs])

    class Spy:
        def __getattr__(self, name):
            return getattr(jax, name)

        def vmap(self, fn, *a, **k):
            mapped = jax.vmap(fn, *a, **k)

            def call(*args):
                out = mapped(*args)
                jax.debug.callback(keep, *jax.tree_util.tree_leaves(out))
                return out
            return call
    jmoe.jax = Spy()
    mesh = compat.make_mesh((G, 4 // G), ('data', 'model'))
    rep = NamedSharding(mesh, P())
    f = lambda p, x: jmoe.moe_apply(p, x, top_k=%d, capacity_factor=1.25,
                                    aux_coef=0.01)
    with compat.set_mesh(mesh):
        y, aux = jax.jit(f, in_shardings=(
            jax.tree_util.tree_map(lambda _: rep, p),
            NamedSharding(mesh, P('data'))))(p, x)
        y = np.asarray(y)
        aux = float(aux)
    jax.effects_barrier()
    np.savez(sys.argv[3], y=y, aux=aux, *seen[0])
""" % TOPK)


@pytest.mark.parametrize('groups', [2, 4])
def test_grouped_moe_matches_reference(groups, tmp_path, monkeypatch):
    from repro_torch.models import moe
    rng = np.random.default_rng(groups)
    arrays = {
        'router': rng.standard_normal((D, E)).astype(np.float32) * 0.5,
        'gate': rng.standard_normal((E, D, FF)).astype(np.float32) * 0.3,
        'up': rng.standard_normal((E, D, FF)).astype(np.float32) * 0.3,
        'down': rng.standard_normal((E, FF, D)).astype(np.float32) * 0.3,
        'x': rng.standard_normal((4, 12, D)).astype(np.float32)}
    # a skewed router sends most tokens to expert 0, past its capacity
    arrays['router'][:, 0] += 1.0
    arrays['x'] += np.float32(1.0)
    np.savez(tmp_path / 'in.npz', **arrays)
    out = subprocess.run(
        [sys.executable, '-c', _MOE_SCRIPT, str(groups),
         str(tmp_path / 'in.npz'), str(tmp_path / 'out.npz')],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, 'PYTHONPATH': 'src', 'JAX_PLATFORMS': 'cpu'})
    assert out.returncode == 0, out.stderr[-3000:]
    ref = np.load(tmp_path / 'out.npz')
    tables = []
    route = moe.route

    def spy(*a, **k):
        got = route(*a, **k)
        tables.append(got)
        return got
    monkeypatch.setattr(moe, 'route', spy)
    p = {'moe/router/w': torch.from_numpy(arrays['router']),
         **{f'moe/{n}/w': torch.from_numpy(arrays[n])
            for n in ('gate', 'up', 'down')}}
    with compat.set_mesh(compat.AbstractMesh((groups, 4 // groups),
                                             ('data', 'model'))):
        y, aux = moe.moe_apply(p, torch.from_numpy(arrays['x']),
                               top_k=TOPK, capacity_factor=1.25, path='moe',
                               aux_coef=0.01)
    slot_token, slot_mask, flat_slot, ok = tables[0]
    assert slot_token.shape[0] == groups
    for name, g, i in (('slot_token', slot_token, 0),
                       ('slot_mask', slot_mask, 1),
                       ('flat_slot', flat_slot, 2), ('ok', ok, 3)):
        np.testing.assert_array_equal(g.numpy(), ref[f'arr_{i}'],
                                      err_msg=name)
    assert not ok.all(), 'expert 0 should overflow a group'
    scale = np.abs(ref['y']).max()
    assert np.abs(y.numpy() - ref['y']).max() <= 1e-5 * scale
    assert abs(float(aux) - float(ref['aux'])) <= 1e-5


# ---------------------------------------------------------------------------
# DTensor parameters on four gloo ranks


@pytest.mark.multihost
@pytest.mark.parametrize('arch', ['qwen2-0.5b', 'qwen3-moe-30b-a3b'])
def test_dtensor_loss_on_four_ranks_is_the_one_process_loss(arch):
    import torch_dist_cases as C

    from repro_torch.launch import workers
    cfg = get_reduced(arch)
    params = M.init_params(build_model(cfg).param_specs(),
                           torch.Generator().manual_seed(0), device='cpu')
    params_np = {k: v.numpy() for k, v in params.items()}
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    batch_np = {'tokens': toks, 'labels': np.roll(toks, -1, 1)}
    one = C.layout_loss(arch, params_np, batch_np)
    res = workers.spawn(C.layout_cases, 4, (arch, params_np, batch_np),
                        backend='gloo', device='cpu', timeout=300,
                        threads=1)
    for loss, _ in res:
        assert abs(loss - one) <= 1e-5 * max(abs(one), 1.0)
    assert all(r[1] == res[0][1] for r in res)   # the same fallbacks


# ---------------------------------------------------------------------------
# The constraints and the meshes


def test_constraints_are_identities_off_a_device_mesh():
    from repro_torch.comm import group as group_mod
    from repro_torch.sharding.constraints import constrain, shard_activations
    x = torch.randn(4, 6, 8)
    assert constrain(x, 'data', None, 'model') is x
    assert shard_activations(x, seq='model') is x
    with compat.set_mesh(compat.AbstractMesh((2, 2), ('data', 'model'))):
        assert constrain(x, 'data', None, 'model') is x
        assert shard_activations(x) is x
        from repro_torch.models.moe import _n_data_shards
        assert _n_data_shards() == 2
        # inside a data group in scope (the reference's shard_map body)
        # no constraint applies and the MoE routes in one group
        scope = group_mod.DataScope(group=None, world=2, rank=0)
        with group_mod.in_scope(scope):
            assert compat.bound_axis_names() == ('data',)
            assert _n_data_shards() == 1
    assert compat.current_mesh() is None


def test_production_meshes_have_the_reference_shapes():
    from repro_torch.launch import mesh as pmesh
    single = pmesh.make_production_mesh()
    multi = pmesh.make_production_mesh(multi_pod=True)
    assert compat.mesh_shape(single) == {'data': 16, 'model': 16}
    assert compat.mesh_shape(multi) == {'pod': 2, 'data': 16, 'model': 16}
    assert compat.mesh_size(multi) == 512
    assert compat.mesh_shape(pmesh.make_host_mesh()) == {'data': 1,
                                                         'model': 1}
    assert compat.mesh_shape(pmesh.make_data_mesh()) == {'data': 1}
    with pytest.raises(ValueError):
        pmesh.make_data_mesh(2)
