"""The port's checkpoint (``repro_torch.train.checkpoint``): the cases of
``tests/test_checkpoint_data.py`` for the round trip, the async keep-K
writer, atomicity, structural mismatches and GC; a resume in the middle of a
refresh interval, bit for bit within the port (K-FAC every 3 steps saved at
step 4, Shampoo every 2 at step 3, Eva under ``adaptive`` at step 4); and
checkpoints crossing between the packages in both directions, for the
parameters and the Eva and K-FAC state, with the same leaf paths
(``jax.tree_util.keystr``) on both sides.  Restored values are compared
bit for bit.
"""
import json

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import kv as jkv  # noqa: E402
from repro.core.registry import make_optimizer as jmake  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.step import init_opt_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jstep_fn  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.schedule.policy import adaptive  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import init_opt_state, make_train_step  # noqa


def _tree():
    return {'a': {'w': torch.arange(12.0).reshape(3, 4)},
            'opt': (torch.zeros(()), {'m': torch.ones(5) * 2})}


def _equal(a, b):
    la, lb = ckpt.leaf_paths(a), ckpt.leaf_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, p
        assert torch.equal(x, y), p


def test_roundtrip_and_paths(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 3, t, {'next_step': 3})
    template = {'a': {'w': torch.zeros(3, 4)},
                'opt': (torch.zeros(()), {'m': torch.zeros(5)})}
    restored, meta = ckpt.restore(tmp_path, 3, template, device='cpu')
    assert meta['next_step'] == 3
    _equal(t, restored)
    manifest = json.loads((tmp_path / 'step_00000003' / 'manifest.json')
                          .read_text())
    assert [x['path'] for x in manifest['leaves']] == \
        ["['a']['w']", "['opt'][0]", "['opt'][1]['m']"]
    assert (tmp_path / 'step_00000003' / '.complete').exists()
    assert not (tmp_path / 'step_00000003.tmp').exists()


def test_flat_slash_keys_are_written_as_nested_dicts(tmp_path):
    """The port's flat '/'-keyed dicts carry the reference's nested paths,
    NamedTuple fields are '.field' and None subtrees have no leaf."""
    from repro_torch.core.transform import TraceState
    from repro_torch.schedule.policy import SchedState
    z = torch.zeros(())
    tree = {'params': {'fc0/w': torch.ones(2, 2)},
            'opt_state': (TraceState(trace={'fc0/w': torch.ones(2, 2)}),
                          SchedState(z, z, z, z, None))}
    assert [p for p, _ in ckpt.leaf_paths(tree)] == [
        "['params']['fc0']['w']", "['opt_state'][0].trace['fc0']['w']",
        "['opt_state'][1].count", "['opt_state'][1].since",
        "['opt_state'][1].n_refresh", "['opt_state'][1].staleness"]


def test_async_and_gc(tmp_path):
    c = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        c.save(s, _tree(), {'next_step': s})
    c.wait()
    assert ckpt.available_steps(tmp_path) == [3, 4]
    assert ckpt.latest_step(tmp_path) == 4


def test_async_save_copies_before_returning(tmp_path):
    """The writer holds a host copy: writing the caller's tensor after
    ``save`` returns does not reach the checkpoint."""
    t = _tree()
    c = ckpt.AsyncCheckpointer(tmp_path, keep=1)
    c.save(1, t)
    t['a']['w'].fill_(-1.0)
    c.wait()
    restored, _ = ckpt.restore(tmp_path, 1, _tree(), device='cpu')
    assert torch.equal(restored['a']['w'], torch.arange(12.0).reshape(3, 4))


def test_atomicity_incomplete_ignored(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    (tmp_path / 'step_00000009').mkdir()   # a crashed save: no marker
    assert ckpt.latest_step(tmp_path) == 1


@pytest.mark.parametrize('saved,template,exc,match', [
    # a template leaf absent from the manifest is a structural mismatch
    ({'a': torch.zeros(3)}, {'a': torch.zeros(3), 'b': torch.zeros(2)},
     KeyError, 'missing leaf'),
    ({'a': {'w': torch.zeros(3, 4)}}, {'a': {'w': torch.zeros(4, 3)}},
     ValueError, r"\['a'\]\['w'\]"),
], ids=['missing_leaf', 'shape_mismatch'])
def test_restore_structural_mismatch_raises(tmp_path, saved, template, exc,
                                            match):
    ckpt.save(tmp_path, 1, saved)
    with pytest.raises(exc, match=match):
        ckpt.restore(tmp_path, 1, template, device='cpu')


def test_restore_missing_step_raises(tmp_path):
    ckpt.save(tmp_path, 1, {'a': torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, 99, {'a': torch.zeros(3)}, device='cpu')


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is usable')
    ckpt.save(tmp_path, 1, {'a': torch.zeros(3)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore(tmp_path, 1, {'a': torch.zeros(3)})


@pytest.mark.parametrize('steps,keep,crashed,want', [
    # keep <= 0 never deletes (not 'delete everything')
    ((1, 2, 3), 0, False, [1, 2, 3]),
    ((1, 2, 3), -1, False, [1, 2, 3]),
    ((1, 2), 5, False, [1, 2]),
    # an uncommitted directory neither counts nor is deleted
    ((1, 2, 3), 1, True, [3]),
], ids=['keep0', 'keep-1', 'keep_more', 'skips_incomplete'])
def test_gc(tmp_path, steps, keep, crashed, want):
    for s in steps:
        ckpt.save(tmp_path, s, {'a': torch.zeros(2)})
    if crashed:
        (tmp_path / 'step_00000009').mkdir()
    ckpt.gc_old(tmp_path, keep=keep)
    assert ckpt.available_steps(tmp_path) == want
    if crashed:
        assert (tmp_path / 'step_00000009').exists()


def test_gc_missing_dir_is_noop(tmp_path):
    ckpt.gc_old(tmp_path / 'never_created', keep=2)
    assert ckpt.available_steps(tmp_path / 'never_created') == []


# ---------------------------------------------------------------------------
# Resume in the middle of a refresh interval, within the port


def _sched_train(name, steps, tmp_path=None, save_at=None, **opt_kw):
    stream = tsyn.ClassStream(batch=32, dim=8, classes=3, seed=0,
                              device='cpu')
    model = simple.MLP([8, 16, 3])
    model.loss_fn = simple.classifier_loss_fn(model)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device='cpu')
    opt, capture = make_optimizer(name, lr=0.05, **opt_kw)
    state = init_opt_state(model, opt, capture, params, stream.batch_at(0),
                           device='cpu')
    step = make_train_step(model, opt, capture, device='cpu')
    for i in range(steps):
        if save_at is not None and i == save_at:
            ckpt.save(tmp_path, i, {'params': params, 'opt_state': state},
                      {'next_step': i})
            template = {'params': params, 'opt_state': init_opt_state(
                model, opt, capture, params, stream.batch_at(0),
                device='cpu')}
            restored, meta = ckpt.restore(tmp_path, i, template,
                                          device='cpu')
            params, state = restored['params'], restored['opt_state']
            assert meta['next_step'] == i
        params, state, _ = step(params, state, stream.batch_at(i))
    return params, state


@pytest.mark.parametrize('name,kw,save_at', [
    # step 4 is mid-interval for k=3 (last refresh at 3): the cached
    # inverses and the since-counter must survive the round trip
    ('kfac', {'interval': 3}, 4),
    ('shampoo', {'interval': 2}, 3),
    # the adaptive policy's drift snapshot is part of the checkpoint
    ('eva', {'policy': adaptive(threshold=0.05)}, 4),
])
def test_refresh_state_resume_bit_exact(tmp_path, name, kw, save_at):
    p_ref, s_ref = _sched_train(name, 7, **kw)
    p_res, s_res = _sched_train(name, 7, tmp_path=tmp_path, save_at=save_at,
                                **kw)
    _equal(p_ref, p_res)
    _equal(s_ref, s_res)


# ---------------------------------------------------------------------------
# Checkpoints cross between the packages


CROSS = {'eva': {}, 'kfac': {'interval': 3}}


def _ref_side(name, steps=3):
    stream = jsyn.ClassStream(batch=32, dim=8, classes=3, seed=0)
    model = jsimple.MLP([8, 16, 3])
    model.loss_fn = jsimple.classifier_loss_fn(model)
    params = JM.init_params(model.param_specs(), jax.random.PRNGKey(0))
    opt, cap = jmake(name, lr=0.05, **CROSS[name])
    taps_fn = (lambda p: model.make_taps(32, cap)) if cap.needs_taps else None
    st = jinit(model, opt, cap, params, stream.batch_at(0), taps_fn=taps_fn)
    step = jax.jit(jstep_fn(model, opt, cap, taps_fn=taps_fn))
    tree0 = {'params': params, 'opt_state': st}
    for i in range(steps):
        params, st, _ = step(params, st, stream.batch_at(i))
    return {'params': params, 'opt_state': st}, tree0


def _port_side(name, steps=3):
    stream = tsyn.ClassStream(batch=32, dim=8, classes=3, seed=0,
                              device='cpu')
    model = simple.MLP([8, 16, 3])
    model.loss_fn = simple.classifier_loss_fn(model)
    jp = JM.init_params(jsimple.MLP([8, 16, 3]).param_specs(),
                        jax.random.PRNGKey(0))
    params = M.params_from_numpy(
        {k: np.asarray(v) for k, v in jkv.flatten_params(jp).items()}, 'cpu')
    opt, cap = make_optimizer(name, lr=0.05, **CROSS[name])
    st = init_opt_state(model, opt, cap, params, stream.batch_at(0),
                        device='cpu')
    step = make_train_step(model, opt, cap, device='cpu')
    tree0 = {'params': params, 'opt_state': st}
    for i in range(steps):
        params, st, _ = step(params, st, stream.batch_at(i))
    return {'params': params, 'opt_state': st}, tree0


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


@pytest.mark.parametrize('name', sorted(CROSS))
def test_reference_checkpoint_restores_into_the_port(tmp_path, name):
    ref, _ = _ref_side(name)
    jckpt.save(tmp_path, 3, ref, {'next_step': 3})
    _, template = _port_side(name, steps=0)
    got, meta = ckpt.restore(tmp_path, 3, template, device='cpu')
    assert meta == {'next_step': 3}
    want = _ref_leaves(ref)
    paths = ckpt.leaf_paths(got)
    assert {p for p, _ in paths} == set(want)
    for p, x in paths:
        np.testing.assert_array_equal(x.numpy(), want[p], err_msg=p)
        assert x.numpy().dtype == want[p].dtype, p
    # the restored state steps on in the port
    stream = tsyn.ClassStream(batch=32, dim=8, classes=3, seed=0,
                              device='cpu')
    model = simple.MLP([8, 16, 3])
    model.loss_fn = simple.classifier_loss_fn(model)
    opt, cap = make_optimizer(name, lr=0.05, **CROSS[name])
    _, _, met = make_train_step(model, opt, cap, device='cpu')(
        got['params'], got['opt_state'], stream.batch_at(3))
    assert np.isfinite(float(met['loss']))


@pytest.mark.parametrize('name', sorted(CROSS))
def test_port_checkpoint_restores_into_the_reference(tmp_path, name):
    port, _ = _port_side(name)
    ckpt.save(tmp_path, 3, port, {'next_step': 3})
    _, template = _ref_side(name, steps=0)
    got, meta = jckpt.restore(tmp_path, 3, template)
    assert meta == {'next_step': 3}
    got_leaves = _ref_leaves(got)
    paths = ckpt.leaf_paths(port)
    assert {p for p, _ in paths} == set(got_leaves)
    for p, x in paths:
        np.testing.assert_array_equal(got_leaves[p], x.numpy(), err_msg=p)
