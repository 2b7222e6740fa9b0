"""The port's training CLI (``repro_torch.launch.train.main``) against the
reference's (``repro.launch.train.main``) on the CPU.

Both run ``--arch demo --steps 6 --batch 4 --seq-len 32 --log-every 1
--no-prefetch`` from the same weights: the reference's
``init_params(PRNGKey(0))``, handed to the port through
``M.params_from_numpy`` by replacing the port CLI's ``init_params`` in this
test only.  Stated tolerance: every ``step`` record's loss within rtol 1e-4
of the reference's (Eva, Eva fused, K-FAC with the 512-wide head sharded,
Shampoo).  ``--elastic --world 2`` (two gloo ranks) is held to the port's
own ``--elastic --world 1`` within rtol 1e-4: the reference's elastic run
needs two forced host devices.  ``--autotune`` (4 steps, both packages'
``autotune.default_bench`` replaced by the same rising fake) tunes the
reference's keys and tracks the reference's CLI within rtol 1e-4.  The
refusals: ``--kernel-impl cuda`` on the CPU raises, a stub-frontend arch
exits with the reference's message.
"""
import json
import sys

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import demo_lm as jdemo_lm  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.obs.events import validate_record as ref_validate  # noqa: E402
from repro_torch.kernels import autotune, dispatch, launches  # noqa: E402
from repro_torch.kernels.dispatch import KernelConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.obs.events import validate_record  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

RTOL = 1e-4


def _reset_dispatch():
    for mod in (dispatch, jdispatch):
        mod.reset_cache()
        mod.set_default_impl('auto')
    jdispatch._choices.clear()


@pytest.fixture(autouse=True)
def _clean_dispatch_state():
    """The CLIs install their caches in-process: reset both packages'
    dispatch state around each test."""
    _reset_dispatch()
    yield
    _reset_dispatch()

BASE = ['--arch', 'demo', '--steps', '6', '--batch', '4', '--seq-len', '32',
        '--log-every', '1', '--no-prefetch']
CASES = {
    'eva': ['--opt', 'eva'],
    'eva_fused': ['--opt', 'eva', '--fused'],
    'kfac_shard': ['--opt', 'kfac', '--head-policy', 'shard',
                   '--head-threshold', '512'],
    'shampoo': ['--opt', 'shampoo'],
}


def _step_losses(out_dir, opt):
    path = out_dir / f'demo-small-{opt}' / 'metrics.jsonl'
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert all(not validate_record(r) and not ref_validate(r) for r in recs)
    steps = [r for r in recs if r['event'] == 'step']
    return [r['step'] for r in steps], np.array([r['loss'] for r in steps])


def _reference_params(model, device):
    del model
    ref = JM.init_params(jbuild(jdemo_lm('small')).param_specs(),
                         jax.random.PRNGKey(0))
    return M.params_from_numpy(ref, device)


@pytest.mark.parametrize('case', list(CASES))
def test_cli_tracks_reference_cli(case, tmp_path, monkeypatch):
    flags = BASE + CASES[case]
    opt = CASES[case][1]
    monkeypatch.setattr(sys, 'argv', ['train'] + flags + [
        '--out-dir', str(tmp_path / 'ref')])
    jtrain.main()
    monkeypatch.setattr(ttrain, 'init_params', _reference_params)
    launches.reset()
    history = ttrain.main(flags + ['--out-dir', str(tmp_path / 'port'),
                                   '--device', 'cpu'])
    assert all(v == 0 for v in launches.snapshot().values())
    ref_steps, ref = _step_losses(tmp_path / 'ref', opt)
    steps, got = _step_losses(tmp_path / 'port', opt)
    assert steps == ref_steps == list(range(6))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(np.array(history), got)
    assert got[-1] < got[0]
    print(f'{case}: max rel loss diff {np.max(np.abs(got - ref) / ref):.3e}')


def test_elastic_world_two_matches_world_one(tmp_path, monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    runs = {}
    for world in (1, 2):
        history = ttrain.main(BASE + ['--opt', 'eva', '--elastic',
                                      '--world', str(world), '--device',
                                      'cpu', '--out-dir',
                                      str(tmp_path / f'w{world}')])
        assert [s for s, _ in history] == list(range(6))
        steps, losses = _step_losses(tmp_path / f'w{world}', 'eva')
        assert steps == list(range(6))
        np.testing.assert_array_equal(losses, [v for _, v in history])
        runs[world] = losses
    np.testing.assert_allclose(runs[2], runs[1], rtol=RTOL, atol=0)
    print('W=2 against W=1: max rel loss diff '
          f'{np.max(np.abs(runs[2] - runs[1]) / runs[1]):.3e}')


def test_profile_run_writes_spans_and_checkpoints(tmp_path):
    ttrain.main(BASE + ['--opt', 'eva', '--fused', '--profile',
                        '--ckpt-every', '3', '--device', 'cpu',
                        '--out-dir', str(tmp_path)])
    run = tmp_path / 'demo-small-eva'
    recs = [json.loads(line) for line in
            (run / 'metrics.jsonl').read_text().splitlines()]
    names = {r['name'] for r in recs if r['event'] == 'span'}
    assert {'step', 'data', 'grad', 'precondition', 'apply'} <= names
    assert sum(r['event'] == 'profile' for r in recs) == 6
    assert sorted(p.name for p in (run / 'ckpt').iterdir()
                  if p.name.startswith('step_')) == ['step_00000003',
                                                     'step_00000006']


def _fake_bench():
    """Strictly increasing times: the first candidate wins ('xla' in the
    reference, 'torch' in the port), and no candidate runs."""
    calls = {'n': 0}

    def bench(fn, reps=3, warmup=1):
        del fn, reps, warmup
        calls['n'] += 1
        return float(calls['n'])
    return bench


def test_autotune_names_its_roadmap_item(tmp_path, monkeypatch):
    """``--autotune`` (ROADMAP item 13d) against the reference's: both
    tune the same keys (apart from the backend prefix) under the same
    fake bench, train from the same weights within rtol 1e-4 a step, and
    the port's step records carry ``kernel_impl`` 'auto' and the
    ``kernel_tiles`` its cache names."""
    flags = ['--arch', 'demo', '--steps', '4', '--batch', '4', '--seq-len',
             '32', '--log-every', '1', '--no-prefetch', '--autotune']
    monkeypatch.setattr(jautotune, 'default_bench', _fake_bench())
    monkeypatch.setattr(autotune, 'default_bench', _fake_bench())
    monkeypatch.setattr(sys, 'argv', ['train'] + flags + [
        '--out-dir', str(tmp_path / 'ref')])
    jtrain.main()
    monkeypatch.setattr(ttrain, 'init_params', _reference_params)
    launches.reset()
    history = ttrain.main(flags + ['--out-dir', str(tmp_path / 'port'),
                                   '--device', 'cpu'])
    assert all(v == 0 for v in launches.snapshot().values())
    caches = {side: json.loads((tmp_path / side / 'demo-small-eva' /
                                'tile_cache.json').read_text())['entries']
              for side in ('ref', 'port')}
    assert len(caches['port']) == 5 * len(autotune.OPS)
    assert {k.split('/', 1)[1] for k in caches['port']} == \
        {k.split('/', 1)[1] for k in caches['ref']}
    assert all(e['impl'] == 'xla' for e in caches['ref'].values())
    assert all(e['impl'] == 'torch' for e in caches['port'].values())
    ref_steps, ref = _step_losses(tmp_path / 'ref', 'eva')
    steps, got = _step_losses(tmp_path / 'port', 'eva')
    assert steps == ref_steps == list(range(4))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(np.array(history), got)
    recs = [json.loads(line) for line in (
        tmp_path / 'port' / 'demo-small-eva' / 'metrics.jsonl'
    ).read_text().splitlines()]
    for r in (r for r in recs if r['event'] == 'step'):
        assert r['kernel_impl'] == 'auto'
        assert set(r['kernel_tiles']) == {'bilinear', 'rank1_update'}
        for op, choice in r['kernel_tiles'].items():
            impl, blocks, _, shape = choice.split()
            e = caches['port'][f'cpu/{op}/float32/{shape}']
            assert (impl, blocks) == (e['impl'], f"{e['block_in']}x"
                                                 f"{e['block_out']}")


def test_kernel_impl_cuda_on_the_cpu_raises(tmp_path):
    with pytest.raises(ValueError, match='--device cuda'):
        ttrain.main(BASE + ['--kernel-impl', 'cuda', '--device', 'cpu',
                            '--out-dir', str(tmp_path)])


def test_kernel_impl_reaches_the_optimizer_and_the_factor(monkeypatch,
                                                          tmp_path):
    """``--kernel-impl torch`` becomes the trainer's ``KernelConfig``, which
    reaches the optimizer through ``Extras.kernel`` as in the reference, and
    the sharded solve's ``FactorShardConfig.impl``; the optimizer factories
    take no ``kernel_impl``."""
    seen = {}
    real = ttrain.make_optimizer

    def spy(name, **kw):
        seen[name] = kw
        return real(name, **kw)
    monkeypatch.setattr(ttrain, 'make_optimizer', spy)
    factors, kernels = [], []
    real_trainer = ttrain.Trainer

    def trainer(*a, factor=None, kernel=None, **kw):
        factors.append(factor)
        kernels.append(kernel)
        return real_trainer(*a, factor=factor, kernel=kernel, **kw)
    monkeypatch.setattr(ttrain, 'Trainer', trainer)
    short = ['--arch', 'demo', '--steps', '1', '--batch', '2', '--seq-len',
             '8', '--no-prefetch', '--device', 'cpu', '--kernel-impl',
             'torch', '--out-dir', str(tmp_path)]
    ttrain.main(short + ['--opt', 'eva'])
    assert all(v.startswith('torch ')
               for v in dispatch.choices_snapshot().values())
    ttrain.main(short + ['--opt', 'kfac', '--head-policy', 'shard',
                         '--head-threshold', '512', '--solve-iters', '4'])
    ttrain.main(short + ['--opt', 'sgd'])
    assert not any('kernel_impl' in kw for kw in seen.values())
    assert kernels == [KernelConfig(impl='torch')] * 3
    assert set(dispatch.choices_snapshot()) >= {'bilinear', 'rank1_update',
                                                'matvec_cols'}
    assert factors[0] is None
    assert (factors[1].impl, factors[1].head_policy,
            factors[1].shard_threshold, factors[1].solve_iters) == (
        'torch', 'shard', 512, 4)


def test_stub_frontend_arch_is_refused():
    with pytest.raises(SystemExit, match='stub-frontend'):
        ttrain.main(['--arch', 'whisper-tiny', '--reduced', '--device',
                     'cpu'])


def test_distributed_needs_elastic():
    with pytest.raises(SystemExit, match='--elastic'):
        ttrain.main(BASE + ['--distributed', '--device', 'cpu'])


def test_distributed_runs_the_elastic_loop_in_this_process(tmp_path,
                                                           monkeypatch):
    """``--distributed --elastic`` joins a group started from the
    environment (one gloo rank on localhost here) and leaves it after."""
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    for key, value in {'MASTER_ADDR': 'localhost', 'MASTER_PORT': str(port),
                       'RANK': '0', 'WORLD_SIZE': '1'}.items():
        monkeypatch.setenv(key, value)
    history = ttrain.main(BASE + ['--opt', 'eva', '--distributed',
                                  '--elastic', '--device', 'cpu',
                                  '--out-dir', str(tmp_path / 'd')])
    assert not dist.is_initialized()
    ttrain.main(BASE + ['--opt', 'eva', '--device', 'cpu', '--out-dir',
                        str(tmp_path / 'f')])
    steps, losses = _step_losses(tmp_path / 'f', 'eva')
    assert [s for s, _ in history] == steps
    np.testing.assert_array_equal([v for _, v in history], losses)
