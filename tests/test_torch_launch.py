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
needs two forced host devices.  The refusals: ``--autotune`` names ROADMAP
item 13d, ``--kernel-impl cuda`` on the CPU raises, a stub-frontend arch
exits with the reference's message.
"""
import json
import sys

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.registry import demo_lm as jdemo_lm  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.obs.events import validate_record as ref_validate  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.obs.events import validate_record  # noqa: E402
from test_torch_lm_train import _one_thread  # noqa: E402,F401

RTOL = 1e-4
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


def test_autotune_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match='13d'):
        ttrain.main(BASE + ['--autotune', '--device', 'cpu'])


def test_kernel_impl_cuda_on_the_cpu_raises(tmp_path):
    with pytest.raises(ValueError, match='--device cuda'):
        ttrain.main(BASE + ['--kernel-impl', 'cuda', '--device', 'cpu',
                            '--out-dir', str(tmp_path)])


def test_kernel_impl_reaches_the_optimizer_and_the_factor(monkeypatch,
                                                          tmp_path):
    """``--kernel-impl torch`` becomes Eva's ``kernel_impl`` and the
    sharded solve's ``FactorShardConfig.impl``; an optimizer without a
    kernel takes no ``kernel_impl``."""
    seen = {}
    real = ttrain.make_optimizer

    def spy(name, **kw):
        seen[name] = kw
        return real(name, **kw)
    monkeypatch.setattr(ttrain, 'make_optimizer', spy)
    factors = []
    real_trainer = ttrain.Trainer

    def trainer(*a, factor=None, **kw):
        factors.append(factor)
        return real_trainer(*a, factor=factor, **kw)
    monkeypatch.setattr(ttrain, 'Trainer', trainer)
    short = ['--arch', 'demo', '--steps', '1', '--batch', '2', '--seq-len',
             '8', '--no-prefetch', '--device', 'cpu', '--kernel-impl',
             'torch', '--out-dir', str(tmp_path)]
    ttrain.main(short + ['--opt', 'eva'])
    ttrain.main(short + ['--opt', 'kfac', '--head-policy', 'shard',
                         '--head-threshold', '512', '--solve-iters', '4'])
    ttrain.main(short + ['--opt', 'sgd'])
    assert seen['eva']['kernel_impl'] == 'torch'
    assert 'kernel_impl' not in seen['kfac']
    assert 'kernel_impl' not in seen['sgd']
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
