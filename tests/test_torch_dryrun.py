"""The port's dry run (``repro_torch.launch.dryrun``) and its abstract specs
against the reference's, on the CPU.

* ``abstract_params`` of the ten full configs, and the batch and cache
  stand-ins of every (config x shape) cell (``train_batch_specs``,
  ``prefill_batch_specs``, ``decode_specs``), equal the reference's
  ``ShapeDtypeStruct`` trees leaf for leaf in shape and dtype name;
  ``abstract_opt_state`` (Eva's) likewise on the reduced token-input
  configs.
* The reference's four mini cells (``tests/test_dryrun_mini.py``:
  reduced qwen2 and qwen3-moe train, mamba2 decode, jamba train at 8 x 16
  tokens) on a (2, 2, 2) ('pod', 'data', 'model') mesh of a 'fake' group:
  every record field, positive FLOPs and traffic, collective bytes in the
  train cells, and one rank's ``argument_bytes`` equal to the sum of the
  DTensor arguments' local shard bytes and to the specs' own count.
* ``--list`` prints the reference's plan, line for line: every arch x
  shape x mesh of ``cells_for``'s grid.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.core.registry import make_optimizer as jmake_optimizer  # noqa
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import decode_specs as jdecode_specs  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import prefill_batch_specs as jprefill_specs  # noqa: E402
from repro.models import train_batch_specs as jtrain_specs  # noqa: E402
from repro.train.step import abstract_opt_state as jabstract_opt  # noqa
from repro_torch.configs import SHAPES, cells_for, get_config  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.core.transform import tree_leaves_with_path  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import (build_model, decode_specs,  # noqa: E402
                                prefill_batch_specs, train_batch_specs)
from repro_torch.models import module as M  # noqa: E402
from repro_torch.train.step import abstract_opt_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIELDS = ('n_chips', 'params_total', 'params_active', 'tokens_per_step',
          'model_flops_total', 'model_flops_per_chip', 'useful_flop_ratio',
          'per_device', 'roofline_s', 'dominant', 'collective_by_op',
          'collective_count', 'memory', 'lower_s', 'compile_s',
          'sharding_fallbacks')


def _ref_leaves(tree) -> dict:
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
        out['/'.join(parts)] = (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree) -> dict:
    return {p: (tuple(t.shape), str(t.dtype).removeprefix('torch.'))
            for p, t in tree_leaves_with_path(tree).items()
            if isinstance(t, torch.Tensor)}


@pytest.mark.parametrize('arch', ARCH_IDS)
def test_abstract_params_and_cell_specs_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    params = M.abstract_params(build_model(cfg).param_specs())
    assert all(t.is_meta for t in params.values())
    assert _port_leaves(params) == _ref_leaves(
        JM.abstract_params(jbuild_model(jcfg).param_specs()))
    for shape in SHAPES:
        assert _port_leaves(train_batch_specs(cfg, shape)) == \
            _ref_leaves(jtrain_specs(jcfg, shape))
        assert _port_leaves(prefill_batch_specs(cfg, shape)) == \
            _ref_leaves(jprefill_specs(jcfg, shape))
        got = decode_specs(cfg, shape)
        assert all(t.is_meta for t in tree_leaves_with_path(got).values())
        assert _port_leaves(got) == _ref_leaves(jdecode_specs(jcfg, shape))


@pytest.mark.parametrize('arch', [a for a in ARCH_IDS
                                  if get_reduced(a).family != 'encdec'
                                  and not get_reduced(a).input_is_embeds])
def test_abstract_opt_state_equals_reference(arch):
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    model, jmodel = build_model(cfg), jbuild_model(jcfg)
    shape = ShapeCell('mini', seq_len=16, global_batch=4, kind='train')
    opt, cap = make_optimizer('eva', lr=0.01)
    state = abstract_opt_state(model, opt, cap,
                               M.abstract_params(model.param_specs()),
                               train_batch_specs(cfg, shape))
    assert all(t.is_meta for t in tree_leaves_with_path(state).values()
               if isinstance(t, torch.Tensor))
    jopt, jcap = jmake_optimizer('eva', lr=0.01)
    jstate = jabstract_opt(jmodel, jopt, jcap,
                           JM.abstract_params(jmodel.param_specs()),
                           jtrain_specs(jcfg, shape))
    assert _port_leaves(state) == _ref_leaves(jstate)


# ---------------------------------------------------------------------------
# The reference's mini cells on a fake (2, 2, 2) mesh


@pytest.fixture(scope='module')
def mini_mesh():
    import torch.distributed as dist

    from repro_torch.sharding import compat
    dryrun.fake_world(8)           # re-made over any group left before
    try:
        yield compat.make_mesh((2, 2, 2), ('pod', 'data', 'model'), 'cpu')
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize('arch,kind', [
    ('qwen2-0.5b', 'train'),
    ('qwen3-moe-30b-a3b', 'train'),
    ('mamba2-780m', 'decode'),
    ('jamba-v0.1-52b', 'train'),
])
def test_mini_cell_on_a_fake_222_mesh(mini_mesh, arch, kind):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import hlo_analysis as H
    cfg = get_reduced(arch)
    shape = ShapeCell('mini_train', seq_len=16, global_batch=8, kind=kind)
    rec = dryrun.measure(cfg, shape, mini_mesh, [])
    assert set(FIELDS) <= set(rec)
    assert rec['n_chips'] == 8
    per = rec['per_device']
    assert per['hlo_flops'] > 0 and per['hbm_traffic_bytes'] > 0
    if kind == 'train':
        assert per['collective_bytes'] > 0   # the gradient reduction
    assert per['cost_analysis_flops'] >= 0.5 * per['hlo_flops']
    assert set(rec['memory']) == {'argument_bytes', 'output_bytes',
                                  'temp_bytes', 'alias_bytes',
                                  'total_bytes'}
    assert rec['memory']['temp_bytes'] > 0
    # one rank's argument bytes: the DTensors' local shards, and the specs
    _, args, specs, *_ = dryrun.build_cell(cfg, shape, mini_mesh, [])
    dargs = dryrun.distribute_args(args, specs, mini_mesh,
                                   FakeTensorMode(allow_non_fake_inputs=True))
    local = sum(dryrun.local_tensor(t).numel() * t.element_size()
                for t in H._tensors(dargs))
    assert rec['memory']['argument_bytes'] == local == \
        dryrun.argument_bytes(args, specs, mini_mesh)


def test_list_prints_the_reference_plan(capsys, tmp_path):
    dryrun.main(['--list', '--out', str(tmp_path)])
    got = capsys.readouterr().out.strip().splitlines()
    want = [f'{arch} × {s.name} × {m}' for arch in ARCH_IDS
            for s, _ in cells_for(get_config(arch))
            for m in ('single', 'multi')]
    assert got == want
    out = subprocess.run(
        [sys.executable, '-m', 'repro.launch.dryrun', '--list', '--out',
         str(tmp_path / 'ref')], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, 'PYTHONPATH': 'src', 'JAX_PLATFORMS': 'cpu'})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines() == got
