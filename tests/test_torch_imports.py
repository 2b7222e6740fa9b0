"""The port stands alone: no module of ``src/repro_torch``, no
``examples/*_torch.py``, ``scripts/obs_report_torch.py`` nor
``chip_smoke.py`` imports JAX or the reference package, and the entry points
run on the card unless the caller asks for the CPU."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / 'src' / 'repro_torch').rglob('*.py')) + \
    sorted((ROOT / 'examples').glob('*_torch.py')) + \
    [ROOT / 'scripts' / 'obs_report_torch.py', ROOT / 'chip_smoke.py']
BANNED = ('jax', 'jaxlib', 'repro')


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split('.')[0] in BANNED]
    assert not bad, f'{path.relative_to(ROOT)} imports {bad}'


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {'eva.py', 'step.py', 'dispatch.py', 'chip_smoke.py', 'kfac.py',
            'shampoo.py', 'factor_sharded.py', 'foof.py', 'mfac.py',
            'firstorder.py', 'policy.py', 'checkpoint.py', 'trainer.py',
            'memmap_loader.py', 'pipeline.py', 'events.py',
            'spans.py', 'moe.py', 'flash.py', 'ssm.py', 'mamba_lm.py',
            'hybrid.py', 'encdec.py', 'serve.py', 'qwen3_moe_30b_a3b.py',
            'whisper_tiny.py', 'kimi_k2_1t_a32b.py', 'mamba2_780m.py',
            'qwen2_0_5b.py', 'codeqwen1_5_7b.py', 'glm4_9b.py',
            'command_r_35b.py', 'llava_next_34b.py',
            'jamba_v0_1_52b.py', 'codec.py', 'metrics.py', 'group.py',
            'exchange.py', 'ownership.py', 'reshard.py', 'compression.py',
            'workers.py', 'runtime.py', 'report.py', 'train.py',
            'obs_report_torch.py', 'quickstart_torch.py',
            'train_lm_torch.py', 'autoencoder_eva_torch.py',
            'optimizer_comparison_torch.py', 'serve_lm_torch.py'} <= names


MULTI_WORKER_MODULES = ['repro_torch.comm.codec', 'repro_torch.comm.metrics',
                        'repro_torch.comm.group', 'repro_torch.comm.exchange',
                        'repro_torch.schedule.ownership',
                        'repro_torch.schedule.pipeline',
                        'repro_torch.schedule.reshard',
                        'repro_torch.schedule.runtime',
                        'repro_torch.train.compression',
                        'repro_torch.launch.workers',
                        'repro_torch.train.trainer']


@pytest.mark.parametrize('name', MULTI_WORKER_MODULES)
def test_multi_worker_modules_import_quietly(name):
    """Importing a module of the multi-worker layers starts no process
    and joins no group; outside a data group in scope the world is one."""
    import importlib

    import torch.distributed as dist
    importlib.import_module(name)
    assert not dist.is_initialized()
    from repro_torch.comm import group
    from repro_torch.schedule import ownership
    assert group.current() is None
    assert ownership.world_and_rank() == (1, None)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is usable')


def test_entry_points_default_to_the_card():
    """Without CUDA, an entry point called without device='cpu' raises."""
    _no_card()
    from repro_torch.core.registry import make_optimizer
    from repro_torch.models import module as M
    from repro_torch.models.simple import ae_loss_fn, autoencoder
    from repro_torch.train.step import init_opt_state, make_train_step
    model = autoencoder((8, 4, 8), d_in=16)
    model.loss_fn = ae_loss_fn(model)
    opt, cap = make_optimizer('eva')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, opt, cap)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(model.param_specs(), torch.Generator().manual_seed(0))
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device='cpu')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_opt_state(model, opt, cap, params,
                       {'x': torch.zeros(2, 16)})
    from repro_torch.configs.registry import get_reduced
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import build_model
    for arch in ('qwen3-moe-30b-a3b', 'mamba2-780m', 'jamba-v0.1-52b',
                 'whisper-tiny'):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(get_reduced(arch)).init_cache(2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve('qwen2-0.5b', reduced=True)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(['--arch', 'demo', '--steps', '1'])


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No fallback: without nvcc the build raises."""
    from repro_torch.kernels import build
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(build, 'BUILD_ROOT', tmp_path / 'build')
    if Path('/usr/local/cuda/bin/nvcc').exists():
        pytest.skip('the CUDA toolkit is installed at its fixed path')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.build_all()
