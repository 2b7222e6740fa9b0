"""The command without a card, and without the program: it exits with a
code other than 0, says why on standard error, and prints no result."""
import shutil
import subprocess
import sys

import pytest

from portbench_cpu import ROOT

ARGS = ['--workload', 'qwen3moe-d4.eva.4k', '--seed', '3000000001',
        '--seconds', '1', '--trace', '0']


def _run(cwd):
    return subprocess.run([sys.executable, 'portbench/run.py', *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300,
                          env={'PATH': '/usr/bin:/bin',
                               'CUDA_VISIBLE_DEVICES': ''})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode == 2
    assert out.stdout == ''
    assert 'CUDA' in out.stderr and 'no CPU fallback' in out.stderr


@pytest.mark.parametrize('trace', ['0', '1'])
def test_without_the_program(tmp_path, trace):
    """A directory with only BENCHMARK.json and portbench/ does not run."""
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run([sys.executable, 'portbench/run.py', *ARGS[:-1],
                          trace], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300,
                         env={'PATH': '/usr/bin:/bin'})
    assert out.returncode != 0
    assert out.stdout == ''
