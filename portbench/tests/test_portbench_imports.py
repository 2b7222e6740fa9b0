"""Nothing the benchmark runs loads JAX or the JAX package: no file under
portbench/ imports a module whose top-level name (the part before the
first dot, compared whole) is jax, jaxlib, flax or repro, and the
reference imports nothing of the program either; a run on the CPU ends
with none of them in ``sys.modules``."""
import ast
import json
import subprocess
import sys

import pytest

from portbench_cpu import ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'repro'}
BENCH = ROOT / 'portbench'


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', sorted(BENCH.rglob('*.py')),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    names = set(_top_level_imports(path))
    assert not names & FORBIDDEN
    if 'reference' in path.parts:
        assert 'repro_torch' not in names


def _modules_after(code):
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={'PATH': '/usr/bin:/bin', 'PYTHONPATH':
                              f'{ROOT}:{ROOT / "src"}',
                              'OMP_NUM_THREADS': '2'})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_reference_loads_no_program():
    mods = _modules_after(
        'import json, sys\n'
        'import portbench.reference.models.moe, portbench.reference.models.ssm\n'
        'import portbench.reference.optimizers.eva\n'
        'import portbench.reference.optimizers.sgd, portbench.reference.lowp\n'
        'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')
    assert not mods & (FORBIDDEN | {'repro_torch'})


def test_a_run_loads_no_jax():
    mods = _modules_after(
        'import json, sys\n'
        'sys.path.insert(0, "portbench/tests")\n'
        'from portbench_cpu import run_small\n'
        'out = run_small("qwen3moe-d4.eva.4k")\n'
        'assert out["result"]["attempted"] > 0\n'
        'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')
    assert 'repro_torch' in mods
    assert not mods & FORBIDDEN
