"""On the card: each cell runs once untraced and once traced, with a short
window, and comes out correct with every metric it promises.  Skips
without a CUDA device (decided in the fixture, never at import)."""
import json
import subprocess
import sys

import pytest

from portbench_cpu import CELLS, ROOT


@pytest.fixture
def card():
    torch = pytest.importorskip('torch')
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the benchmark measures the card')


@pytest.mark.gpu
@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('cell', CELLS)
def test_cell_on_the_card(card, cell, trace):
    from portbench.harness import manifest
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                          cell, '--seed', '4000000007', '--seconds', '5',
                          '--trace', str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res['correct'], res['checks']
    assert list(res)[-1] == 'checks'
    c = manifest.load_cell(cell)
    want = c.per_layer if trace else c.end_to_end
    assert set(res['metrics']) == {m['name'] for m in want}
    assert res['device']['platform'] == 'gpu' and res['device']['count'] == 1
