"""The control of ``correct`` comes out not correct under each cell's own
limits: the reference computed in float8 (``reference/lowp.py``) put in the
program's place, at the reduced sizes in bfloat16 on the CPU.  (Its
readings at the cells' own sizes on the card, which set the limits, are in
PERF.md.)"""
import pytest

from portbench_cpu import CELLS, small_cell


@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    from portbench.harness import check, manifest
    from portbench.harness.weights import token_batches
    from portbench.reference.lowp import fp8
    c = small_cell(cell, 'bfloat16')
    batches = token_batches(c.traffic, c.config['vocab'], 21, 'cpu')[:3]
    ref = check.reference_readings(c, 21, batches, 'cpu')
    ctl = check.reference_readings(c, 21, batches, 'cpu', quant=fp8)
    correct, checks = check.judge(check.compare(ctl, ref),
                                  manifest.limits(cell))
    assert not correct, checks
