"""A run with the timed path broken underneath comes out not correct,
under the cell's own limits (``limits/<cell>.json``), for each fault a
one-chip training cell can have: a step that returns its state unchanged,
half of each batch left out with the mean taken over the rest, and a step
that updates its optimizer state but never applies the update to the
parameters.  The
exchange between chips has no place on one chip, and no token is produced.
The sound run of the same cell comes out correct.  At the reduced sizes on
the CPU, skipping only the harness's look for a card."""
import pytest

from portbench_cpu import CELLS, run_small


@pytest.mark.parametrize('cell', CELLS)
def test_sound_run_is_correct(cell):
    out = run_small(cell)
    assert out['result']['correct'], out['result']['checks']


@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch',
                                   'params_unapplied'])
@pytest.mark.parametrize('cell', CELLS)
def test_fault_is_not_correct(cell, fault):
    from portbench.harness.faults import FAULTS
    out = run_small(cell, fault=FAULTS[fault])
    assert not out['result']['correct'], out['result']['checks']
