"""Faults planted in the program's step, to show that the check of
``correct`` catches them (the fault tests, and ``calibrate.py``'s readings
of them on the card).  Each wraps ``step(params, state, batch)``."""
from __future__ import annotations


def state_unchanged(step):
    """A step that returns the parameters and the state it was given."""
    def broken(params, state, batch):
        _, _, metrics = step(params, state, batch)
        return params, state, metrics
    return broken


def half_batch(step):
    """A step that leaves out the second half of the batch's rows: the
    mean is taken over the rest."""
    def broken(params, state, batch):
        rows = next(iter(batch.values())).shape[0] // 2
        return step(params, state, {k: v[:rows] for k, v in batch.items()})
    return broken


def params_unapplied(step):
    """A step that takes its gradient into the optimizer's state but
    returns the parameters it was given: the update is never applied."""
    def broken(params, state, batch):
        _, state, metrics = step(params, state, batch)
        return params, state, metrics
    return broken


FAULTS = {'state_unchanged': state_unchanged, 'half_batch': half_batch,
          'params_unapplied': params_unapplied}
