"""The demo transformer LM trained by Shampoo (every factor dense) in the
port against the reference: 10 steps of ``demo_lm('small')`` from the same
weights and batches.  A file of its own because the reference's step,
with an ``eigh`` of every factor side, is the slowest of the set.  The
setup and the tolerances are ``test_torch_lm_train.py``'s.
"""
import pytest

pytest.importorskip('torch')

from test_torch_lm_train import (_no_launches, _one_thread,  # noqa: E402,F401
                                 check, run_both)


def test_shampoo_dense_matches_reference():
    check(*run_both('shampoo'), 'shampoo')
