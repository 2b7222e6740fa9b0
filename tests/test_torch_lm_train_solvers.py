"""The demo transformer LM trained by K-FAC (every factor dense, and with
the head's 512-wide output side sharded: ``FactorShardConfig(head_policy=
'shard', shard_threshold=512)``, CG) and SGD, in the port
against the reference: 10 steps of ``demo_lm('small')`` from the same
weights and batches, K-FAC's full taps sized from each batch's (batch, seq)
tokens.  The setup and the tolerances are ``test_torch_lm_train.py``'s.
"""
import pytest

pytest.importorskip('torch')

from test_torch_lm_train import (_no_launches, _one_thread,  # noqa: E402,F401
                                 check, run_both)


@pytest.mark.parametrize('name,shard', [('kfac', False), ('kfac', True),
                                        ('sgd', False)],
                         ids=['kfac-dense', 'kfac-shard', 'sgd'])
def test_matches_reference(name, shard):
    check(*run_both(name, shard=shard), name)
