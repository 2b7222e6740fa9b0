"""capture_ms: Eva's KV capture, device ms a step: the 'capture' spans
directly under 'forward' (each ``kv.fwd_stats`` and ``kv.fwd_stats_masked``
call of the forward pass) and the one under 'backward' around
``kv.finalize_stats``.  Remat's recompute repeats the forward's captures
under 'recompute' into statistics that are dropped; they are left out.
The tap gradients (b̄) come out of the backward pass with the weight
gradients and cannot be separated from it: they are in ``backward_ms``."""
from portbench.harness import phases


def _key(rec):
    if rec['name'] == 'capture' and rec['parent'] in ('forward',
                                                      'backward'):
        return 'capture'
    return None


def read(ctx):
    return phases.ms_per_step(ctx, 'capture', _key)
