"""backward_ms: the step's 'backward' span (``train/step.py``): one
backward pass for the weight and the tap gradients, remat's recompute in
it, then ``kv.finalize_stats``.  Device ms a step, as ``forward_ms``."""
from portbench.harness import phases


def read(ctx):
    return phases.ms_per_step(ctx, 'backward')
