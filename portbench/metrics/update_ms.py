"""update_ms: the step's 'update' span (``train/step.py``): the bucket
plan over the statistics and the optimizer's ``update`` (Eva's
preconditioning, its KL clip and momentum; SGD's momentum).  Device ms a
step, as ``forward_ms``."""
from portbench.harness import phases


def read(ctx):
    return phases.ms_per_step(ctx, 'update')
