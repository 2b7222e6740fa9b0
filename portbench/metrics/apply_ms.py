"""apply_ms: the step's 'apply' span (``core/transform.py::
apply_updates``): the updates added to the parameters.  Device ms a step,
as ``forward_ms``."""
from portbench.harness import phases


def read(ctx):
    return phases.ms_per_step(ctx, 'apply')
