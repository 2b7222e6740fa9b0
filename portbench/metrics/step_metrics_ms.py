"""step_metrics_ms: the step's 'step_metrics' span (``train/step.py::
_step_metrics``): the gradient norm over every leaf in f32 and the refresh
and pipeline counters.  Device ms a step, as ``forward_ms``."""
from portbench.harness import phases


def read(ctx):
    return phases.ms_per_step(ctx, 'step_metrics')
