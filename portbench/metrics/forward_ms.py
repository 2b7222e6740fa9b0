"""forward_ms: the step's 'forward' span (``train/step.py``): the batch's
move and the taps, the model's forward pass to the loss, and Eva's capture
of the input statistics in it.  Device ms a step: the span's interval on
the device (CUDA events at its ends, put on the profile's clock), summed
over the profiled steps of the window's own call, over their number."""
from portbench.harness import phases


def read(ctx):
    return phases.ms_per_step(ctx, 'forward')
