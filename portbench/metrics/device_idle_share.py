"""device_idle_share: the share of the profiled steps' window in which no
kernel, copy or fill ran on the device (one minus the union of their
intervals over the window), from the profiler's trace.  The steps are the
window's own call; the profiler records the device alone, and what it
still costs the host (a record of each launch) is in the share, which so
reads above an untraced step's."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
