"""idle_in_step_ms: device ms a step in which no kernel, copy or fill ran
inside the step's phase spans ('forward' to 'apply', which tile a step),
against the profile's device intervals.  The rest of
``device_idle_share`` lies between one step's 'apply' and the next step's
'forward': the harness's loop between steps."""
from portbench.harness import phases


def read(ctx):
    s = phases.split(ctx)
    if s is None:
        return None
    idle = [s.by_key[n]['idle_ms'] for n in phases.PHASES if n in s.by_key]
    if not idle:
        return None
    return sum(idle) / ctx.profile.steps
