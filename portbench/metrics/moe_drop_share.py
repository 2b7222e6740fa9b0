"""moe_drop_share: the share of the MoE layers' top-k assignments dropped
past their expert's capacity, over the profiled steps: the program's
counters ``moe.dropped/<path>`` over ``moe.assignments/<path>``
(``models/moe.py::moe_apply``, once a call; remat's recompute repeats each
layer's routing, which leaves the share as it is)."""
from portbench.harness import phases


def read(ctx):
    assigned = phases.counter_total('moe.assignments/')
    dropped = phases.counter_total('moe.dropped/')
    if not assigned or dropped is None:
        return None
    return 100.0 * dropped / assigned
