"""ssd_ms: Mamba-2's chunked SSD scan, device ms a step: every span 'ssd'
(``models/ssm.py::mamba_block`` around the scan, under 'forward' and under
remat's 'recompute'; ``kernels/ssd.py``'s backward under 'backward'),
summed.  None where the program records no such span (a model without the
SSD, or a program that does not record it)."""
from portbench.harness import phases


def _key(rec):
    return 'ssd' if rec['name'] == 'ssd' and rec['parent'] != 'ssd' else None


def read(ctx):
    return phases.ms_per_step(ctx, 'ssd', _key)
