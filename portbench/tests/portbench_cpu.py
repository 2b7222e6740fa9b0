"""Helpers of the CPU tests: a cell at its configuration's reduced sizes
(the port's ``get_reduced``), and a short run of it on the CPU."""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / 'src')):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ('qwen3moe-d4.eva.4k', 'mamba2-780m.eva.16k', 'qwen3moe-d4.sgd.4k')
SMALL_TRAFFIC = dict(batch=4, seq=64, batches=4)


def small_cell(name: str, dtype: str = 'float32'):
    """The cell with the port's reduced configuration (float32 unless
    ``dtype``) and SMALL_TRAFFIC."""
    from portbench.harness import manifest
    from repro_torch.configs.registry import get_reduced
    cell = manifest.load_cell(name)
    red = get_reduced(cell.config_meta['arch'])
    cfg = {k: getattr(red, k) for k in cell.config}
    cfg['param_dtype'] = cfg['compute_dtype'] = dtype
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, **SMALL_TRAFFIC))


def run_small(name: str, seed: int = 2 ** 33 + 7, fault=None,
              trace: bool = False) -> dict:
    """A 0.2-second run of the small cell on the CPU, judged against the
    cell's own limits."""
    from portbench.harness import bench, manifest
    return bench.run(small_cell(name), seed, 0.2, trace, 'cpu',
                     time.perf_counter(), manifest.limits(name), fault=fault)
