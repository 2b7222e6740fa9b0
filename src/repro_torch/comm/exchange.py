"""Cross-worker exchanges — PyTorch port of ``psum_partials`` from
``repro/comm/exchange.py``.

The port runs one process, so the one collective of the factor-sharded
solve is the identity.  Waiting for later layers: the multi-worker form (a
``torch.distributed`` all-reduce of the f32 partials over a process group,
in place of the reference's mesh axes) with the multi-device layers, and
the byte telemetry of each call site (the reference's ``metrics.record``)
with the telemetry layer.
"""
from __future__ import annotations

from typing import Any


def psum_partials(tree: Any, world: int) -> Any:
    """Sum the full-width per-worker matvec partials of the factor-sharded
    solve (``core/factor_sharded.py``) over the ``world`` workers.  At
    ``world <= 1`` each partial is already the whole product: returned as it
    is.  Raises for more workers, whose exchange is not ported."""
    if world > 1:
        raise NotImplementedError(
            f'psum_partials over {world} workers is not ported; the port '
            'runs one process')
    return tree
