"""Work ownership across data-parallel workers — PyTorch port of the parts of
``repro/schedule/ownership.py`` that the factor-sharded solve needs.

``factor_block`` and ``subslice_trips`` cut one oversized Kronecker factor
into contiguous row bands; ``lead_size`` and ``inverse_cost`` describe a
bucket's refresh work; ``world_and_rank`` says which worker this process is.
The port runs in one process: ``world_and_rank`` is ``(1, None)`` and raises
when a ``torch.distributed`` group of more than one process is up, since the
multi-worker exchange is not ported yet.  The reference's LPT owner
assignment and its describe helpers come with that exchange.
"""
from __future__ import annotations

from typing import Callable

import torch.distributed as dist

from repro_torch.core.bucketing import Bucket


def inverse_cost(sides: str = 'both') -> Callable[[Bucket], float]:
    """Flop estimate for refreshing one item of a bucket: cubic in each
    factor dim, times the product of the leading (scan/expert) dims.
    sides: 'left' (input factor only) or 'both' (K-FAC, Shampoo)."""
    if sides not in ('left', 'both'):
        raise ValueError(f"sides must be 'left' or 'both', got {sides!r}")

    def cost(bucket: Bucket) -> float:
        d_in, d_out = bucket.shape[-2], bucket.shape[-1]
        c = float(d_in) ** 3
        if sides == 'both':
            c += float(d_out) ** 3
        return lead_size(bucket) * c

    return cost


def lead_size(bucket: Bucket) -> int:
    """Product of a bucket's leading (scan/expert-stack) dims: the number of
    factor pairs one stack row carries."""
    lead = 1
    for d in bucket.shape[:-2]:
        lead *= int(d)
    return lead


def factor_block(d: int, world: int) -> int:
    """Rows per worker of a (d, d) factor cut into contiguous row bands:
    ``ceil(d / world)``.  Worker ``w`` holds rows ``[w*B, (w+1)*B)`` of the
    factor zero-padded to ``(world*B, d)``."""
    return -(-int(d) // int(world))


def subslice_trips(bucket: Bucket, threshold: int) -> tuple[bool, bool]:
    """(in_side, out_side): which factor sides of ``bucket`` reach the
    ``shard_threshold`` (factor dim >= threshold)."""
    d_in, d_out = int(bucket.shape[-2]), int(bucket.shape[-1])
    return d_in >= int(threshold), d_out >= int(threshold)


def world_and_rank():
    """(world, rank) of this process among the data-parallel workers.

    One process is ``(1, None)``: every factor band is this worker's, and
    the band partials need no exchange.  With a ``torch.distributed`` group
    of more than one process this raises: the band exchange over such a
    group is not ported."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            f'{dist.get_world_size()} workers: the multi-worker factor '
            'exchange is not ported; the port runs one process')
    return 1, None
