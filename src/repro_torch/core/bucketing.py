"""Bucketed parameter grouping for vectorized preconditioning — PyTorch port.

Counterpart of ``repro/core/bucketing.py``.  Parameter paths group by
``(shape, dtype)`` into buckets keyed ``"<dtype>_<d0>x<d1>..."`` (the
reference's keys, e.g. ``'float32_784x1000'``), emitted in sorted-key order
with sorted paths.  A bucket of ``min_bucket_size`` (3) or more members is
``stacked``: its leaves stack on a new axis 0 and run one kernel launch.
Smaller buckets run per path.  Optimizer state stays bucket-stacked for
every bucket either way.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Mapping, NamedTuple, Optional

import torch

from repro_torch.core.transform import tree_map

DEFAULT_MIN_BUCKET_SIZE = 3


class Bucket(NamedTuple):
    key: str                    # "<dtype>_<d0>x<d1>..."
    paths: tuple[str, ...]      # sorted; index in this tuple == stack index
    shape: tuple[int, ...]      # per-leaf shape (without the stack axis)
    dtype: Any                  # torch dtype
    stacked: bool = True        # False: small bucket, per-path calls


class BucketPlan(NamedTuple):
    buckets: tuple[Bucket, ...]

    @property
    def paths(self) -> tuple[str, ...]:
        return tuple(p for b in self.buckets for p in b.paths)

    def __len__(self) -> int:
        return len(self.buckets)


def dtype_name(dtype: torch.dtype) -> str:
    """'float32', 'bfloat16', ... — numpy's and JAX's names."""
    return str(dtype).rsplit('.', 1)[-1]


def bucket_key(shape, dtype: torch.dtype) -> str:
    return f"{dtype_name(dtype)}_{'x'.join(map(str, shape))}"


@functools.lru_cache(maxsize=512)
def _plan_from_sig(sig: tuple, min_bucket_size: int) -> BucketPlan:
    groups: dict[str, list] = {}
    meta: dict[str, tuple] = {}
    for path, shape, dtype in sig:
        key = bucket_key(shape, dtype)
        groups.setdefault(key, []).append(path)
        meta[key] = (shape, dtype)
    return BucketPlan(buckets=tuple(
        Bucket(key=k, paths=tuple(sorted(groups[k])), shape=meta[k][0],
               dtype=meta[k][1], stacked=len(groups[k]) >= min_bucket_size)
        for k in sorted(groups)))


def build_plan(flat: Mapping[str, Any],
               predicate: Optional[Callable[[str, Any], bool]] = None,
               min_bucket_size: Optional[int] = None) -> BucketPlan:
    """Group ``{path: tensor}`` into a deterministic BucketPlan;
    ``predicate(path, tensor)`` filters the paths."""
    if min_bucket_size is None:
        min_bucket_size = DEFAULT_MIN_BUCKET_SIZE
    sig = tuple(sorted((p, tuple(x.shape), x.dtype)
                       for p, x in flat.items()
                       if predicate is None or predicate(p, x)))
    return _plan_from_sig(sig, min_bucket_size)


def gather(plan: BucketPlan, flat: Mapping[str, torch.Tensor]
           ) -> dict[str, torch.Tensor]:
    """Stack each bucket's leaves along a new axis 0: {key: (N, *shape)}."""
    return {b.key: torch.stack([flat[p] for p in b.paths])
            for b in plan.buckets}


def scatter(plan: BucketPlan, bucketed: Mapping[str, torch.Tensor]
            ) -> dict[str, torch.Tensor]:
    """Inverse of ``gather``: {path: (*shape)} in plan order."""
    out = {}
    for b in plan.buckets:
        for i, p in enumerate(b.paths):
            out[p] = bucketed[b.key][i]
    return out


def gather_tree(plan: BucketPlan, flat: Mapping[str, Any]) -> dict[str, Any]:
    """``gather`` for per-path NamedTuples (``kv.LayerStats``): each field
    stacks across the bucket's paths; None fields stay None."""
    out = {}
    for b in plan.buckets:
        trees = [flat[p] for p in b.paths]
        out[b.key] = tree_map(lambda *ls: torch.stack(ls), *trees)
    return out


def is_bucketed(plan: BucketPlan, mapping: Mapping[str, Any]) -> bool:
    """True when ``mapping`` is keyed by this plan's bucket keys."""
    keys = {b.key for b in plan.buckets}
    return bool(mapping) and set(mapping) <= keys
