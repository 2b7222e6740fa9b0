"""Parameter specs and initialization — PyTorch port of
``repro/models/module.py``.

Parameters are flat dicts of tensors keyed by the reference's paths
(``'fc0/w'``, ``'blocks/attn/q/w'``), in the reference's (d_in, d_out)
weight layout.  Weights come from an explicit ``torch.Generator``
(``init_params``) or, to compare with the reference, from its own
``init_params`` output as numpy (``params_from_numpy``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.transform import tree_leaves_with_path
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape, dtype, initializer and stddev override of one parameter.  The
    reference's logical sharding axes are not ported."""
    shape: tuple[int, ...]
    dtype: Any = torch.float32
    init: str = 'scaled'          # scaled | normal | zeros | ones
    scale: Optional[float] = None  # stddev override


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_tree_map(fn: Callable[[ParamSpec], Any], specs: Any) -> Any:
    """Map over a nested dict of ParamSpec."""
    if isinstance(specs, dict):
        return {k: spec_tree_map(fn, v) for k, v in specs.items()}
    return fn(specs)


def flatten_specs(specs: Any, prefix: str = '') -> dict[str, Any]:
    """Nested dict -> {'a/b/c': leaf}; a flat dict maps to itself."""
    out = {}
    if isinstance(specs, dict):
        for k, v in specs.items():
            key = f'{prefix}/{k}' if prefix else str(k)
            out.update(flatten_specs(v, key))
    else:
        out[prefix] = specs
    return out


def stack_specs(specs: Any, n: int) -> Any:
    """Add a leading stacked dim of ``n`` (the layer stack)."""
    if isinstance(specs, dict):
        return {k: stack_specs(v, n) for k, v in specs.items()}
    return dataclasses.replace(specs, shape=(n,) + tuple(specs.shape))


def count_params(specs: Any) -> int:
    return sum(math.prod(s.shape) for s in flatten_specs(specs).values())


def subtree(tree: Optional[dict], prefix: str) -> Optional[dict]:
    """Entries of a flat '/'-keyed dict under ``prefix``, keyed relative to
    it; None when there are none."""
    if tree is None:
        return None
    pfx = prefix + '/'
    out = {k[len(pfx):]: v for k, v in tree.items() if k.startswith(pfx)}
    return out or None


def add_prefix(tree: Optional[dict], prefix: str) -> dict:
    if not tree:
        return {}
    return {f'{prefix}/{k}': v for k, v in tree.items()}


def _init_one(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    """One leaf, drawn on the generator's device."""
    dev = gen.device
    if spec.init == 'zeros':
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == 'ones':
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == 'normal':
        std = spec.scale if spec.scale is not None else 0.02
    elif spec.init == 'scaled':  # fan-in scaled (1/sqrt(d_in) over dim -2)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    else:
        raise ValueError(f'unknown init {spec.init!r}')
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=dev) * std
    return x.to(spec.dtype)


def init_params(specs: Any, generator: torch.Generator,
                device='cuda') -> dict[str, torch.Tensor]:
    """Materialize a spec tree as flat ``{path: tensor}``: one draw per path
    in sorted path order from ``generator``, then moved to ``device``.  A
    CPU generator gives the same weights on every device; a CUDA one draws
    on the card (for weights too large to draw on the host)."""
    dev = resolve_device(device)
    flat = flatten_specs(specs)
    return {p: _init_one(flat[p], generator).to(dev) for p in sorted(flat)}


def tensor_from_numpy(x) -> torch.Tensor:
    """A CPU tensor holding a copy of array ``x``; a bfloat16 array (numpy's
    ``ml_dtypes`` extension type, as JAX hands it out) keeps its bits, read
    as uint16 and viewed as ``torch.bfloat16``."""
    arr = np.array(x, copy=True)
    if arr.dtype.name == 'bfloat16':
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree: dict, device) -> dict[str, torch.Tensor]:
    """The port's flat parameters from ``{path: array}`` or from a nested
    tree of arrays (the reference's ``init_params`` output as it comes,
    flattened here to '/'-joined paths such as ``'blocks/attn/q/w'``);
    bfloat16 leaves included."""
    dev = resolve_device(device)
    return {p: tensor_from_numpy(v).to(dev)
            for p, v in sorted(flatten_specs(tree).items())}


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {p: v.detach().cpu().numpy() for p, v in params.items()}


def state_to_numpy(state: Any) -> dict[str, np.ndarray]:
    """Optimizer state as ``{path: array}``: NamedTuple fields by name,
    tuple entries by index, dict keys joined with '/', None dropped — the
    same paths a like walk over the reference's state gives.  A ``HeadState``
    side that is excluded or sharded is ``()`` in both packages and has no
    leaf, so ``KfacState``/``ShampooState`` with sharded heads flatten to the
    reference's leaf names (``head/buckets/<key>/inv_in``, ``.../gam_out``,
    ``head/solve_iters``, ...)."""
    return {p: v.detach().cpu().numpy()
            for p, v in tree_leaves_with_path(state).items()}
