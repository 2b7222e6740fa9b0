"""Logical-axis -> mesh-axis resolution with divisibility fallback — the
port's counterpart of ``repro/sharding/logical.py``.

Every ParamSpec carries logical axis names; RULES lists candidate mesh axes
per logical axis in priority order.  The resolver takes the first candidate
that (a) exists in the mesh, (b) divides the dimension, and (c) is not
already used by another dim of the same tensor.  An indivisible dim falls
back to the next candidate or to replication, and the decision is logged
(the dry run records the log).

A spec is a tuple with one entry per dim: None, a mesh-axis name, or a tuple
of names (the ``PartitionSpec`` analogue); ``compat.placements`` turns it
into DTensor placements on a DeviceMesh.  Resolution reads only the mesh's
shape, so an ``AbstractMesh`` serves as well as a ``DeviceMesh``.

Design: FSDP over 'data', TP/EP over 'model', pure DP across 'pod' (no
parameter sharding over the cross-pod axis).  Optimizer state is sharded by
mirroring: momentum and Adam moments match the param spec; KV statistics
(ā: drop the last dim, b̄: drop the second last) and KF outers inherit the
matching weight dim's assignment by shape.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import module as M
from repro_torch.sharding import compat

# logical axis -> mesh-axis candidates, in priority order
RULES: dict[Optional[str], tuple[str, ...]] = {
    'vocab': ('model',),
    'embed': ('data',),     # FSDP
    'mlp': ('model',),
    'heads': ('model',),
    'kv_heads': ('model',),
    'expert': ('model',),
    'inner': ('model',),    # mamba d_inner / in_proj fused dim
    'state': (),
    'layer': (),            # the layer stack: never shard
    'conv': (),
    None: (),
}


def resolve_pspec(shape: tuple[int, ...], axes: tuple[Optional[str], ...],
                  mesh, log: Optional[list] = None) -> tuple:
    assert len(shape) == len(axes), (shape, axes)
    sizes = compat.mesh_shape(mesh)
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, axes):
        assigned = None
        for cand in RULES.get(ax, ()):
            if cand not in sizes:
                continue
            if cand in used:
                continue
            if dim % sizes[cand] != 0:
                if log is not None:
                    log.append(f'  fallback: dim {dim} (axis {ax!r}) not '
                               f'divisible by {cand}={sizes[cand]}')
                continue
            assigned = cand
            used.add(cand)
            break
        out.append(assigned)
    return tuple(out)


def param_shardings(specs: Any, mesh, log: Optional[list] = None) -> Any:
    """ParamSpec tree -> spec tree (same structure)."""
    return M.spec_tree_map(
        lambda s: resolve_pspec(tuple(s.shape), s.logical_axes, mesh, log),
        specs)


# ---------------------------------------------------------------------------
# Inputs


def _data_axes(sizes: dict) -> tuple[str, ...]:
    return tuple(a for a in ('pod', 'data') if a in sizes)


def _data_entry(daxes: tuple[str, ...]):
    return daxes if len(daxes) > 1 else daxes[0]


def batch_pspec(shape: tuple[int, ...], mesh,
                seq_dim: Optional[int] = 1) -> tuple:
    """Shard dim 0 over (pod, data) when divisible; else (for batch-1
    long-context cells) shard the sequence dim over 'data'."""
    sizes = compat.mesh_shape(mesh)
    daxes = _data_axes(sizes)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]
    specs: list = [None] * len(shape)
    if shape and shape[0] % dsize == 0 and shape[0] > 0:
        specs[0] = _data_entry(daxes)
    elif (seq_dim is not None and len(shape) > seq_dim
          and shape[seq_dim] % sizes.get('data', 1) == 0):
        specs[seq_dim] = 'data'
    return tuple(specs)


def _tree_map_with_parts(fn, tree, parts: tuple = ()):
    """Map ``fn(parts, leaf)`` over the leaves of a tree of dicts,
    NamedTuples, tuples and lists: dict keys, NamedTuple field names and
    sequence indices (as strings) make the parts; None subtrees stay
    None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map_with_parts(fn, v, parts + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(_tree_map_with_parts(fn, v, parts + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map_with_parts(fn, v, parts + (str(i),))
                          for i, v in enumerate(tree))
    return fn(parts, tree)


def _tensor_map(fn, tree):
    """``fn`` over the tensor leaves; other leaves unchanged."""
    return _tree_map_with_parts(
        lambda parts, x: fn(x) if isinstance(x, torch.Tensor) else x, tree)


def input_shardings(tree: Any, mesh, seq_dim: Optional[int] = 1) -> Any:
    return _tensor_map(lambda x: batch_pspec(tuple(x.shape), mesh, seq_dim),
                       tree)


def cache_shardings(cache: Any, mesh) -> Any:
    """KV/SSM cache leaves: (L, B, S, KV, Dh) / (L, B, H, N, P) /
    (L, B, K, Ch).  Batch -> (pod, data) when divisible, else seq -> data;
    one model-axis dim among the trailing dims when divisible."""
    sizes = compat.mesh_shape(mesh)
    daxes = _data_axes(sizes)
    dsize = 1
    for a in daxes:
        dsize *= sizes[a]
    msize = sizes.get('model', 1)

    def one(x):
        shape = tuple(x.shape)
        specs: list = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % dsize == 0:
            specs[1] = _data_entry(daxes)
        elif len(shape) >= 3 and shape[2] % sizes.get('data', 1) == 0:
            specs[2] = 'data'   # batch=1: shard the sequence/state dim
        # model axis preference: dim 2 (attention seq / ssm heads), then
        # the KV-heads dim, then the last dim; never a contraction-heavy
        # dim first (a model-sharded head_dim would psum every score tile)
        if msize > 1 and len(shape) >= 3:
            for i in (2, len(shape) - 2, len(shape) - 1):
                if i >= len(shape) or i < 2:
                    continue
                if specs[i] is None and shape[i] % msize == 0:
                    specs[i] = 'model'
                    break
        return tuple(specs)

    return _tensor_map(one, cache)


# ---------------------------------------------------------------------------
# Optimizer state mirroring


def mirror_pspec(param_spec: tuple, param_shape: tuple[int, ...],
                 leaf_shape: tuple[int, ...]) -> tuple:
    ps = tuple(param_spec) + (None,) * (len(param_shape)
                                        - len(tuple(param_spec)))
    if leaf_shape == param_shape:
        return ps
    if len(param_shape) >= 2:
        stack, d_in, d_out = param_shape[:-2], param_shape[-2], \
            param_shape[-1]
        s_stack, s_in, s_out = ps[:-2], ps[-2], ps[-1]
        if leaf_shape == stack + (d_in,):           # a_mean / v_in
            return (*s_stack, s_in)
        if leaf_shape == stack + (d_out,):          # b_mean / v_out
            return (*s_stack, s_out)
        if leaf_shape == stack + (d_in, d_in):      # a_outer / m_in / p_in
            return (*s_stack, s_in, None)
        if leaf_shape == stack + (d_out, d_out):    # b_outer / m_out / p_out
            return (*s_stack, s_out, None)
        if leaf_shape == stack:                     # count
            return tuple(s_stack)
    return ()


def opt_state_shardings(opt_state_shapes: Any, param_specs: Any,
                        mesh) -> Any:
    """Spec tree for the optimizer state (same structure; non-tensor
    leaves unchanged).

    Each tensor leaf is matched to a parameter by the longest '/'-joined
    suffix of its key path that names a parameter (momentum subtrees end in
    the param path; KV-stat dicts key by the full weight path), then
    sharded by shape mirroring.  Unmatched leaves (step counters, M-FAC
    buffers) replicate.
    """
    flat_specs = M.flatten_specs(param_specs)
    spec_by_path = {p: (resolve_pspec(tuple(s.shape), s.logical_axes, mesh),
                        tuple(s.shape))
                    for p, s in flat_specs.items()}

    def one(parts, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        candidates = ['/'.join(parts[i:]) for i in range(len(parts))]
        candidates += [p for p in parts if '/' in p]
        best = None
        for cand in sorted(set(candidates), key=len, reverse=True):
            if cand in spec_by_path:
                best = cand
                break
        if best is None:
            return ()
        pspec, pshape = spec_by_path[best]
        return mirror_pspec(pspec, pshape, tuple(leaf.shape))

    return _tree_map_with_parts(one, opt_state_shapes)
