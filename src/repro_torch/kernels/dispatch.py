"""Kernel dispatch: per-(op, device, shape, dtype) impl and configuration.

Counterpart of ``repro/kernels/dispatch.py``, with three impls:

  * ``'cuda'``  — the hand-written Hopper kernels (``csrc/*.cu``), for CUDA
                  tensors only: given a tensor on any other device,
                  :func:`resolve` raises.
  * ``'torch'`` — the plain versions in ``ref.py``, on any device.  On a CUDA
                  tensor this path is taken only when the caller names it or
                  an installed cache entry does; a failed build or launch
                  raises, it never falls back here.
  * ``'auto'``  — an autotune-cache entry for (device type, op, shape,
                  dtype) wins if present; otherwise ``'cuda'`` for a CUDA
                  tensor and ``'torch'`` for a CPU one.

The default impl is a runtime setting (``set_default_impl`` /
``impl_override``): every wrapper takes ``impl=None``, which means the
process default.  Per-step requests thread through ``Extras.kernel`` (a
:class:`KernelConfig`, read by :func:`impl_from_extras`).

A ``'cuda'`` choice names one of the kernel's own launch-time
configurations (:func:`configurations`) by its ``(block_in, block_out)``:
``matvec``'s and ``eva_f_fused``'s launch 1 take 1 to 8 warps a block
(rows a round x columns a block), ``matvec_cols`` one of ``COLS_TILES``
(BM x BN outputs a block); ``bilinear``, ``rank1_update`` and ``eva_fused``
have one fixed partition each.  Without a cache entry each kernel keeps its
plan (``matvec.matvec_plan``, ``matvec.cols_plan``; ``matvec_cols``'s plan
depends on R as well, so its choice reads ``0x0`` there).  The choice
depends on (op, shape, dtype) and never on the stack depth L, so a stacked
call equals the per-item calls bit for bit under every configuration.
Composed Eva-f (``matvec`` + ``rank1_update``) equals fused Eva-f without
the fold bit for bit while ``matvec`` and ``eva_f_fused`` run the same
warps, as they do where the cache names neither (both take
``matvec_plan``'s).  A cache that names one and not the other gives them
different warps; ``csrc/matvec.cuh`` sums its chunks in chunk order
whatever the warps, so the bits still agree, which ``chip_smoke.py``
checks at every warps.

The shipped ``tile_defaults.json`` sits under every installed cache.  It
may name only ``'cuda'`` configurations (:func:`_shipped_defaults` raises
on any other entry), and it ships with no entry: the host-clock tuner
cannot tell the configurations apart, so by default each kernel runs its
plan, the configuration ``chip_smoke.py`` times.  Resolutions are memoized
per (op, shape, dtype, device type, requested impl); the memo is dropped
when the cache or the default changes.
Every resolution is recorded for :func:`choices_snapshot`, the step
record's ``kernel_tiles``.  Launch counts live in ``launches.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

import torch

from repro_torch.kernels import bilinear as _bil
from repro_torch.kernels import fused as _fused
from repro_torch.kernels import matvec as _mv
from repro_torch.kernels import rank1_update as _r1
from repro_torch.kernels import ref

IMPLS = ('auto', 'cuda', 'torch')
KERNEL_OPS = ('bilinear', 'matvec', 'matvec_cols', 'rank1_update',
              'eva_fused', 'eva_f_fused')
_DEFAULTS_FILE = Path(__file__).with_name('tile_defaults.json')
_MV_ROUND_ROWS = _mv.MV_SUB * _mv.MV_ROWS       # rows a warp takes a round


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """The launcher/trainer-level kernel knobs, threaded via ``Extras``.

    ``impl`` overrides the process default for every dispatch inside the
    step; ``autotune_cache`` is a JSON cache path the trainer installs
    (``install_cache``); ``autotune`` marks that the launcher ran the tuner
    for this run.  Nothing in the port reads ``autotune``: it is kept as
    the reference's field, a record of how the config was made.
    """
    impl: str = 'auto'
    autotune_cache: Optional[str] = None
    autotune: bool = False


@dataclasses.dataclass(frozen=True)
class Choice:
    """One resolved dispatch decision: 'cuda' or 'torch', and the
    configuration's (block_in, block_out); (0, 0) for 'torch', and for
    'cuda' where the kernel's launch-time plan picks."""
    impl: str
    block_in: int
    block_out: int


_state: dict[str, Any] = {'impl': 'auto', 'cache': None}
_choices: dict[str, str] = {}
# (op, d_in, d_out, dtype, device type, requested impl) -> (Choice, label)
_memo: dict[tuple, tuple[Choice, str]] = {}


def backend() -> str:
    """The device type a tensor of the default entry points lies on."""
    return 'cuda' if torch.cuda.is_available() else 'cpu'


def default_impl() -> str:
    return _state['impl']


def set_default_impl(impl: str) -> None:
    """Set the process-wide default impl at runtime (no reload needed)."""
    _check_impl(impl)
    _state['impl'] = impl
    _memo.clear()


@contextlib.contextmanager
def impl_override(impl: str):
    """Temporarily force an impl; the previous default comes back on exit,
    an exception included."""
    _check_impl(impl)
    prev = _state['impl']
    _state['impl'] = impl
    _memo.clear()
    try:
        yield
    finally:
        _state['impl'] = prev
        _memo.clear()


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f'unknown kernel impl {impl!r}; have {IMPLS}')


def impl_from_extras(extras, default: Optional[str] = None) -> Optional[str]:
    """The per-step impl request threaded through ``Extras.kernel``.

    A present ``KernelConfig`` wins over the preconditioner's own default,
    ``'auto'`` included, which engages the cache.  No config -> ``default``
    (None: the process default)."""
    cfg = getattr(extras, 'kernel', None) if extras is not None else None
    if cfg is not None:
        return cfg.impl
    return default


# ---------------------------------------------------------------------------
# Autotune-cache plumbing


def _dtype_name(dtype) -> str:
    """numpy's name of a dtype: 'float32', 'bfloat16'."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).removeprefix('torch.')


def cache_key(op: str, d_in: int, d_out: int, dtype,
              backend_name: Optional[str] = None) -> str:
    """'{backend}/{op}/{dtype}/{d_in}x{d_out}', the reference's key."""
    return (f'{backend_name or backend()}/{op}/{_dtype_name(dtype)}/'
            f'{d_in}x{d_out}')


def _shipped_defaults() -> dict:
    """The entries of ``tile_defaults.json``.  Each must name 'cuda': a
    shipped 'torch' would send every default call on the card to the plain
    version, which only a cache the user installs may do (ValueError)."""
    if not _DEFAULTS_FILE.exists():
        return {}
    entries = dict(json.loads(_DEFAULTS_FILE.read_text()).get('entries', {}))
    for key, entry in entries.items():
        if entry.get('impl') != 'cuda':
            raise ValueError(f'{_DEFAULTS_FILE.name}: entry {key} names '
                             f"{entry.get('impl')!r}; the shipped defaults "
                             "may name only 'cuda'")
    return entries


def _cache() -> dict:
    if _state['cache'] is None:
        _state['cache'] = _shipped_defaults()
    return _state['cache']


def install_cache(cache) -> int:
    """Install autotune winners on top of the shipped defaults.

    ``cache`` is a path to an ``autotune.py`` JSON file or an already-loaded
    ``{'entries': {...}}``/plain-entries mapping.  Returns the entry count.
    Each entry names 'cuda' or 'torch'; its blocks are checked against the
    kernel's configurations when a call resolves it.
    """
    if isinstance(cache, (str, Path)):
        cache = json.loads(Path(cache).read_text())
    entries = cache.get('entries', cache) if isinstance(cache, dict) else {}
    for key, entry in entries.items():
        if entry.get('impl') not in ('cuda', 'torch'):
            raise ValueError(f'cache entry {key}: impl {entry.get("impl")!r}'
                             " is not 'cuda' or 'torch'")
    base = _shipped_defaults()
    base.update(entries)
    _state['cache'] = base
    _memo.clear()
    _choices.clear()
    return len(base)


def reset_cache() -> None:
    """Back to the shipped defaults; the recorded choices go too."""
    _state['cache'] = None
    _memo.clear()
    _choices.clear()


# ---------------------------------------------------------------------------
# Configurations and resolution


def configurations(op: str, d_in: int, d_out: int
                   ) -> tuple[tuple[int, int], ...]:
    """The (block_in, block_out) of each launch-time configuration of the
    op's kernel at (d_in, d_out), in the tuner's order.  ``matvec`` and
    ``eva_f_fused``: w warps a block take w·MV_SUB·MV_ROWS rows a round of an
    MV_COLS-column strip, w = 1..MV_WARPS; ``matvec_cols``: each
    ``COLS_TILES`` entry's BM x BN outputs; ``bilinear`` and ``eva_fused``:
    blocks of whole rows (``fused.eva_fused_plan``); ``rank1_update``:
    R1_THREADS vectors of the flattened item a block."""
    if op in ('matvec', 'eva_f_fused'):
        return tuple((w * _MV_ROUND_ROWS, _mv.MV_COLS)
                     for w in range(1, _mv.MV_WARPS + 1))
    if op == 'matvec_cols':
        return tuple(_mv.cols_tile(c, 1, 1)[1:3]
                     for c in range(len(_mv.COLS_TILES)))
    if op in ('bilinear', 'eva_fused'):
        return ((_fused.eva_fused_plan(d_in, d_out)[0], d_out),)
    if op == 'rank1_update':
        return ((1, _r1.R1_THREADS),)
    raise ValueError(f'unknown kernel op {op!r}; have {KERNEL_OPS}')


def _default_blocks(op: str, d_in: int, d_out: int) -> tuple[int, int]:
    """The configuration each kernel runs without a cache entry."""
    if op in ('matvec', 'eva_f_fused'):
        return (_mv.matvec_plan(d_in, d_out)[1] * _MV_ROUND_ROWS,
                _mv.MV_COLS)
    if op == 'matvec_cols':
        return (0, 0)               # cols_plan picks by R at the launch
    return configurations(op, d_in, d_out)[0]


def _resolve(op, d_in, d_out, dtype, req, dev) -> tuple[Choice, str]:
    _check_impl(req)
    entry = None
    if req == 'auto':
        entry = _cache().get(cache_key(op, d_in, d_out, dtype, dev))
        concrete = entry['impl'] if entry else \
            ('cuda' if dev == 'cuda' else 'torch')
    else:
        concrete = req
    if concrete == 'cuda' and dev != 'cuda':
        raise ValueError(f"kernel impl 'cuda' needs CUDA tensors, got one on "
                         f"{dev}; use 'auto' or 'torch'")
    if concrete == 'torch':
        blocks = (0, 0)
    elif entry is not None and ('block_in' in entry or 'block_out' in entry):
        blocks = (int(entry.get('block_in', 0)),
                  int(entry.get('block_out', 0)))
        have = configurations(op, d_in, d_out)
        if blocks not in have:
            raise ValueError(
                f'cache entry {cache_key(op, d_in, d_out, dtype, dev)}: '
                f'blocks {blocks[0]}x{blocks[1]} name no configuration of '
                f'{op} at {d_in}x{d_out}; have {list(have)}')
    else:
        blocks = _default_blocks(op, d_in, d_out)
    choice = Choice(concrete, *blocks)
    return choice, f'{concrete} {blocks[0]}x{blocks[1]} @ {d_in}x{d_out}'


def resolve(op: str, d_in: int, d_out: int, dtype,
            impl: Optional[str] = None, device='cuda') -> Choice:
    """Pick the impl and configuration for one op instance.

    Order: explicit ``impl`` > process default; ``'auto'`` takes the cache
    entry for (device type, op, shape, dtype), else ``'cuda'`` on a CUDA
    device and ``'torch'`` on any other.  ``device``: a torch.device or its
    string.  Raises ValueError for an unknown impl, ``'cuda'`` off the card,
    or a cache entry whose blocks name no configuration of the kernel.
    """
    dev = device if isinstance(device, str) else device.type
    return _lookup(op, d_in, d_out, dtype, impl, dev.split(':')[0])


def _lookup(op, d_in, d_out, dtype, impl, dev) -> Choice:
    req = impl or _state['impl']
    key = (op, d_in, d_out, dtype, dev, req)
    hit = _memo.get(key)
    if hit is None:
        hit = _memo[key] = _resolve(op, d_in, d_out, dtype, req, dev)
    _choices[op] = hit[1]
    return hit[0]


def _choose(op: str, g: torch.Tensor, impl: Optional[str]) -> Choice:
    """The choice for an operand g (..., d_in, d_out).  ``is_cuda`` and
    one read of the shape: the host-cheapest forms of the key's parts."""
    shape = g.shape
    return _lookup(op, shape[-2], shape[-1], g.dtype, impl,
                   'cuda' if g.is_cuda else g.device.type)


def choices_snapshot() -> dict[str, str]:
    """Latest resolved impl and configuration per op — the step record's
    ``kernel_tiles``: ``'cuda 768x16 @ 768x2048'``."""
    return dict(_choices)


def _warps(c: Choice) -> int:
    return c.block_in // _MV_ROUND_ROWS


_COLS_CONFIG = {_mv.cols_tile(c, 1, 1)[1:3]: c
                for c in range(len(_mv.COLS_TILES))}


# ---------------------------------------------------------------------------
# Op wrappers (the only call sites the rest of the port uses)


def matvec_and_norm(g, a, impl: Optional[str] = None):
    """(aᵀ G, ‖a‖²) for g (d_in, d_out): (d_out,) and () f32."""
    c = _choose('matvec', g, impl)
    if c.impl == 'torch':
        return ref.matvec_and_norm_ref(g, a)
    return _mv.matvec_and_norm(g, a, _warps(c))


def matvec_and_norm_stacked(g, a, impl: Optional[str] = None):
    """The same for a stack g (L, d_in, d_out): (L, d_out) and (L,) f32."""
    c = _choose('matvec', g, impl)
    if c.impl == 'torch':
        return ref.matvec_and_norm_ref(g, a)
    return _mv.matvec_and_norm_stacked(g, a, _warps(c))


def matvec_cols(g, a, impl: Optional[str] = None):
    """Band partial A G for a row band g (m, n) and a (R, m): (R, n) f32."""
    c = _choose('matvec_cols', g, impl)
    if c.impl == 'torch':
        return ref.matvec_cols_ref(g, a)
    return _mv.matvec_cols(g, a, _COLS_CONFIG.get((c.block_in, c.block_out)))


def matvec_cols_stacked(g, a, impl: Optional[str] = None):
    """The same for L bands g (L, m, n) and a (L, R, m): (L, R, n) f32."""
    c = _choose('matvec_cols', g, impl)
    if c.impl == 'torch':
        return ref.matvec_cols_ref(g, a)
    return _mv.matvec_cols_stacked(
        g, a, _COLS_CONFIG.get((c.block_in, c.block_out)))


def bilinear_and_norms(g, a, b, impl: Optional[str] = None):
    """(aᵀ G b, [‖a‖², ‖b‖²]) for g (d_in, d_out): () and (2,) f32."""
    if _choose('bilinear', g, impl).impl == 'torch':
        return ref.bilinear_and_norms_ref(g, a, b)
    return _bil.bilinear_and_norms(g, a, b)


def bilinear_and_norms_stacked(g, a, b, impl: Optional[str] = None):
    """The same for a stack g (L, d_in, d_out): (L,) and (L, 2) f32."""
    if _choose('bilinear', g, impl).impl == 'torch':
        return ref.bilinear_and_norms_ref(g, a, b)
    return _bil.bilinear_and_norms_stacked(g, a, b)


def _pair(coeff, scale):
    """(coeff, scale) from the two tensors, or from the (..., 2) pairs."""
    return (coeff[..., 0], coeff[..., 1]) if scale is None else (coeff, scale)


def rank1_update(g, a, b, coeff, scale=None, impl: Optional[str] = None):
    """coeff/scale: 0-d f32 tensors on g's device, handed to the kernel as
    they are; or coeff the (2,) [coeff, scale] pair and scale None."""
    if _choose('rank1_update', g, impl).impl == 'torch':
        return ref.rank1_update_ref(g, a, b, *_pair(coeff, scale))
    return _r1.rank1_update(g, a, b, coeff, scale)


def rank1_update_stacked(g, a, b, coeff, scale=None,
                         impl: Optional[str] = None):
    """coeff/scale: (L,) f32 tensors on g's device; or coeff the (L, 2)
    pairs and scale None."""
    if _choose('rank1_update', g, impl).impl == 'torch':
        return ref.rank1_update_ref(g, a, b, *_pair(coeff, scale))
    return _r1.rank1_update_stacked(g, a, b, coeff, scale)


def eva_fused_stacked(g, a, b, gamma: float, m, mu: float,
                      fold_momentum: bool = True,
                      impl: Optional[str] = None):
    """Fused Eva precondition + epilogue; ``(out, aux)`` as in ``fused.py``."""
    if _choose('eva_fused', g, impl).impl == 'torch':
        return ref.eva_fused_ref(g, a, b, gamma, m, mu, fold_momentum)
    return _fused.eva_fused_stacked(g, a, b, gamma, m, mu, fold_momentum)


def eva_f_fused_stacked(g, a, gamma: float, m, mu: float,
                        fold_momentum: bool = True,
                        impl: Optional[str] = None):
    """Fused Eva-f precondition + epilogue; ``(out, aux)`` as in
    ``fused.py``."""
    c = _choose('eva_f_fused', g, impl)
    if c.impl == 'torch':
        return ref.eva_f_fused_ref(g, a, gamma, m, mu, fold_momentum)
    return _fused.eva_f_fused_stacked(g, a, gamma, m, mu, fold_momentum,
                                      _warps(c))
