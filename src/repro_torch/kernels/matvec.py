"""Vector-matrix products: wrappers of ``csrc/matvec.cu`` and
``csrc/matvec_cols.cu``.

Counterpart of ``repro/kernels/matvec.py``.  ``matvec_and_norm_stacked``
(``::matvec``, ``::matvec_stacked``) takes g (L, d_in, d_out) f32|bf16 and
a (L, d_in) f32 and returns u (L, d_out) f32 and ‖a‖² (L,) f32, both summed
on the card in a fixed order, from one launch.  ``matvec_cols_stacked``
(``::matvec_cols``, ``::matvec_cols_stacked``) takes a row band g (L, m, n)
f32|bf16 of L symmetric factors and a (L, R, m) f32 and returns the band
partials A·G (L, R, n) f32 of the factor-sharded solve.  The unstacked forms
run one matrix as a stack of one.  The wrappers take CUDA tensors only and
raise on any other (``dispatch.py`` routes CPU tensors to the plain versions
in ``ref.py``); they go through the lean launch path of ``launch.py``.
Nothing synchronises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, launch, launches, ref

_SIGNATURES = {
    'repro_matvec': [build.P, build.I32, build.P, build.P, build.P,
                     build.I64, build.I64, build.I64, build.I32, build.P],
}
_COLS_SIGNATURES = {
    'repro_matvec_cols': [build.I32, build.I32, build.P, build.I32, build.P,
                          build.P, build.I64, build.I64, build.I64, build.I64,
                          build.I32, build.I32, build.I64, build.I64, build.P],
}
_F32_BYTES = 4

# The partition of csrc/matvec.cuh: kMvCols columns a block, kMvRows rows a
# chunk, kMvSub chunks a warp, at most kMvWarps warps a block
MV_COLS, MV_ROWS, MV_SUB, MV_WARPS = 16, 16, 8, 8


def matvec_plan(d_in: int, d_out: int) -> tuple[int, int]:
    """(blocks, warps) per stack item of ``csrc/matvec.cuh``'s kernel (the
    matvec op, and launch 1 of ``eva_f_fused``): one block per strip of
    MV_COLS columns, with a warp for every MV_SUB chunks of MV_ROWS rows, up
    to MV_WARPS (more chunks take more rounds).  Depends on (d_in, d_out)
    alone.  This is the default; the dispatch cache may name any warps from
    1 to MV_WARPS (``dispatch.configurations``)."""
    chunks = -(-d_in // MV_ROWS)
    return -(-d_out // MV_COLS), min(MV_WARPS, -(-chunks // MV_SUB))


def check_warps(warps: int) -> int:
    """``warps`` if the kernel takes it (1 to MV_WARPS), else ValueError.
    The sums of ``csrc/matvec.cuh`` run in chunk order whatever the warps:
    the warps set how many chunks a round loads, not the order they add."""
    if not 1 <= warps <= MV_WARPS:
        raise ValueError(f'warps {warps} outside [1, {MV_WARPS}]')
    return warps


def _launch(g, a, L: int, d_in: int, d_out: int, lead, index: int,
            warps: int | None):
    """Launch ``csrc/matvec.cu`` into one flat f32 tensor of L·d_out + L
    values, u (L, d_out) then ‖a‖² (L,), and return the two as contiguous
    views ((L, d_out) and (L,), or (d_out,) and () unstacked), since
    rank1_update takes u as its b operand.  ``as_strided`` is the view that
    costs the host least."""
    launch.check_f32(a, lead + (d_in,), index)
    if d_in * d_out >= 2 ** 31:
        raise ValueError(f'{d_in}x{d_out} item exceeds 32-bit indexing')
    n = L * d_out
    out = torch.empty(n + L, dtype=torch.float32, device=g.device)
    u = out.data_ptr()
    launch.call(launch.entry('matvec', 'repro_matvec', _SIGNATURES), index,
                launch.stream(index), 'matvec launch', g.data_ptr(),
                g.dtype is torch.bfloat16, a.data_ptr(), u,
                u + _F32_BYTES * n, L, d_in, d_out,
                matvec_plan(d_in, d_out)[1] if warps is None
                else check_warps(warps))
    launches.COUNTS['matvec'] += 1
    if lead:
        return out.as_strided((L, d_out), (d_out, 1)), \
            out.as_strided((L,), (1,), n)
    return out.as_strided((d_out,), (1,)), out.as_strided((), (), n)


def matvec_and_norm_stacked(g: torch.Tensor, a: torch.Tensor,
                            warps: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked u_l = a_lᵀ G_l -> (L, d_out) f32, and ‖a_l‖² -> (L,) f32,
    from one launch of blocks of ``warps`` warps (None: ``matvec_plan``).
    The norm feeds Eq. 21's denominator; summed in a fixed order, it is the
    same for an item alone or in a stack, as u is."""
    if launch.is_fake_cuda(g):
        return launch.fake_call('matvec', ref.matvec_and_norm_ref, g, a)
    index = launch.check_g(g, 3)
    L, d_in, d_out = g.shape
    if L < 1 or L > 65535:
        raise ValueError(f'stack size L={L} outside [1, 65535]')
    return _launch(g, a, L, d_in, d_out, (L,), index, warps)


def matvec_and_norm(g: torch.Tensor, a: torch.Tensor,
                    warps: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unstacked form: g (d_in, d_out) -> u (d_out,) f32, asq () f32."""
    if launch.is_fake_cuda(g):
        return launch.fake_call('matvec', ref.matvec_and_norm_ref, g, a)
    index = launch.check_g(g, 2)
    d_in, d_out = g.shape
    return _launch(g, a, 1, d_in, d_out, (), index, warps)


# Tile shapes of csrc/matvec_cols.cu, by its config index: (TM, TN, TY, TX)
# is a TM x TN register tile per thread on a TY x TX grid of threads, so a
# block owns BM = TM * TY rows of R by BN = TN * TX columns of n.
COLS_TILES = ((8, 4, 8, 16), (7, 4, 8, 28))
H100_SMS = 132


def cols_tile(cfg: int, R: int, n: int) -> tuple[int, int, int, int, int]:
    """(config, BM, BN, grid_x, grid_y) of ``COLS_TILES[cfg]`` for U (R, n);
    ValueError for a config the kernel does not have."""
    if not 0 <= cfg < len(COLS_TILES):
        raise ValueError(f'matvec_cols config {cfg} outside '
                         f'[0, {len(COLS_TILES)})')
    tm, tn, ty, tx = COLS_TILES[cfg]
    bm, bn = tm * ty, tn * tx
    return cfg, bm, bn, -(-n // bn), -(-R // bm)


def cols_plan(R: int, n: int, sms: int = H100_SMS
              ) -> tuple[int, int, int, int, int]:
    """(config, BM, BN, grid_x, grid_y) for U (R, n): the tile whose blocks
    leave the busiest SM the fewest outputs, ceil(tiles / sms) * BM * BN;
    on a tie the earlier config.  Depends on (R, n) and the SM count alone,
    never on L or the band depth m (which every block walks whole).  This
    is the default; the dispatch cache may name either config."""
    best = None
    for cfg in range(len(COLS_TILES)):
        tile = cols_tile(cfg, R, n)
        _, bm, bn, gx, gy = tile
        cost = -(-(gx * gy) // sms) * bm * bn
        if best is None or cost < best[0]:
            best = (cost, tile)
    return best[1]


_SMS: dict[int, int] = {}   # SM count per device index


def _sm_count(index: int) -> int:
    count = _SMS.get(index)
    if count is None:
        count = _SMS[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return count


def matvec_cols_stacked(g: torch.Tensor, a: torch.Tensor,
                        config: int | None = None) -> torch.Tensor:
    """Stacked band partials U_l = A_l G_l: g (L, m, n) f32|bf16, a (L, R, m)
    f32 -> (L, R, n) f32, from one launch of tile ``COLS_TILES[config]``
    (None: ``cols_plan``).  Each output is one f32 multiply-add chain over
    the band rows in order, so an item gives the same bits alone or in a
    stack, and under either tile."""
    if launch.is_fake_cuda(g):
        return launch.fake_call('matvec_cols', ref.matvec_cols_ref, g, a)
    index = launch.check_g(g, 3)
    L, m, n = g.shape
    if L < 1 or L > 65535:
        raise ValueError(f'stack size L={L} outside [1, 65535]')
    if a.dim() != 3 or a.shape[1] < 1:
        raise ValueError(f'a must be (L, R, m) with R >= 1, got '
                         f'{tuple(a.shape)}')
    R = a.shape[1]
    launch.check_f32(a, (L, R, m), index)
    if max(R, m) * n >= 2 ** 31 or R * m >= 2 ** 31:
        raise ValueError(f'{R}x{m}x{n} exceeds 32-bit indexing')
    cfg, _, _, gx, gy = cols_plan(R, n, _sm_count(index)) if config is None \
        else cols_tile(config, R, n)
    g_ptr, a_ptr = g.data_ptr(), a.data_ptr()
    a_vec = m % 4 == 0 and a_ptr % 16 == 0
    g_vec = n % 4 == 0 and g_ptr % 16 == 0
    bf16 = g.dtype is torch.bfloat16
    u = torch.empty((L, R, n), dtype=torch.float32, device=g.device)
    # the copy engine (TMA) fills the stages where every row is aligned f32
    launch.call(launch.entry('matvec_cols', 'repro_matvec_cols',
                             _COLS_SIGNATURES), index, launch.stream(index),
                'matvec_cols launch', cfg, a_vec and g_vec and not bf16,
                g_ptr, bf16, a_ptr, u.data_ptr(), L, R, m, n, a_vec, g_vec,
                gx, gy)
    launches.COUNTS['matvec_cols'] += 1
    return u


def matvec_cols(g, a, config: int | None = None):
    """Unstacked form: g (m, n), a (R, m) -> (R, n) f32."""
    return matvec_cols_stacked(g.unsqueeze(0), a.unsqueeze(0),
                               config).select(0, 0)
