"""Launch counts of the port's CUDA kernels.

Each wrapper adds one to its kernel's count where it launches the kernel on
a CUDA tensor, and nowhere else: the plain PyTorch path counts nothing.  A
kernel's stacked and unstacked wrappers count under one key (``matvec_cols``
counts both ``matvec_cols`` and ``matvec_cols_stacked``).  A run sets the
counts to 0, drives a path and reads them, to show that the path really went
through the kernels (``chip_smoke.py``).
"""
from __future__ import annotations

COUNTS: dict[str, int] = {'bilinear': 0, 'rank1_update': 0, 'eva_fused': 0,
                          'matvec': 0, 'eva_f_fused': 0, 'matvec_cols': 0}


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def snapshot() -> dict[str, int]:
    return dict(COUNTS)
