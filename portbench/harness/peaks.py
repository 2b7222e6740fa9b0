"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheets; dense rates, no sparsity; at the full power limit).  A device kind
is matched by the part its name starts with."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    # H100 SXM5: 989 TFLOP/s bf16 dense, 67 TFLOP/s float32 outside the
    # tensor cores, 3.35 TB/s of HBM3; rated at 700 W
    'NVIDIA H100 80GB HBM3': {'bf16_flops': 989e12, 'f32_flops': 67e12,
                              'hbm_bytes': 3.35e12, 'rated_w': 700.0},
}


def peaks_of(kind: Optional[str]) -> Optional[dict]:
    if not kind:
        return None
    for part, peaks in PEAKS.items():
        if kind.startswith(part):
            return peaks
    return None
