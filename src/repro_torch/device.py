"""Device resolution for the port's entry points.

The entry points run on the card unless the caller asks for the CPU: the
default device is ``'cuda'``, and asking for it without a card raises rather
than quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
