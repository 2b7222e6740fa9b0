"""Leaf codecs for the cross-worker exchanges — PyTorch port of
``repro/comm/codec.py``.

A :class:`Codec` is an encode/decode pair over one tensor that the exchange
primitives (``comm/exchange.py``) apply leaf by leaf:

* ``f32`` (alias ``identity``): the value itself on the wire; reductions
  stay plain f32 sums, so the atol=0 contracts hold;
* ``bf16``: bfloat16 on the wire, sums in f32; carries the truncation
  residual as error feedback on the gradient all-reduce;
* ``int8``: symmetric max-scale quantization with the scale
  ``max(amax / 127, SCALE_FLOOR)``, summed exactly in int32, with a
  carried error-feedback residual and a saturation count (elements whose
  rounded magnitude exceeds 127 before the clip: zero whenever the scale
  comes from the true global max).

``torch.round`` rounds half to even, as ``jnp.round`` does, and the clip
follows the round, as in the reference, so the same inputs give the same
bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.transform import tree_map

# The int8 scale clamp: keeps an all-zero tensor from dividing by zero; it
# only ever raises the scale above |x|max / 127, so it never saturates.
SCALE_FLOOR = 1e-12


@dataclasses.dataclass(frozen=True)
class Codec:
    """A leaf-wise wire format.

    name: 'f32' | 'bf16' | 'int8'.  wire_bits: logical payload bits per
    element (the byte accounting of ``comm/metrics.py`` follows from it).
    error_feedback: the gradient all-reduce carries the residual between
    calls.  passthrough: the payload is the value.  sum_dtype: the dtype
    the payload is summed in (int8: int32, exact); None sums the decoded
    f32 values.
    """

    name: str
    wire_bits: int
    error_feedback: bool = False
    passthrough: bool = False
    sum_dtype: Optional[torch.dtype] = None

    @property
    def has_scale(self) -> bool:
        return self.name == 'int8'

    def encode(self, x: torch.Tensor, amax: Optional[torch.Tensor]
               ) -> tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        """``x`` (f32, residual folded in) -> ``(payload, scale, n_sat)``.

        ``amax`` is max|x| over the scope the scale is shared across (the
        global max for an all-reduce, each stack row's for the owned-slice
        gather); ``n_sat`` is a 0-d f32 count."""
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.name == 'f32':
            return x, None, zero
        if self.name == 'bf16':
            return x.to(torch.bfloat16), None, zero
        scale = torch.clamp(amax / 127.0, min=SCALE_FLOOR)
        r = torch.round(x / scale)
        n_sat = (r.abs() > 127.0).sum().to(torch.float32)
        q = torch.clamp(r, -127, 127).to(torch.int8)
        return q, scale, n_sat

    def decode(self, payload: torch.Tensor,
               scale: Optional[torch.Tensor]) -> torch.Tensor:
        """Wire payload (or its exact integer sum) back to f32."""
        if self.name == 'int8':
            return payload.to(torch.float32) * scale
        return payload.to(torch.float32)

    def init_err(self, tree: Any) -> Optional[Any]:
        """Zero residual tree for error-feedback codecs, else None."""
        if not self.error_feedback:
            return None
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), tree)


F32 = Codec(name='f32', wire_bits=32, passthrough=True)
BF16 = Codec(name='bf16', wire_bits=16, error_feedback=True)
INT8_EF = Codec(name='int8', wire_bits=8, error_feedback=True,
                sum_dtype=torch.int32)

CODECS: dict[str, Codec] = {c.name: c for c in (F32, BF16, INT8_EF)}
CODECS['identity'] = F32


def get_codec(spec: Any) -> Codec:
    """A codec from its name or itself; None means pass-through f32."""
    if spec is None:
        return F32
    if isinstance(spec, Codec):
        return spec
    if spec not in CODECS:
        raise KeyError(f'unknown codec {spec!r}; have {sorted(CODECS)}')
    return CODECS[spec]
