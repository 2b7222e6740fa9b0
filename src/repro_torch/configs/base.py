"""Architecture and shape configuration — PyTorch port of
``repro/configs/base.py``.

``ArchConfig`` carries every field of the reference, so a config moves
between the two packages field for field; ``pdtype`` and ``cdtype`` are
torch dtypes.  ``ShapeCell`` and ``SHAPES`` are the four assigned input
shapes; ``cells_for`` pairs each with its skip reason.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def torch_dtype(name: str) -> torch.dtype:
    """'float32', 'bfloat16', ... -> the torch dtype of that name."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f'{name!r} is not a torch dtype')
    return dtype


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0                 # 0 for attention-free
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: Optional[int] = None   # default d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    moe_aux_coef: float = 1e-3

    # SSM
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (jamba): layer i is attention iff i % attn_period == attn_offset,
    # MoE iff i % expert_period == expert_offset
    attn_period: int = 0
    attn_offset: int = 0
    expert_period: int = 0
    expert_offset: int = 0

    # enc-dec (whisper)
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    dec_ratio: int = 4               # dec_len = seq_len // dec_ratio

    # flags
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = 'rms'                # rms | layer
    rope_theta: float = 10000.0
    input_is_embeds: bool = False    # vlm / audio stub frontends
    sub_quadratic: bool = False      # eligible for long_500k

    # numerics / impl
    param_dtype: str = 'float32'
    compute_dtype: str = 'float32'
    cache_dtype: str = 'float32'
    attn_impl: str = 'naive'         # naive | chunked | flash
    q_chunk: int = 512
    k_chunk: int = 1024
    remat: str = 'none'              # none | full | dots
    scan_unroll: int = 1             # the reference's lax.scan unroll
    microbatches: int = 1            # grad-accumulation splits of train_4k

    source: str = ''                 # provenance note

    def __post_init__(self):
        if self.n_heads and self.head_dim is None:
            object.__setattr__(self, 'head_dim', self.d_model // self.n_heads)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def replace(self, **kw) -> 'ArchConfig':
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = (
    ShapeCell('train_4k', 4096, 256, 'train'),
    ShapeCell('prefill_32k', 32768, 32, 'prefill'),
    ShapeCell('decode_32k', 32768, 128, 'decode'),
    ShapeCell('long_500k', 524288, 1, 'decode'),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}


def cell_skip_reason(arch: ArchConfig, shape: ShapeCell) -> Optional[str]:
    """The skips the assignment sets; None = run the cell."""
    if shape.name == 'long_500k' and not arch.sub_quadratic:
        return ('full-attention arch: 524k context needs sub-quadratic '
                'attention (run only for SSM/hybrid per spec)')
    return None


def cells_for(arch: ArchConfig):
    """(shape, skip reason or None) for each of the four shapes."""
    for shape in SHAPES:
        yield shape, cell_skip_reason(arch, shape)
