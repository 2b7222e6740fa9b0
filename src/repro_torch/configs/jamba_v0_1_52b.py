"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
Mamba+attn 1:7 interleave (attention at layer i%8==4), MoE 16 experts top-2
every other layer.  Sub-quadratic -> runs long_500k.
Adaptation: mixer is our Mamba-2 SSD block (Jamba uses Mamba-1); d_state=16
per Jamba.  [arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='jamba-v0.1-52b', family='hybrid',
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536,
    n_experts=16, top_k=2, norm_topk=True,
    attn_period=8, attn_offset=4, expert_period=2, expert_offset=1,
    ssm_state=16, ssm_headdim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    sub_quadratic=True,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='dots', attn_impl='flash', microbatches=4,
    source='arXiv:2403.19887; hf',
)

REDUCED = CONFIG.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=512,
    n_experts=4, top_k=2, ssm_state=16, ssm_headdim=16, ssm_chunk=8,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none', attn_impl='naive')
