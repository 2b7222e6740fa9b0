"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert d_ff=2048,
vocab=163840, MoE 384 experts top-8, 1 shared expert (DeepSeek-V3-family).
Trillion-parameter MoE.  [arXiv:2501.kimi2; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='kimi-k2-1t-a32b', family='moe',
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=112,
    n_experts=384, top_k=8, n_shared_experts=1, norm_topk=True,
    capacity_factor=1.0,
    rope_theta=5e4,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='full', attn_impl='flash', microbatches=4,
    source='arXiv:2501.kimi2; unverified',
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, head_dim=16,
    vocab=512, n_experts=8, top_k=2, n_shared_experts=1,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none', attn_impl='naive')
