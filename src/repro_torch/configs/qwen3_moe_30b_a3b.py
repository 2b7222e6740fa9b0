"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768,
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='qwen3-moe-30b-a3b', family='moe',
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab=151936, head_dim=128,
    n_experts=128, top_k=8, norm_topk=True,
    rope_theta=1e6,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='dots', attn_impl='flash', microbatches=4,
    source='hf:Qwen/Qwen3-30B-A3B; hf',
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, head_dim=16,
    vocab=512, n_experts=8, top_k=2,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none', attn_impl='naive')
