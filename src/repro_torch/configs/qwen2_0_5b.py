"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864,
vocab=151936, QKV bias, tied embeddings.  [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='qwen2-0.5b', family='dense',
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='dots', attn_impl='flash',
    source='arXiv:2407.10671; hf',
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_ff=128, vocab=512,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none', attn_impl='naive')
