"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (MHA kv=32) d_ff=13440,
vocab=92416, QKV bias (qwen1.5 arch).  [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='codeqwen1.5-7b', family='dense',
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab=92416, qkv_bias=True,
    rope_theta=1e6,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='dots', attn_impl='flash', microbatches=4,
    source='hf:Qwen/CodeQwen1.5-7B; hf',
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none', attn_impl='naive')
