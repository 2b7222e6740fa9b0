"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696,
vocab=151552, RoPE.  [hf:THUDM/glm-4-9b; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='glm4-9b', family='dense',
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab=151552,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='dots', attn_impl='flash', microbatches=4,
    source='hf:THUDM/glm-4-9b; hf',
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=512,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none', attn_impl='naive')
