"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528,
vocab=256000, no biases.  [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='command-r-35b', family='dense',
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
    vocab=256000,
    rope_theta=8e6,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='dots', attn_impl='flash', microbatches=4,
    source='hf:CohereForAI/c4ai-command-r-v01; unverified',
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=512,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none', attn_impl='naive')
