"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480,
vocab=64000.  Backbone only; the anyres vision tower is a STUB —
input_specs provides precomputed patch embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='llava-next-34b', family='vlm',
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, input_is_embeds=True,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='dots', attn_impl='flash', microbatches=4,
    source='hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified',
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=512,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none', attn_impl='naive')
