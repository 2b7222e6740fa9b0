"""whisper-tiny [audio]: enc-dec, conv frontend stubbed (frame embeddings).
4L enc + 4L dec, d_model=384, 6H (kv=6), d_ff=1536, vocab=51865.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='whisper-tiny', family='encdec',
    n_layers=4, n_enc_layers=4, n_dec_layers=4,
    d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    qkv_bias=True, norm='layer', dec_ratio=4,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='dots', attn_impl='flash',
    source='arXiv:2212.04356; unverified',
)

REDUCED = CONFIG.replace(
    n_layers=2, n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none', attn_impl='naive')
