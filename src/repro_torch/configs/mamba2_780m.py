"""mamba2-780m [ssm]: 48L d_model=1536, attention-free, SSD state=128.
Sub-quadratic -> runs long_500k.  [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='mamba2-780m', family='ssm',
    n_layers=48, d_model=1536, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True, sub_quadratic=True,
    param_dtype='bfloat16', compute_dtype='bfloat16', cache_dtype='bfloat16',
    remat='dots',
    source='arXiv:2405.21060; unverified',
)

REDUCED = CONFIG.replace(
    n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_headdim=16,
    ssm_chunk=8,
    param_dtype='float32', compute_dtype='float32', cache_dtype='float32',
    remat='none')
