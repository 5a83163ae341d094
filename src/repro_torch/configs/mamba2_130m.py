"""mamba2-130m [ssm]: 24L d_model=768, attn-free, vocab=50280, state=128.
Source: SSD / Mamba-2 [arXiv:2405.21060]."""
from . import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2,
)
