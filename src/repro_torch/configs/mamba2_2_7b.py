"""Mamba-2 2.7B — SSD, attention-free [arXiv:2405.21060].
d_inner = 2*d_model = 5120, P=64 -> 80 SSD heads, state N=128."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=50280, tie_embeddings=True,
    ssm_state=128, ssm_heads=80, ssm_head_dim=64, conv_kernel=4,
))
