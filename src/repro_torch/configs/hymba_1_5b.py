"""Hymba 1.5B — parallel attention + SSM heads per layer; SWA everywhere
except first/middle/last global layers [arXiv:2411.13676]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, act="swiglu", tie_embeddings=True,
    local_window=1024, ssm_state=16, ssm_heads=25, ssm_head_dim=64,
))
