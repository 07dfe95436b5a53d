"""Gemma-2 2B — local+global alternating attention, logit softcap
[arXiv:2408.00118]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000, act="geglu", tie_embeddings=True,
    logit_softcap=30.0, attn_softcap=50.0,
    local_window=4096, layer_pattern="lg", rope_theta=10000.0,
))
