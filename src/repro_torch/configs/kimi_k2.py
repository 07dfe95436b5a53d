"""Kimi K2 — trillion-parameter MoE, 384 routed experts top-8
[arXiv:2501.kimi2 per assignment; GQA kv=8 per the assigned config]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=14336,            # dense (first) layer FFN
    vocab=163840, act="swiglu", tie_embeddings=False,
    n_experts=384, n_shared_experts=1, top_k=8, d_ff_expert=2048,
    n_dense_layers=1, moe_group_size=2048,
))
