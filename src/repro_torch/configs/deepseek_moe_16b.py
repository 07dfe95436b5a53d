"""DeepSeekMoE 16B — 2 shared + 64 routed top-6, fine-grained experts,
first layer dense [arXiv:2401.06066]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944,            # dense (first) layer FFN
    vocab=102400, act="swiglu", tie_embeddings=False,
    n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
    n_dense_layers=1,
))
