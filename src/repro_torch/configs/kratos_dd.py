"""The paper's own workload config: a small unrolled-DNN-style LM whose
linear layers run through the Double-Duty bitplane path (repro_torch.quant)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="kratos-dd", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=2048, vocab=32000, act="swiglu", tie_embeddings=True,
))
