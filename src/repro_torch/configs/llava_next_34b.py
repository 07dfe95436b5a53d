"""LLaVA-NeXT 34B backbone — anyres tiling frontend STUBBED: input_specs
provides precomputed patch embeddings [hf:llava-hf, per assignment]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, act="swiglu", tie_embeddings=False,
    rope_theta=5000000.0, n_patches=576,
))
