"""Whisper small backbone — enc-dec; conv frontend STUBBED: input_specs
provides precomputed frame embeddings [arXiv:2212.04356]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865, act="gelu_mlp", tie_embeddings=True,
    n_encoder_layers=12, encoder_seq=1500,
))
