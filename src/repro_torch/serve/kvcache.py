"""Decode caches (the port of ``repro/serve/kvcache.py``) for the dense,
ssm and hybrid families: ``k``/``v`` ``[L, B, T, Hkv, D]`` in the compute
dtype (dense, hybrid); the SSD's ``conv`` ``[L, B, Kc-1, H*P]`` in the
compute dtype and ``ssm`` ``[L, B, H, P, N]`` in float32 (ssm, hybrid).
The int8 cache and the cross-attention cache are not ported yet."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models.layers import dtype_of
from ..models.lm import require_ported


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Allocate the zeroed cache on ``device`` (default: the card)."""
    require_ported(cfg)
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache is not ported")
    dev = resolve_device(device)
    dt = dtype_of(cfg.compute_dtype)
    L = cfg.n_layers
    cache = {}
    if cfg.family in ("dense", "hybrid"):
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    if cfg.family in ("ssm", "hybrid"):
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        cache["conv"] = torch.zeros((L, batch, cfg.conv_kernel - 1, H * P),
                                    dtype=dt, device=dev)
        cache["ssm"] = torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                                   device=dev)
    return cache
