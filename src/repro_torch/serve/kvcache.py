"""KV cache for cached decode (the port of ``repro/serve/kvcache.py``) for
the dense family: ``k``/``v`` ``[L, B, T, Hkv, D]`` in the compute dtype.
The int8 cache and the SSM / cross-attention caches are not ported yet."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models.layers import dtype_of


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Allocate the zeroed cache on ``device`` (default: the card)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} has no ported cache; only dense")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache is not ported")
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dt = dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}
