"""Decode caches (the port of ``repro/serve/kvcache.py``), with a leading
axis over every decoder layer (a MoE model's dense layers first):

* ``k``/``v`` ``[L, B, T, Hkv, D]`` (dense, moe, vlm, encdec, hybrid) in
  the compute dtype, or int8 with float32 per-(token, head) scales
  ``k_scale``/``v_scale`` ``[L, B, T, Hkv]`` when
  ``kv_cache_dtype == "int8"``;
* the SSD's ``conv`` ``[L, B, Kc-1, H*P]`` in the compute dtype and
  ``ssm`` ``[L, B, H, P, N]`` in float32 (ssm, hybrid);
* the encoder's cross-attention keys and values ``xk``/``xv``
  ``[L, B, Te, Hkv, D]`` in the compute dtype (encdec).

On a mesh (``mesh=``, a ``DeviceMesh``) every leaf is a DTensor placed
by :func:`repro_torch.parallel.sharding.cache_specs`: kv heads over
``model``, the batch over the data axes, the time axis over whichever of
them is left (a batch of 1 at long context), each rank allocating only
its own shard.  The blocks write each step's rows into the rank that
owns them (:func:`repro_torch.models.blocks._write_rows`).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models.layers import dtype_of


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               encoder_len: int | None = None, device=None,
               mesh=None) -> dict:
    """Allocate the zeroed cache on ``device`` (default: the card), or
    with ``mesh`` each rank's shard of it there.  ``encoder_len`` is the
    encoder's length (default ``encoder_seq``)."""
    dev = resolve_device(device)
    if mesh is not None:
        from ..parallel.sharding import allocate, cache_specs

        shapes = init_cache(cfg, batch, max_len, encoder_len, "meta")
        return allocate(shapes, cache_specs(cfg, mesh, shapes), mesh, dev)
    dt = dtype_of(cfg.compute_dtype)
    int8 = cfg.kv_cache_dtype == "int8"
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    fam = cfg.family
    cache = {}
    if fam in ("dense", "moe", "vlm", "encdec", "hybrid"):
        shape = (L, batch, max_len, Hkv, D)
        kdt = torch.int8 if int8 else dt
        cache["k"] = torch.zeros(shape, dtype=kdt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=kdt, device=dev)
        if int8:
            cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev)
            cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                           device=dev)
    if fam in ("ssm", "hybrid"):
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        cache["conv"] = torch.zeros((L, batch, cfg.conv_kernel - 1, H * P),
                                    dtype=dt, device=dev)
        cache["ssm"] = torch.zeros((L, batch, H, P, N), dtype=torch.float32,
                                   device=dev)
    if fam == "encdec":
        Te = encoder_len or cfg.encoder_seq
        cache["xk"] = torch.zeros((L, batch, Te, Hkv, D), dtype=dt,
                                  device=dev)
        cache["xv"] = torch.zeros((L, batch, Te, Hkv, D), dtype=dt,
                                  device=dev)
    return cache
