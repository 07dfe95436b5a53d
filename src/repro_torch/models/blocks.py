"""Per-layer bodies for the dense family: attention and FFN (the port of
``repro/models/blocks.py``'s ``attn_block`` and ``ffn_block``).

Blocks operate on one layer's parameter slice (no leading L axis).  A
cache is a dict of one layer's ``k``/``v`` ``[B, T, Hkv, D]`` tensors,
updated in place.  MoE, SSD, hybrid blocks and the int8 KV cache are not
ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import attention, glu_ffn, rms_norm, rope

HUGE_WINDOW = 1 << 30


def attn_block(cfg: ModelConfig, p, x, positions, window=None, cache=None,
               cache_index=None, causal=True, use_kernel: bool = True):
    """x: ``[B, S, d]``.  With ``cache`` (dict k/v ``[B, T, Hkv, D]``)
    writes the new k/v at ``cache_index`` (an int; ``positions`` must be
    ``cache_index + arange(S)``) and attends over the filled prefix.
    Returns (out, cache)."""
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, Hq, D)
    k = k.reshape(B, S, Hkv, D)
    v = v.reshape(B, S, Hkv, D)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        if "k_scale" in cache:
            raise NotImplementedError("the int8 KV cache is not ported")
        end = cache_index + S
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_index:end] = k.to(ck.dtype)
        cv[:, cache_index:end] = v.to(cv.dtype)
        if use_kernel:
            # the queries are the last S of the filled prefix: the kernel
            # reads the cache in place, sliced to it
            out = attention(cfg, q, ck[:, :end], cv[:, :end], causal=causal,
                            window=window, softcap=cfg.attn_softcap)
        else:
            kv_len = torch.full((B,), end, dtype=torch.int64,
                                device=x.device)
            out = attention(cfg, q, ck, cv, causal=causal, window=window,
                            softcap=cfg.attn_softcap, kv_len=kv_len,
                            q_positions=positions, use_kernel=False)
    else:
        out = attention(cfg, q, k, v, causal=causal, window=window,
                        softcap=cfg.attn_softcap, use_kernel=use_kernel)
    out = out.reshape(B, S, Hq * D) @ p["wo"]
    if "post_ln" in p:  # gemma2 post-attention norm
        out = rms_norm(out, p["post_ln"], cfg.rms_eps)
    return out, cache


def ffn_block(cfg: ModelConfig, p, x):
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    if cfg.act == "gelu_mlp":
        out = F.gelu(h @ p["wi"], approximate="tanh") @ p["wo_ff"]
    else:
        out = glu_ffn(h, p["wi"], p["wo_ff"], cfg.act)
    if "post_ln2" in p:
        out = rms_norm(out, p["post_ln2"], cfg.rms_eps)
    return out
