"""Per-layer bodies for the dense, ssm and hybrid families: attention,
FFN, the Mamba-2 SSD mixer and Hymba's parallel attention + SSD block
(the port of ``repro/models/blocks.py``'s ``attn_block``, ``ffn_block``,
``_causal_conv``, ``ssd_block`` and ``hybrid_block``).

Blocks operate on one layer's parameter slice (no leading L axis).  A
cache is a dict of one layer's tensors (``k``/``v`` ``[B, T, Hkv, D]``,
``conv`` ``[B, Kc-1, H*P]``, ``ssm`` ``[B, H, P, N]``), updated in place.
MoE blocks and the int8 KV cache are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops, ref
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


def _causal_conv(x, w, state=None):
    """Depthwise causal conv along time.  x: ``[B, S, C]``; w: ``[Kc, C]``.
    With ``state`` ``[B, Kc-1, C]`` it continues a stream.  Returns
    ``(out, new_state)``; new_state is the last Kc-1 inputs (None for
    Kc = 1)."""
    Kc = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], Kc - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(Kc))
    new_state = xp[:, xp.shape[1] - (Kc - 1):, :] if Kc > 1 else None
    return out, new_state


def ssd_block(cfg: ModelConfig, p, x, cache=None, use_kernel: bool = True):
    """Mamba-2 SSD mixer.  x: ``[B, S, d]``.  Without ``cache`` the scan
    runs through :func:`repro_torch.kernels.ops.ssd_scan` (the CUDA kernel
    on a CUDA tensor) or, with ``use_kernel=False``, through the plain
    chunked or sequential scan by the reference's condition.  With
    ``cache`` (dict ``conv`` ``[B, Kc-1, H*P]``, ``ssm`` ``[B, H, P, N]``
    float32) it runs the recurrence step by step from the cached state and
    writes the new state into the cache in place.  Returns
    ``(out, cache)``."""
    B, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    proj = h @ p["in_proj"]     # [B, S, HP + HP + N + N + H]
    zx, xin, Bm, Cm, dt = torch.split(proj, [H * P, H * P, N, N, H], dim=-1)
    # softplus as jax.nn.softplus forms it: logaddexp(x, 0)
    dt = torch.logaddexp(dt.float() + p["dt_bias"],
                         torch.zeros((), device=x.device))      # [B, S, H]
    A = -torch.exp(p["a_log"].float())                   # [H]
    conv_state = cache["conv"] if cache is not None else None
    xin, new_conv = _causal_conv(xin, p["conv_w"], conv_state)
    xin = F.silu(xin.float()).to(x.dtype)
    xh = xin.reshape(B, S, H, P)
    if cache is not None:
        # recurrent decode: S small (1 per decode step; the prompt length
        # at prefill)
        y, hst = ref.ssd_recurrence(xh, dt, A, Bm, Cm, cache["ssm"].float())
        y = y.reshape(B, S, H * P)
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(hst)
    elif use_kernel:
        y = ops.ssd_scan(xh, dt, A, Bm, Cm).reshape(B, S, H * P)
    elif cfg.ssd_chunk and S % cfg.ssd_chunk == 0 and S > cfg.ssd_chunk:
        y = ref.ssd_scan_chunked_ref(xh, dt, A, Bm, Cm, chunk=cfg.ssd_chunk
                                     ).reshape(B, S, H * P)
    else:
        y = ref.ssd_scan_ref(xh, dt, A, Bm, Cm).reshape(B, S, H * P)
    # jnp.repeat: each head's skip weight repeated over its P channels
    d_skip = p["d_skip"].to(x.dtype).repeat_interleave(P)
    y = y + xh.reshape(B, S, H * P) * d_skip
    y = y.to(x.dtype) * F.silu(zx.float()).to(x.dtype)
    out = rms_norm(y, p["out_ln"], cfg.rms_eps) @ p["out_proj"]
    return out, cache


def hybrid_block(cfg: ModelConfig, p, x, positions, window, cache=None,
                 cache_index=None, use_kernel: bool = True):
    """Hymba: attention and SSD heads in parallel on the same input, each
    branch normalised, then averaged.  ``cache``: dict ``kv`` (``k``/``v``)
    and ``ssd`` (``conv``/``ssm``), updated in place."""
    attn_out, _ = attn_block(cfg, p, x, positions, window=window,
                             cache=cache["kv"] if cache else None,
                             cache_index=cache_index, use_kernel=use_kernel)
    ssd_out, _ = ssd_block(cfg, p, x, cache=cache["ssd"] if cache else None,
                           use_kernel=use_kernel)
    fused = 0.5 * (rms_norm(attn_out, p["fuse_ln_a"], cfg.rms_eps)
                   + rms_norm(ssd_out, p["fuse_ln_s"], cfg.rms_eps))
    return fused, cache
