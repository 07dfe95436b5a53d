"""Decoder-LM assembly for the dense, ssm (Mamba-2) and hybrid (Hymba)
families (the port of ``repro/models/lm.py``): init, embedding,
unembedding and the teacher-forced forward.

Parameters keep the reference's names, stacked ``[L, ...]`` shapes and
types (the SSD's ``dt_bias``, ``a_log`` and ``d_skip`` are float32 whatever
``param_dtype`` is), so weights cross between the packages as a dict map
(:mod:`repro_torch.models.convert`).  Layers run as a Python loop, so each
layer's attention window is a static int.  With ``cfg.remat`` and a
gradient to take, each layer runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint(..., nothing_saveable)`` around each layer):
only its input is kept, and the backward recomputes the layer.  The
reference's ``constrain`` calls are sharding hints for a mesh; on one card
they are nothing.  The moe, encdec and vlm families are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import blocks
from .blocks import HUGE_WINDOW
from .layers import dtype_of, init_dense, rms_norm, wide


#: the families the port runs
PORTED_FAMILIES = ("dense", "ssm", "hybrid")


#: leaves that stay float32 whatever ``param_dtype`` is (the SSD's step
#: bias, log decay and skip weight, as in the reference's ``_init_ssd``)
FLOAT32_LEAVES = ("dt_bias", "a_log", "d_skip")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported; only "
            f"{', '.join(PORTED_FAMILIES)}")


def _layer_windows(cfg: ModelConfig, n: int, offset: int = 0) -> list[int]:
    """Per-layer attention window (HUGE_WINDOW = global), as ints."""
    w = np.full(n, HUGE_WINDOW, dtype=np.int64)
    if cfg.local_window:
        if cfg.layer_pattern == "lg":       # gemma2: local, global alternating
            for i in range(n):
                if (i + offset) % 2 == 0:
                    w[i] = cfg.local_window
        else:                                # hymba-style: all local but a few
            for i in range(n):
                if (i + offset) not in (0, n // 2, n - 1):
                    w[i] = cfg.local_window
    return [int(x) for x in w]


def _init_attn(gen, cfg: ModelConfig, L: int, dt) -> dict:
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    p = {
        "ln1": torch.zeros((L, d), dtype=dt, device=dev),
        "wq": init_dense(gen, (L, d, Hq * D), dt),
        "wk": init_dense(gen, (L, d, Hkv * D), dt),
        "wv": init_dense(gen, (L, d, Hkv * D), dt),
        "wo": init_dense(gen, (L, Hq * D, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((L, Hq * D), dtype=dt, device=dev)
        p["bk"] = torch.zeros((L, Hkv * D), dtype=dt, device=dev)
        p["bv"] = torch.zeros((L, Hkv * D), dtype=dt, device=dev)
    if cfg.name.startswith("gemma2"):
        p["post_ln"] = torch.zeros((L, d), dtype=dt, device=dev)
    return p


def _init_ffn(gen, cfg: ModelConfig, L: int, dt) -> dict:
    d, F = cfg.d_model, cfg.d_ff
    p = {"ln2": torch.zeros((L, d), dtype=dt, device=gen.device)}
    if cfg.act == "gelu_mlp":
        p["wi"] = init_dense(gen, (L, d, F), dt)
    else:
        p["wi"] = init_dense(gen, (L, d, 2 * F), dt)
    p["wo_ff"] = init_dense(gen, (L, F, d), dt)
    if cfg.name.startswith("gemma2"):
        p["post_ln2"] = torch.zeros((L, d), dtype=dt, device=gen.device)
    return p


def _init_ssd(gen, cfg: ModelConfig, L: int, dt) -> dict:
    d, H, P, N = cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    dev = gen.device
    return {
        "ln1": torch.zeros((L, d), dtype=dt, device=dev),
        "in_proj": init_dense(gen, (L, d, 2 * H * P + 2 * N + H), dt),
        "conv_w": init_dense(gen, (L, cfg.conv_kernel, H * P), dt,
                             scale=0.5),
        "dt_bias": torch.zeros((L, H), dtype=torch.float32, device=dev),
        "a_log": torch.zeros((L, H), dtype=torch.float32, device=dev),
        "d_skip": torch.zeros((L, H), dtype=torch.float32, device=dev),
        "out_ln": torch.zeros((L, H * P), dtype=dt, device=dev),
        "out_proj": init_dense(gen, (L, H * P, d), dt),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights for a dense, ssm or hybrid config, drawn from
    ``gen`` on its device.  The layout equals the reference's; the numbers
    differ (torch and jax generators differ), so parity tests convert the
    reference's weights instead."""
    require_ported(cfg)
    dt = dtype_of(cfg.param_dtype)
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    params: dict = {
        "embed": init_dense(gen, (V, d), dt, scale=1.0),
        "ln_f": torch.zeros((d,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, (d, V), dt)
    if cfg.family == "dense":
        params["blocks"] = {**_init_attn(gen, cfg, L, dt),
                            **_init_ffn(gen, cfg, L, dt)}
    elif cfg.family == "ssm":
        params["blocks"] = _init_ssd(gen, cfg, L, dt)
    else:  # hybrid: attention and SSD share ln1, as in the reference
        p = {**_init_attn(gen, cfg, L, dt), **_init_ssd(gen, cfg, L, dt),
             **_init_ffn(gen, cfg, L, dt)}
        p["fuse_ln_a"] = torch.zeros((L, d), dtype=dt, device=gen.device)
        p["fuse_ln_s"] = torch.zeros((L, d), dtype=dt, device=gen.device)
        params["blocks"] = p
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked block parameters (views)."""
    return {k: v[i] for k, v in params["blocks"].items()}


def embed_tokens(cfg: ModelConfig, params, tokens):
    emb = params["embed"][tokens]
    if cfg.name.startswith("gemma"):
        emb = emb * (cfg.d_model ** 0.5)
    return emb.to(dtype_of(cfg.compute_dtype))


def unembed(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["ln_f"], cfg.rms_eps)
    w = params.get("lm_head")
    if w is None:
        w = params["embed"].T
    logits = x @ w.to(x.dtype)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(
            wide(logits) / cfg.logit_softcap).to(x.dtype)
    return logits


def _layer(cfg: ModelConfig, params, i: int, window: int, positions,
           use_kernel: bool):
    """Layer ``i``'s body: ``x -> x + mixer(x) [+ ffn]``."""
    def body(x):
        p = layer_params(params, i)
        if cfg.family == "ssm":
            return x + blocks.ssd_block(cfg, p, x, use_kernel=use_kernel)[0]
        if cfg.family == "hybrid":
            a, _ = blocks.hybrid_block(cfg, p, x, positions, window,
                                       use_kernel=use_kernel)
        else:
            a, _ = blocks.attn_block(cfg, p, x, positions, window=window,
                                     use_kernel=use_kernel)
        x = x + a
        return x + blocks.ffn_block(cfg, p, x)

    return body


def forward(cfg: ModelConfig, params, tokens, *, return_hidden=False,
            use_kernel: bool = True, train: bool = False):
    """Teacher-forced forward pass -> ``(logits [B, S, V], aux)`` (or the
    hidden states ``[B, S, d]`` with ``return_hidden``).  ``aux`` is the
    reference's auxiliary loss, 0 for these families.  With
    ``use_kernel`` every attention runs through the flash kernel and every
    SSD layer through the ``ssd_scan`` kernel (their plain versions on a
    CPU tensor).  ``train`` selects the reference's training-time MoE
    dispatch; the ported families have no MoE, so it changes nothing."""
    require_ported(cfg)
    x = embed_tokens(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *params["blocks"].values()))
    for i, window in enumerate(_layer_windows(cfg, cfg.n_layers)):
        body = _layer(cfg, params, i, window, positions, use_kernel)
        # the layers draw no random numbers: no RNG state to replay
        x = checkpoint(body, x, use_reentrant=False,
                       preserve_rng_state=False) if remat else body(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return unembed(cfg, params, x), aux


class LM(nn.Module):
    """A thin module around :func:`forward` for callers that expect one."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        self.params = params

    def forward(self, tokens, use_kernel: bool = True):
        return forward(self.cfg, self.params, tokens,
                       use_kernel=use_kernel)[0]
