"""LM assembly for every family (the port of ``repro/models/lm.py``):
init, embedding, unembedding and the teacher-forced forward of the dense,
moe, ssm, hybrid, encdec and vlm families.

Parameters keep the reference's names, stacked ``[L, ...]`` shapes and
types (the SSD's ``dt_bias``, ``a_log`` and ``d_skip`` are float32 whatever
``param_dtype`` is), so weights cross between the packages as a dict map
(:mod:`repro_torch.models.convert`).  MoE models keep their leading dense
layers in a stack of their own (``dense_blocks``); encoder-decoder models
their encoder in ``enc_blocks`` with ``enc_ln_f``, and the decoder's
cross-attention leaves ``x_*`` in ``blocks``; vlm models the patch
projection ``patch_proj``.  Layers run as a Python loop, so each layer's
attention window is a static int.  With ``cfg.remat`` and a gradient to
take, each layer of every stack runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint(..., nothing_saveable)`` around each layer):
only its input is kept, and the backward recomputes the layer.  The
reference's ``constrain`` calls are sharding hints for a mesh; on one card
they are nothing.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import tree
from ..configs.base import ModelConfig
from . import blocks
from .blocks import HUGE_WINDOW
from .layers import attention_ref, dtype_of, init_dense, rms_norm, wide


#: leaves that stay float32 whatever ``param_dtype`` is (the SSD's step
#: bias, log decay and skip weight, as in the reference's ``_init_ssd``)
FLOAT32_LEAVES = ("dt_bias", "a_log", "d_skip")


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


def _init_moe_ffn(gen, cfg: ModelConfig, L: int, dt) -> dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p = {
        "ln2": torch.zeros((L, d), dtype=dt, device=gen.device),
        "router": init_dense(gen, (L, d, E), dt),
        "we_i": init_dense(gen, (L, E, d, 2 * f), dt),
        "we_o": init_dense(gen, (L, E, f, d), dt),
    }
    if cfg.n_shared_experts > 0:
        fs = f * cfg.n_shared_experts
        p["ws_i"] = init_dense(gen, (L, d, 2 * fs), dt)
        p["ws_o"] = init_dense(gen, (L, fs, d), dt)
    return p


def _init_cross(gen, cfg: ModelConfig, L: int, dt) -> dict:
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"x_ln": torch.zeros((L, d), dtype=dt, device=gen.device),
            "x_wq": init_dense(gen, (L, d, Hq * D), dt),
            "x_wk": init_dense(gen, (L, d, Hkv * D), dt),
            "x_wv": init_dense(gen, (L, d, Hkv * D), dt),
            "x_wo": init_dense(gen, (L, Hq * D, d), dt)}


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random weights for any family, drawn from ``gen`` on its device.
    The layout equals the reference's; the numbers differ (torch and jax
    generators differ), so parity tests convert the reference's weights
    instead."""
    dt = dtype_of(cfg.param_dtype)
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    dev = gen.device
    params: dict = {
        "embed": init_dense(gen, (V, d), dt, scale=1.0),
        "ln_f": torch.zeros((d,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, (d, V), dt)
    fam = cfg.family
    if fam in ("dense", "vlm"):
        params["blocks"] = {**_init_attn(gen, cfg, L, dt),
                            **_init_ffn(gen, cfg, L, dt)}
    elif fam == "moe":
        nd = cfg.n_dense_layers
        if nd:
            params["dense_blocks"] = {**_init_attn(gen, cfg, nd, dt),
                                      **_init_ffn(gen, cfg, nd, dt)}
        params["blocks"] = {**_init_attn(gen, cfg, L - nd, dt),
                            **_init_moe_ffn(gen, cfg, L - nd, dt)}
    elif fam == "ssm":
        params["blocks"] = _init_ssd(gen, cfg, L, dt)
    elif fam == "hybrid":  # attention and SSD share ln1, as in the reference
        p = {**_init_attn(gen, cfg, L, dt), **_init_ssd(gen, cfg, L, dt),
             **_init_ffn(gen, cfg, L, dt)}
        p["fuse_ln_a"] = torch.zeros((L, d), dtype=dt, device=dev)
        p["fuse_ln_s"] = torch.zeros((L, d), dtype=dt, device=dev)
        params["blocks"] = p
    elif fam == "encdec":
        Le = cfg.n_encoder_layers
        params["enc_blocks"] = {**_init_attn(gen, cfg, Le, dt),
                                **_init_ffn(gen, cfg, Le, dt)}
        params["blocks"] = {**_init_attn(gen, cfg, L, dt),
                            **_init_ffn(gen, cfg, L, dt),
                            **_init_cross(gen, cfg, L, dt)}
        params["enc_ln_f"] = torch.zeros((d,), dtype=dt, device=dev)
    else:
        raise ValueError(fam)
    if fam == "vlm":
        # the stubbed anyres frontend: one projection of precomputed patches
        params["patch_proj"] = init_dense(gen, (d, d), dt)
    return params


def layer_params(params: dict, i: int, stack: str = "blocks") -> dict:
    """Layer ``i``'s slice of a stack of block parameters (``blocks``,
    ``dense_blocks`` or ``enc_blocks``), as views."""
    return {k: v[i] for k, v in params[stack].items()}


def stacks(cfg: ModelConfig) -> list[tuple[str, int, list[int]]]:
    """The decoder's stacks in order, as ``(name, first layer, windows)``:
    a MoE model's leading dense layers (``dense_blocks``, layers
    ``0 .. nd - 1``) then its MoE layers (``blocks``, from ``nd``, their
    windows offset by ``nd``); every other family one stack ``blocks``.
    The first layer indexes the cache, whose leading axis counts every
    decoder layer."""
    nd = cfg.n_dense_layers if cfg.family == "moe" else 0
    out = [("dense_blocks", 0, _layer_windows(cfg, nd))] if nd else []
    return out + [("blocks", nd, _layer_windows(cfg, cfg.n_layers - nd,
                                                offset=nd))]


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


def _layer(cfg: ModelConfig, p: dict, window, positions, use_kernel: bool,
           train: bool):
    """One decoder layer's body ``(x[, enc_out]) -> (x', aux)``: the
    mixer, then (for every family but ssm) the FFN, the MoE FFN
    (capacity-dropped with ``train``, else dropless) or, for encdec,
    cross-attention over ``enc_out`` and the FFN."""
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)

    def body(x, enc_out=None):
        if cfg.family == "ssm":
            return x + blocks.ssd_block(cfg, p, x,
                                        use_kernel=use_kernel)[0], zero
        if cfg.family == "hybrid":
            a, _ = blocks.hybrid_block(cfg, p, x, positions, window,
                                       use_kernel=use_kernel)
        else:
            a, _ = blocks.attn_block(cfg, p, x, positions, window=window,
                                     use_kernel=use_kernel)
        x = x + a
        if enc_out is not None:
            x = x + _cross_attn(cfg, p, x, enc_out)
        if "router" in p:
            moe = blocks.moe_block if train else blocks.moe_block_dropless
            m, aux = moe(cfg, p, x)
            return x + m, aux
        return x + blocks.ffn_block(cfg, p, x), zero

    return body


def _encoder_layer(cfg: ModelConfig, p: dict, positions, use_kernel: bool):
    """One encoder layer: non-causal self-attention, then the FFN."""
    def body(h):
        a, _ = blocks.attn_block(cfg, p, h, positions, causal=False,
                                 use_kernel=use_kernel)
        h = h + a
        return h + blocks.ffn_block(cfg, p, h)

    return body


def _cross_attn(cfg: ModelConfig, p, x, enc):
    """Cross-attention of the decoder over the encoder's output ``enc``
    through the reference's masked attention, as in the reference."""
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["x_ln"], cfg.rms_eps)
    q = (h @ p["x_wq"]).reshape(B, S, Hq, D)
    k = (enc @ p["x_wk"]).reshape(B, -1, Hkv, D)
    v = (enc @ p["x_wv"]).reshape(B, -1, Hkv, D)
    out = attention_ref(q, k, v, causal=False)
    return out.reshape(B, S, Hq * D) @ p["x_wo"]


def _run(fn, remat: bool, *args):
    # the layers draw no random numbers: no RNG state to replay
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def encode(cfg: ModelConfig, params, enc, *, use_kernel: bool = True,
           remat: bool = False):
    """The encoder stack over frames ``enc [B, T, d]`` (non-causal), then
    ``enc_ln_f``."""
    Be, Te, _ = enc.shape
    pos = torch.arange(Te, device=enc.device)[None, :].expand(Be, Te)
    for i in range(cfg.n_encoder_layers):
        p = layer_params(params, i, "enc_blocks")
        enc = _run(_encoder_layer(cfg, p, pos, use_kernel), remat, enc)
    return rms_norm(enc, params["enc_ln_f"], cfg.rms_eps)


def forward(cfg: ModelConfig, params, tokens, *, patch_embeds=None,
            encoder_feats=None, return_hidden=False, use_kernel: bool = True,
            train: bool = False):
    """Teacher-forced forward pass -> ``(logits [B, S, V], aux)`` (or the
    hidden states ``[B, S, d]`` with ``return_hidden``).

    ``patch_embeds [B, P, d]`` (vlm): projected and prepended to the token
    embeddings, so the outputs cover ``P + S`` positions.
    ``encoder_feats [B, T, d]`` (encdec): frames, cast to the compute type,
    through the encoder stack; the decoder cross-attends to the result.
    ``aux`` is the MoE layers' summed load-balance loss (0 for the other
    families).  ``train`` selects the training-time MoE dispatch
    (capacity-dropped); the default is the exact dropless routing of the
    serving path.  With ``use_kernel`` every self-attention runs through
    the flash kernel and every SSD layer through ``ssd_scan`` (their plain
    versions on a CPU tensor); cross-attention is the reference's masked
    attention either way."""
    x = embed_tokens(cfg, params, tokens)
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = patch_embeds.to(x.dtype) @ params["patch_proj"]
        x = torch.cat([pe, x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in tree.leaves(params)))
    enc_out = None
    if cfg.family == "encdec":
        if encoder_feats is None:
            raise ValueError("an encdec forward needs encoder_feats")
        enc_out = encode(cfg, params, encoder_feats.to(x.dtype),
                         use_kernel=use_kernel, remat=remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stack, _, windows in stacks(cfg):
        for i, window in enumerate(windows):
            body = _layer(cfg, layer_params(params, i, stack), window,
                          positions, use_kernel, train)
            x, a = _run(body, remat, x, *(() if enc_out is None
                                          else (enc_out,)))
            aux = aux + a
    if return_hidden:
        return x, aux
    return unembed(cfg, params, x), aux


class LM(nn.Module):
    """A thin module around :func:`forward` for callers that expect one."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.params = params

    def forward(self, tokens, use_kernel: bool = True):
        return forward(self.cfg, self.params, tokens,
                       use_kernel=use_kernel)[0]
