"""Prefill / decode steps for every family (the port of
``repro/serve/decode.py``).

The cache is updated in place and returned.  Layers run as a Python loop
over the decoder's stacks (:func:`repro_torch.models.lm.stacks`): a MoE
model's dense layers own the cache's first ``n_dense_layers`` entries and
its MoE layer ``i`` entry ``n_dense_layers + i``.  Each layer's attention
reads the cache's filled prefix through the flash kernel (see
:func:`repro_torch.models.blocks.attn_block`); ``use_kernel=False`` runs
the reference's masked attention over the whole cache instead, for the
parity checks.  MoE layers route droplessly, so a decode step treats each
token as the teacher-forced forward does.  An encoder-decoder model runs
its encoder once at prefill and caches each layer's cross-attention keys
and values.  SSD layers run the recurrence step by step from the cached
state (prefill and decode alike), as the reference does: the ``ssd_scan``
kernel serves only the teacher-forced forward.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import blocks
from ..models.layers import attention_ref, rms_norm
from ..models.lm import embed_tokens, encode, layer_params, stacks, unembed
from .kvcache import init_cache

_KV = ("k", "v", "k_scale", "v_scale")


def _cross_attn_cached(cfg: ModelConfig, p, x, layer):
    """Cross-attention over the layer's cached encoder keys and values,
    through the reference's masked attention, as in the reference."""
    B, S, _ = x.shape
    Hq, D = cfg.n_heads, cfg.hd
    h = rms_norm(x, p["x_ln"], cfg.rms_eps)
    q = (h @ p["x_wq"]).reshape(B, S, Hq, D)
    out = attention_ref(q, layer["xk"], layer["xv"], causal=False)
    return out.reshape(B, S, Hq * D) @ p["x_wo"]


def _layer_step(cfg: ModelConfig, x, p, layer, window, positions,
                cache_index: int, use_kernel: bool):
    """One decoder layer over its cache entry ``layer`` (views, written in
    place); returns the new ``x``."""
    if cfg.family == "ssm":
        return x + blocks.ssd_block(cfg, p, x, cache=layer)[0]
    kv = {k: layer[k] for k in _KV if k in layer}
    if cfg.family == "hybrid":
        ssd = {"conv": layer["conv"], "ssm": layer["ssm"]}
        a, _ = blocks.hybrid_block(cfg, p, x, positions, window,
                                   cache={"kv": kv, "ssd": ssd},
                                   cache_index=cache_index,
                                   use_kernel=use_kernel)
    else:
        a, _ = blocks.attn_block(cfg, p, x, positions, window=window,
                                 cache=kv, cache_index=cache_index,
                                 use_kernel=use_kernel)
    x = x + a
    if cfg.family == "encdec":
        x = x + _cross_attn_cached(cfg, p, x, layer)
    if "router" in p:
        return x + blocks.moe_block_dropless(cfg, p, x)[0]
    return x + blocks.ffn_block(cfg, p, x)


def _run_layers(cfg: ModelConfig, params, cache, x, positions,
                cache_index: int, use_kernel: bool):
    for stack, first, windows in stacks(cfg):
        for i, window in enumerate(windows):
            layer = {k: v[first + i] for k, v in cache.items()}
            x = _layer_step(cfg, x, layer_params(params, i, stack), layer,
                            window, positions, cache_index, use_kernel)
    return x


def _encode_to_cache(cfg: ModelConfig, params, cache, encoder_feats,
                     use_kernel: bool) -> None:
    """The encoder over ``encoder_feats``, then each decoder layer's
    cross-attention keys and values into ``cache["xk"]`` / ``["xv"]``.

    As in the reference, the frames are not cast to the compute type: the
    encoder computes in the type jnp promotes the frames' and the weights'
    types to (float32 frames on bfloat16 weights: float32), so the frames
    and the encoder's weights are cast to it (torch does not mix types in
    a product).  The keys and values are stored in the cache's type."""
    dt = torch.promote_types(encoder_feats.dtype,
                             params["enc_blocks"]["wq"].dtype)
    weights = {"enc_blocks": {k: v.to(dt)
                              for k, v in params["enc_blocks"].items()},
               "enc_ln_f": params["enc_ln_f"].to(dt)}
    enc = encode(cfg, weights, encoder_feats.to(dt), use_kernel=use_kernel)
    Be, Te, _ = enc.shape
    Hkv, D = cfg.n_kv_heads, cfg.hd
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        cache["xk"][i] = (enc @ p["x_wk"].to(dt)).reshape(Be, Te, Hkv, D)
        cache["xv"][i] = (enc @ p["x_wv"].to(dt)).reshape(Be, Te, Hkv, D)


def prefill(cfg: ModelConfig, params, cache, tokens, *, encoder_feats=None,
            patch_embeds=None, use_kernel: bool = True):
    """Fill the cache from a prompt ``[B, S]`` (after ``patch_embeds``
    ``[B, P, d]`` for vlm, at positions ``0 .. P-1``; with the encoder's
    keys and values from ``encoder_feats`` for encdec); returns
    ``(logits_last [B, 1, V], cache)``."""
    x = embed_tokens(cfg, params, tokens)
    if cfg.family == "vlm" and patch_embeds is not None:
        pe = patch_embeds.to(x.dtype) @ params["patch_proj"]
        x = torch.cat([pe, x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if cfg.family == "encdec":
        _encode_to_cache(cfg, params, cache, encoder_feats, use_kernel)
    x = _run_layers(cfg, params, cache, x, positions, 0, use_kernel)
    return unembed(cfg, params, x[:, -1:, :]), cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int, *,
                use_kernel: bool = True):
    """One decode step.  tokens ``[B, 1]``; pos: the cache fill (an int).
    Returns ``(logits [B, 1, V], cache)``."""
    x = embed_tokens(cfg, params, tokens)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    x = _run_layers(cfg, params, cache, x, positions, int(pos), use_kernel)
    return unembed(cfg, params, x), cache


def greedy_generate(cfg: ModelConfig, params, prompt, max_new: int,
                    max_len: int | None = None, *, encoder_feats=None,
                    patch_embeds=None, use_kernel: bool = True):
    """Greedy loop: ``prompt [B, S]`` -> ``[B, max_new]`` tokens.  The
    cache (of ``S + P + max_new`` positions unless ``max_len`` says
    otherwise, P the patches) lives on the prompt's device; decoding
    starts at position ``S + P``."""
    B, S = prompt.shape
    extra = patch_embeds.shape[1] if patch_embeds is not None else 0
    cache = init_cache(cfg, B, max_len or (S + extra + max_new),
                       encoder_len=(encoder_feats.shape[1]
                                    if encoder_feats is not None else None),
                       device=prompt.device)
    logits, cache = prefill(cfg, params, cache, prompt,
                            encoder_feats=encoder_feats,
                            patch_embeds=patch_embeds, use_kernel=use_kernel)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    out = [tok]
    pos = S + extra
    for i in range(max_new - 1):
        logits, cache = decode_step(cfg, params, cache, tok, pos + i,
                                    use_kernel=use_kernel)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
