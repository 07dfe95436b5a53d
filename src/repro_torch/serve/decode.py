"""Prefill / decode steps for the dense, ssm and hybrid families (the
port of ``repro/serve/decode.py``).

The cache is updated in place and returned.  Layers run as a Python loop.
Each layer's attention reads the cache sliced to the filled prefix through
the flash kernel (see :func:`repro_torch.models.blocks.attn_block`);
``use_kernel=False`` runs the reference's masked attention over the whole
cache instead, for the parity checks.  SSD layers run the recurrence step
by step from the cached state (prefill and decode alike), as the
reference does: the ``ssd_scan`` kernel serves only the teacher-forced
forward.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import blocks
from ..models.lm import (_layer_windows, embed_tokens, layer_params,
                         require_ported, unembed)
from .kvcache import init_cache


def _run_layers(cfg: ModelConfig, params, cache, x, positions,
                cache_index: int, use_kernel: bool):
    for i, window in enumerate(_layer_windows(cfg, cfg.n_layers)):
        p = layer_params(params, i)
        layer = {k: v[i] for k, v in cache.items()}  # views: written in place
        if cfg.family == "ssm":
            s, _ = blocks.ssd_block(cfg, p, x, cache=layer)
            x = x + s
            continue
        kv = {"k": layer["k"], "v": layer["v"]}
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
        x = x + blocks.ffn_block(cfg, p, x)
    return x


def prefill(cfg: ModelConfig, params, cache, tokens, *,
            use_kernel: bool = True):
    """Fill the cache from a prompt ``[B, S]``; returns
    ``(logits_last [B, 1, V], cache)``."""
    require_ported(cfg)
    x = embed_tokens(cfg, params, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    x = _run_layers(cfg, params, cache, x, positions, 0, use_kernel)
    return unembed(cfg, params, x[:, -1:, :]), cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos: int, *,
                use_kernel: bool = True):
    """One decode step.  tokens ``[B, 1]``; pos: the cache fill (an int).
    Returns ``(logits [B, 1, V], cache)``."""
    require_ported(cfg)
    x = embed_tokens(cfg, params, tokens)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    x = _run_layers(cfg, params, cache, x, positions, int(pos), use_kernel)
    return unembed(cfg, params, x), cache


def greedy_generate(cfg: ModelConfig, params, prompt, max_new: int,
                    max_len: int | None = None, *, use_kernel: bool = True):
    """Greedy loop: ``prompt [B, S]`` -> ``[B, max_new]`` tokens.  The
    cache lives on the prompt's device."""
    B, S = prompt.shape
    cache = init_cache(cfg, B, max_len or (S + max_new),
                       device=prompt.device)
    logits, cache = prefill(cfg, params, cache, prompt,
                            use_kernel=use_kernel)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    out = [tok]
    for i in range(max_new - 1):
        logits, cache = decode_step(cfg, params, cache, tok, S + i,
                                    use_kernel=use_kernel)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
