"""Batched serving entry point: prefill a batch of prompts, decode greedily
(the port of ``repro/launch/serve.py``) for every family: dense
(kratos-dd, gemma2-2b, ...), moe (deepseek-moe-16b), ssm (mamba2-2.7b),
hybrid (hymba-1.5b), encdec (whisper-small) and vlm (llava-next-34b).

    python -m repro_torch.launch.serve --arch kratos-dd [--smoke]
        [--batch 4] [--prompt-len 32] [--max-new 16] [--device cuda]
    python -m repro_torch.launch.serve --arch deepseek-moe-16b
    python -m repro_torch.launch.serve --arch whisper-small

Weights are random, drawn from a seeded generator on the device; prompts,
and then an encdec model's frames (``encoder_seq`` of them) or a vlm
model's patch embeddings (``n_patches``), come from one seeded numpy
generator in the reference's order.  A config's ``kv_cache_dtype="int8"``
serves from the int8 cache.  kimi-k2-1t-a32b's 2.05 TB of bf16 weights
fit no single card: it runs with ``--smoke`` only.  Prints prefill ms, decode ms per step and
tokens per second.  The default device is the card; without one it
raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import ModelConfig, get_config
from ..device import resolve_device
from ..models.lm import init_params
from ..serve.decode import decode_step, prefill
from ..serve.kvcache import init_cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_params(cfg: ModelConfig, device, seed: int = 0) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(gen, cfg)


def make_inputs(cfg: ModelConfig, batch: int, prompt_len: int, device,
                seed: int = 0) -> tuple[torch.Tensor, dict]:
    """``(prompts [B, S], extra)`` from one numpy generator, in the
    reference launcher's order: the prompts, then (encdec) the frames
    ``encoder_feats [B, encoder_seq, d]`` or (vlm) the patch embeddings
    ``patch_embeds [B, n_patches, d]``, float32 normals x 0.02.  ``extra``
    holds those as keyword arguments of :func:`generate`."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, size=(batch, prompt_len))
    extra = {}
    n = {"encdec": ("encoder_feats", cfg.encoder_seq),
         "vlm": ("patch_embeds", cfg.n_patches)}.get(cfg.family)
    if n is not None:
        feats = rng.standard_normal((batch, n[1], cfg.d_model)
                                    ).astype(np.float32) * 0.02
        extra[n[0]] = torch.from_numpy(feats).to(device)
    return torch.from_numpy(toks).to(device), extra


def generate(cfg: ModelConfig, params, prompts, max_new: int, *,
             encoder_feats=None, patch_embeds=None, use_kernel: bool = True,
             keep_logits: bool = False) -> dict:
    """Prefill ``prompts [B, S]`` (with an encdec model's
    ``encoder_feats`` or a vlm model's ``patch_embeds``, P of them) and
    decode ``max_new`` tokens greedily from position ``S + P`` over a
    cache of ``S + P + max_new`` positions.

    Returns the tokens ``[B, max_new]``, the wall times (host clock around
    work that ends in a device synchronisation) and, with ``keep_logits``,
    the float32 logits of the prefill and of every decode step
    (``[B, max_new, V]``)."""
    device = prompts.device
    B, S = prompts.shape
    extra = patch_embeds.shape[1] if patch_embeds is not None else 0
    cache = init_cache(cfg, B, S + extra + max_new,
                       encoder_len=(encoder_feats.shape[1]
                                    if encoder_feats is not None else None),
                       device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, cache, prompts,
                            encoder_feats=encoder_feats,
                            patch_embeds=patch_embeds, use_kernel=use_kernel)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    _sync(device)
    t1 = time.perf_counter()
    out, kept = [tok], [logits.float()] if keep_logits else []
    for i in range(max_new - 1):
        logits, cache = decode_step(cfg, params, cache, tok,
                                    S + extra + i, use_kernel=use_kernel)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        out.append(tok)
        if keep_logits:
            kept.append(logits.float())
    _sync(device)
    t2 = time.perf_counter()
    steps = max_new - 1
    res = {"tokens": torch.cat(out, dim=1),
           "prefill_ms": (t1 - t0) * 1e3,
           "decode_ms_per_step": (t2 - t1) * 1e3 / steps if steps else 0.0,
           "tok_per_s": B * max_new / (t2 - t0),
           "decode_tok_per_s": B * steps / (t2 - t1) if steps else 0.0}
    if keep_logits:
        res["logits"] = torch.cat(kept, dim=1)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = make_params(cfg, device)
    prompts, extra = make_inputs(cfg, args.batch, args.prompt_len, device)
    res = generate(cfg, params, prompts, args.max_new, **extra)
    B = args.batch
    print(f"{cfg.name} on {device}: prefill {B}x{args.prompt_len} in "
          f"{res['prefill_ms']:.2f} ms; decode {res['decode_ms_per_step']:.3f}"
          f" ms per step; {B}x{args.max_new} tokens at "
          f"{res['tok_per_s']:.1f} tok/s")
    print("first row:", res["tokens"][0].cpu().numpy())
    return res["tokens"]


if __name__ == "__main__":
    main()
