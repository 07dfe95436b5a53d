"""Deterministic synthetic token pipeline (the port of
``repro/data/pipeline.py``; ``batch_for_step`` is its numpy, copied).

Every batch is a pure function of (seed, step, shard), so a restarted job
regenerates the identical global batch with no data-loader state to
checkpoint.  Tokens follow a Zipf-ish distribution with a learnable
structure (repeated n-grams), so small models overfit measurably.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device


def batch_for_step(cfg: ModelConfig, seq_len: int, global_batch: int,
                   step: int, seed: int = 0, shard: int = 0,
                   n_shards: int = 1) -> dict:
    """Host-side numpy batch for one (possibly sharded) train step."""
    assert global_batch % n_shards == 0
    b = global_batch // n_shards
    rng = np.random.default_rng(
        np.uint64(seed) * np.uint64(1_000_003)
        + np.uint64(step) * np.uint64(9973) + np.uint64(shard))
    V = cfg.vocab
    # zipf-ish marginal + planted bigram structure: token[t+1] usually
    # (token[t] * 31 + 7) % V_small
    v_small = min(V - 2, 512)
    base = (rng.zipf(1.3, size=(b, seq_len)) % v_small) + 1
    planted = (base * 31 + 7) % v_small + 1
    use_planted = rng.random((b, seq_len)) < 0.7
    toks = np.where(use_planted, np.roll(planted, 1, axis=1), base)
    toks = toks.astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = 0  # PAD: ignored by the loss
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        P = max(cfg.n_patches, 1)
        out["patch_embeds"] = rng.standard_normal(
            (b, P, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == "encdec":
        T = max(cfg.encoder_seq, 1)
        out["encoder_feats"] = rng.standard_normal(
            (b, T, cfg.d_model)).astype(np.float32) * 0.02
    return out


def to_device(batch: dict, device=None) -> dict:
    """The batch as tensors on ``device`` (the card unless asked for the
    CPU): integer arrays (tokens, labels) as int64, torch's index type;
    the rest in their own type."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(dev)
    return out
