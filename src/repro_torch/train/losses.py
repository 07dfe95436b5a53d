"""Losses: sequence-chunked cross entropy (the port of
``repro/train/losses.py``), which keeps the ``[B, S, V]`` logits from
ever living at once for 150k-256k vocabularies.

Each chunk's unembedding, float32 logsumexp and gold logit run under
``torch.utils.checkpoint``: the forward keeps only the chunk's loss sum,
and the backward recomputes the chunk's logits, so one ``[B, chunk, V]``
block lives at a time in either direction.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models.layers import wide, wide_type
from ..models.lm import unembed

PAD_ID = 0


def _chunk_loss(cfg: ModelConfig, params, h, labels, mask):
    logits = wide(unembed(cfg, params, h))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((lse - gold) * mask).sum()


def chunked_xent(cfg: ModelConfig, params, hidden, labels,
                 mask=None) -> torch.Tensor:
    """hidden ``[B, S, d]`` -> mean cross entropy against labels
    ``[B, S]`` in chunks of ``min(cfg.loss_chunk, S)`` positions.  As in
    the reference, positions past the last whole chunk are left out, and
    PAD labels weigh 0 unless ``mask`` says otherwise."""
    B, S, _ = hidden.shape
    chunk = min(cfg.loss_chunk, S)
    n = S // chunk
    if mask is None:
        mask = (labels != PAD_ID).to(wide_type(hidden.dtype))
    tot = torch.zeros((), dtype=mask.dtype, device=hidden.device)
    cnt = torch.zeros((), dtype=mask.dtype, device=hidden.device)
    remat = torch.is_grad_enabled() and hidden.requires_grad
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (cfg, params, hidden[:, sl], labels[:, sl], mask[:, sl])
        tot = tot + (checkpoint(_chunk_loss, *args, use_reentrant=False,
                                preserve_rng_state=False) if remat
                     else _chunk_loss(*args))
        cnt = cnt + mask[:, sl].sum()
    return tot / torch.clamp(cnt, min=1.0)
