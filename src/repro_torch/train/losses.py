"""Losses: sequence-chunked cross entropy (the port of
``repro/train/losses.py``), which keeps the ``[B, S, V]`` logits from
ever living at once for 150k-256k vocabularies.

Each chunk's unembedding, float32 logsumexp and gold logit run under
``torch.utils.checkpoint``: the forward keeps only the chunk's loss sum,
and the backward recomputes the chunk's logits, so one ``[B, chunk, V]``
block lives at a time in either direction.  On a mesh the logits are
sharded over the vocabulary (``lm_head`` ``[d on data, V on model]``):
the logsumexp reduces across ranks by DTensor's rules and each rank
picks the gold logits in its own vocabulary slice (:func:`_gold`).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models.layers import wide, wide_type
from ..models.lm import unembed
from ..parallel.api import whole

PAD_ID = 0


def _pick(logits, labels, first: int):
    """``logits[..., labels - first]`` where the label falls in this block
    of ``logits.shape[-1]`` vocabulary entries from ``first``, else 0."""
    local = labels - first
    inside = (local >= 0) & (local < logits.shape[-1])
    got = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    return torch.where(inside, got[..., 0], 0.0)


def _gold(logits, labels):
    """The logit of each label.  On a mesh (DTensor logits ``[B, c, V]``)
    under ``local_map``: rows over the data axes, the vocabulary over
    ``model``; each rank picks the labels that fall in its vocabulary
    slice (0 for the others), and the ranks' picks are a partial sum over
    ``model``."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Partial

    from ..models.layers import mesh_axes, mesh_placements, reduce_model
    from ..parallel.api import local_map

    mesh = logits.device_mesh
    dp, n_dp, mp = mesh_axes(mesh)
    rows = {n: 0 if logits.shape[0] % n_dp == 0 else None for n in dp}
    width = -(-logits.shape[-1] // mp)     # DTensor's chunk of V

    def pick(lg, lb):
        return _pick(lg, lb, mesh.get_local_rank("model") * width
                     if mp > 1 else 0)

    out = mesh_placements(mesh, rows)
    out = [Partial() if n == "model" else p
           for n, p in zip(mesh.mesh_dim_names, out)]
    # the ranks' picks summed here, so the loss's terms meet at one
    # placement
    return reduce_model(local_map(
        pick, out_placements=out,
        in_placements=(mesh_placements(mesh, {**rows, "model": 2}),
                       mesh_placements(mesh, rows)),
        device_mesh=mesh)(logits, labels))


def _chunk_loss(cfg: ModelConfig, params, h, labels, mask):
    logits = wide(unembed(cfg, params, h))
    lse = torch.logsumexp(logits, dim=-1)
    return whole(((lse - _gold(logits, labels)) * mask).sum())


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
        cnt = cnt + whole(mask[:, sl].sum())
    return tot / torch.clamp(cnt, min=1.0)
