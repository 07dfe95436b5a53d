"""Optimizers (the port of ``repro/train/optimizer.py``): pure functions
over nested dicts of tensors, not ``torch.optim``.

* ``adamw`` — float32 moments, decoupled weight decay, global-norm
  clipping.  The arithmetic is the reference's, in its order: the decay
  joins the step before the learning rate scales it, and the bias
  corrections divide the moments (``torch.optim.AdamW`` orders both
  otherwise).
* ``adafactor`` — factored second moments (rank-1 row / column
  statistics) for configs whose AdamW state cannot fit.

On a mesh the leaves are DTensors: the updates run on each rank's own
shards, the moments in their parameter's placements (the statistics of a
factored one less the dimension they reduce), and the global norm is one
all-reduce over every rank.

An update returns new tensors and leaves its inputs as they were, as the
reference's does; the caller drops the old state (the train loop rebinds
it each step).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import tree
from ..parallel.api import is_distributed, like, on_mesh


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"               # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; float32 like
    the reference's."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(grads) -> torch.Tensor:
    """The norm over every leaf.  On a mesh (DTensor leaves) it is one
    all-reduce over every rank: each rank sums the squares of its own
    shards, counting a shard only on the first of the ranks that hold it
    alike, and the ranks' sums are added; the norm is a plain tensor,
    equal on every rank."""
    leaves = tree.leaves(grads)
    if not any(is_distributed(g) for g in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    total = None
    for g in leaves:
        part = torch.sum(torch.square(g.to_local().float()))
        if not _first_holder(g):
            part = torch.zeros_like(part)
        total = part if total is None else total + part
    dist.all_reduce(total)   # the mesh spans the process group
    return torch.sqrt(total)


def _first_holder(g) -> bool:
    """Whether this rank is the first, along every mesh dimension ``g``
    is replicated over, of the ranks that hold its shard."""
    mesh = g.device_mesh
    return all(mesh.get_local_rank(m) == 0
               for m, pl in enumerate(g.placements) if pl.is_replicate())


def clip_by_global_norm(grads, max_norm: float):
    """``(grads in float32, scaled to norm <= max_norm; the norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with on_mesh(tree.leaves(grads)):
        return tree.map(lambda g: g.float() * scale, grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _count(params) -> torch.Tensor:
    """The step count: a plain tensor, alike on every rank of a mesh."""
    leaf = tree.leaves(params)[0]
    dev = leaf.to_local().device if is_distributed(leaf) else leaf.device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params) -> dict:
    def zeros(p):   # a DTensor's moments in its placements
        return torch.zeros_like(p, dtype=torch.float32)

    return {"mu": tree.map(zeros, params), "nu": tree.map(zeros, params),
            "count": _count(params)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    """``(new params, new state, gradient norm before clipping)``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    with on_mesh(tree.leaves(params)):
        return _adamw_apply(cfg, grads, state, params, gnorm)


def _adamw_apply(cfg: OptConfig, grads, state, params, gnorm):
    count = state["count"] + 1
    lr = lr_schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    mu = tree.map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
    nu = tree.map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"],
                  grads)
    c = count.to(torch.float32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c

    def upd(p, m, v):
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return like((p.float() - lr * step).to(p.dtype), p)

    new_params = tree.map(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": count}, gnorm


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; beta1 = 0)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _zeros_without(p, dim: int | None):
    """float32 zeros of ``p``'s shape less dimension ``dim`` (none for
    None).  For a DTensor ``p`` they keep its placements, a shard of the
    dropped dimension becoming a replica (``parallel.sharding.opt_specs``'
    rule for ``vr`` / ``vc``)."""
    shape = list(p.shape)
    if dim is not None:
        del shape[dim]
    if not is_distributed(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import zeros as dzeros

    dim = None if dim is None else dim % p.ndim
    pls = []
    for pl in p.placements:
        if pl.is_shard() and dim is not None and pl.dim >= dim:
            pl = Replicate() if pl.dim == dim else Shard(pl.dim - 1)
        pls.append(pl)
    return dzeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                  placements=pls)


def adafactor_init(params) -> dict:
    def init_one(p):
        if _factored(p.shape):
            return {"vr": _zeros_without(p, -1), "vc": _zeros_without(p, -2)}
        return {"v": _zeros_without(p, None)}

    # each parameter's moments are a dict in its place
    return {"v": tree.map(init_one, params), "count": _count(params)}


def _at(nested, path: tuple):
    for k in path:
        nested = nested[k]
    return nested


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    with on_mesh(tree.leaves(params)):
        return _adafactor_apply(cfg, grads, state, params, gnorm)


def _adafactor_apply(cfg: OptConfig, grads, state, params, gnorm):
    count = state["count"] + 1
    lr = lr_schedule(cfg, count)
    decay = 1.0 - (count.to(torch.float32) + 1.0) ** -0.8

    def upd(p, g, v):
        g2 = g * g + 1e-30
        if _factored(p.shape):
            vr = decay * v["vr"] + (1 - decay) * g2.mean(dim=-1)
            vc = decay * v["vc"] + (1 - decay) * g2.mean(dim=-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                   min=1e-30))
            step = g / (torch.sqrt(denom) + cfg.eps)
            nv = {"vr": vr, "vc": vc}
        else:
            nv = {"v": decay * v["v"] + (1 - decay) * g2}
            step = g / (torch.sqrt(nv["v"]) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        nv = {k: like(t, v[k]) for k, t in nv.items()}
        return like((p.float() - lr * step).to(p.dtype), p), nv

    flat = tree.flatten_with_path(params)
    outs = [upd(p, _at(grads, path), _at(state["v"], path))
            for path, p in flat]
    new_params = tree.unflatten(params, [o[0] for o in outs])
    new_v = tree.unflatten(params, [o[1] for o in outs])
    return new_params, {"v": new_v, "count": count}, gnorm


def make_optimizer(cfg: OptConfig):
    if cfg.name == "adamw":
        return adamw_init, functools.partial(adamw_update, cfg)
    if cfg.name == "adafactor":
        return adafactor_init, functools.partial(adafactor_update, cfg)
    raise ValueError(cfg.name)
