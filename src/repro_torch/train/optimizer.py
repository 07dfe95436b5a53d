"""Optimizers (the port of ``repro/train/optimizer.py``): pure functions
over nested dicts of tensors, not ``torch.optim``.

* ``adamw`` — float32 moments, decoupled weight decay, global-norm
  clipping.  The arithmetic is the reference's, in its order: the decay
  joins the step before the learning rate scales it, and the bias
  corrections divide the moments (``torch.optim.AdamW`` orders both
  otherwise).
* ``adafactor`` — factored second moments (rank-1 row / column
  statistics) for configs whose AdamW state cannot fit.

An update returns new tensors and leaves its inputs as they were, as the
reference's does; the caller drops the old state (the train loop rebinds
it each step).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from .. import tree


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
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """``(grads in float32, scaled to norm <= max_norm; the norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.map(lambda g: g.float() * scale, grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _count(params) -> torch.Tensor:
    dev = tree.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"mu": tree.map(zeros, params), "nu": tree.map(zeros, params),
            "count": _count(params)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    """``(new params, new state, gradient norm before clipping)``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
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
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree.map(upd, params, mu, nu)
    return new_params, {"mu": mu, "nu": nu, "count": count}, gnorm


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; beta1 = 0)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor_init(params) -> dict:
    def init_one(p):
        kw = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **kw),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **kw)}
        return {"v": torch.zeros(p.shape, **kw)}

    # each parameter's moments are a dict in its place
    return {"v": tree.map(init_one, params), "count": _count(params)}


def _at(nested, path: tuple):
    for k in path:
        nested = nested[k]
    return nested


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
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
        return (p.float() - lr * step).to(p.dtype), nv

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
