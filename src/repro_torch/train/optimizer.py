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

An update is the reference's as a donated step runs it
(``jax.jit(..., donate_argnums=...)``): each leaf's new moments and
parameter are written into the tensors it was given, one leaf at a time,
so the update holds one leaf's temporaries, not a second state, and
returns those same tensors (the step count too), the float32 gradients
clipped in place.  That is its ``in_place=True`` form; by default it
runs the same arithmetic on copies (:func:`_copies`) and leaves its
inputs as they were, as the reference's pure function does.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import tree
from ..parallel.api import (is_distributed, like, on_mesh, plain,
                            reduce_over, write_into)


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


#: the elements of a leaf that the norm and the update take at a time (its
#: first dimension cut into runs of rows): their float32 temporaries are
#: of this many elements, not of the leaf's (the reference's fused update
#: holds none; a leaf's own would be 2 x 9.3 GiB a card for
#: deepseek-moe-16b's expert stacks on a (2, 2) mesh)
CHUNK = 1 << 26


def _chunks(*ts):
    """Matching views of ``ts`` (tensors of one shape) cut along their
    first dimension into runs of rows of at most ``CHUNK`` elements (one
    row where a row is more); a tensor of at most ``CHUNK`` elements, or
    a scalar, whole."""
    t = ts[0]
    if t.dim() == 0 or t.numel() <= CHUNK:
        yield ts
        return
    rows = max(1, CHUNK // (t.numel() // t.shape[0]))
    for start in range(0, t.shape[0], rows):
        n = min(rows, t.shape[0] - start)
        yield tuple(x.narrow(0, start, n) for x in ts)


def _sum_squares(g) -> torch.Tensor:
    """``sum(g ** 2)`` in float32, a chunk (:func:`_chunks`) at a time."""
    return sum(torch.sum(torch.square(c.float())) for (c,) in _chunks(g))


def global_norm(grads) -> torch.Tensor:
    """The norm over every leaf.  On a mesh (DTensor leaves) it is one
    all-reduce over every rank: each rank sums the squares of its own
    shards, counting a shard only on the first of the ranks that hold it
    alike, and the ranks' sums are added; the norm is a plain tensor,
    equal on every rank."""
    leaves = tree.leaves(grads)
    if not any(is_distributed(g) for g in leaves):
        return torch.sqrt(sum(_sum_squares(g) for g in leaves))
    total = None
    for g in leaves:
        part = _sum_squares(g.to_local())
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


def _clip_scale(grads, max_norm: float):
    """``(the factor that scales grads to norm <= max_norm, the norm)``."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _clipped_(g, scale):
    """A gradient leaf clipped by ``scale``: a float32 one scaled in
    place, another type scaled in a float32 copy."""
    return g.mul_(scale) if g.dtype == torch.float32 else g.float().mul_(scale)


def _own_shard(t, ref):
    """``t``'s own shard where ``ref`` (its parameter) is a DTensor laid
    out as ``t`` is (a view: writes reach ``t``); a plain ``t`` as it
    is."""
    if not is_distributed(t):
        return t
    if tuple(t.placements) != tuple(ref.placements):
        raise ValueError(f"a state leaf in {t.placements} beside its "
                         f"parameter in {ref.placements}")
    return t.to_local()


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


def _copies(grads, state, params):
    """What an update writes into, copied for its pure form: the params,
    the state and the float32 gradients (it clips those in place; it
    clips a gradient of another type in a float32 copy of its own)."""
    return (tree.map(lambda g: g.clone() if g.dtype == torch.float32 else g,
                     grads),
            tree.map(torch.clone, state), tree.map(torch.clone, params))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params,
                 in_place: bool = False):
    """``(new params, new state, gradient norm before clipping)``: with
    ``in_place`` the params and state it was given, updated (the
    gradients consumed); else copies of them.

    The reference's arithmetic, written into the state and params leaf by
    leaf, on each rank's own shards (a moment and a gradient lie as their
    parameter does), a chunk of rows at a time (:func:`_chunks`: the
    arithmetic is elementwise, so the chunks change no bit).  One float32
    buffer of the chunk's size is the update's own, and the clipped
    gradient (the caller's float32 leaf, or a float32 copy of the chunk)
    serves as the step's."""
    if not in_place:
        grads, state, params = _copies(grads, state, params)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    count = state["count"].add_(1)
    lr = lr_schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    # plain scalars for the shards' ops (a count placed on a mesh is a
    # replicated DTensor)
    lr, bc1, bc2 = (plain(t) for t in (lr, 1 - b1 ** c, 1 - b2 ** c))
    for p, g, m, v in zip(*map(tree.leaves, (params, grads, state["mu"],
                                             state["nu"]))):
        shards = (_own_shard(p, p), _own_shard(like(g, p), p),
                  _own_shard(m, p), _own_shard(v, p))
        for p, g, m, v in _chunks(*shards):
            g = _clipped_(g, scale)
            buf = torch.empty_like(g)
            m.mul_(b1).add_(torch.mul(g, 1 - b1, out=buf))         # mu
            v.mul_(b2).add_(torch.mul(g, 1 - b2, out=buf).mul_(g))  # nu
            step = torch.div(m, bc1, out=g)
            step.div_(torch.div(v, bc2, out=buf).sqrt_().add_(cfg.eps))
            step.add_(buf.copy_(p).mul_(cfg.weight_decay)).mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(step)
            else:
                p.copy_(buf.copy_(p).sub_(step))
            del buf, g, step   # before the next chunk's are made
        del shards
    return params, state, gnorm


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
def adafactor_update(cfg: OptConfig, grads, state, params,
                     in_place: bool = False):
    """As :func:`adamw_update`, for Adafactor: each leaf's new parameter
    and statistics (:func:`_adafactor_leaf`) written over the old before
    the next leaf's are made."""
    if not in_place:
        grads, state, params = _copies(grads, state, params)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    with on_mesh(tree.leaves(params)):
        count = state["count"].add_(1)
        lr = lr_schedule(cfg, count)
        decay = 1.0 - (count.to(torch.float32) + 1.0) ** -0.8
        for path, p in tree.flatten_with_path(params):
            v = _at(state["v"], path)
            g = _clipped_(like(_at(grads, path), p), scale)
            new_p, nv = _adafactor_leaf(cfg, p, g, v, lr, decay)
            write_into(p, new_p)
            for k, t in nv.items():
                write_into(v[k], t)
            del g, new_p, nv
    return params, state, gnorm


def _local(t):
    """A DTensor's local shard; a plain tensor as it is."""
    return t.to_local() if is_distributed(t) else t


def _adafactor_leaf(cfg: OptConfig, p, g, v, lr, decay):
    """One leaf's ``(new parameter, new statistics)`` from its clipped
    float32 gradient ``g`` (laid out as ``p``) and statistics ``v``.

    Each rank works on its own shards (the statistics as ``opt_specs``
    place them: ``vr`` split as ``p``'s rows, ``vc`` as its columns): a
    mean over a dimension the mesh splits is each rank's local mean,
    averaged over the ranks that split it (one all-reduce of the
    statistic), and the results are placed as the tensors they replace,
    so DTensor is left no layout to choose.  On one device there is
    nothing to average."""
    mesh, rows, cols = None, [], []
    if is_distributed(p):
        mesh, nd = p.device_mesh, p.ndim
        rows = [m for m, q in enumerate(p.placements) if q.is_shard(nd - 2)]
        cols = [m for m, q in enumerate(p.placements) if q.is_shard(nd - 1)]
    # the schedule's scalars: replicated where the step count is placed
    lr, decay = _local(lr), _local(decay)
    pl, gl = _local(p), _local(g)
    g2 = gl * gl + 1e-30
    if _factored(p.shape):
        # each statistic updated with the rank's local mean, then averaged
        # over the ranks that split the mean's dimension
        vr = decay * _local(v["vr"]) + (1 - decay) * g2.mean(dim=-1)
        vc = decay * _local(v["vc"]) + (1 - decay) * g2.mean(dim=-2)
        del g2
        mean = reduce_over(vr.mean(dim=-1, keepdim=True), mesh, cols + rows,
                           "avg")
        vr = reduce_over(vr, mesh, cols, "avg")
        vc = reduce_over(vc, mesh, rows, "avg")
        denom = (vr[..., None] * vc[..., None, :]
                 / torch.clamp(mean[..., None], min=1e-30))
        step = gl / (torch.sqrt(denom) + cfg.eps)
        del denom
        nv = {"vr": vr, "vc": vc}
    else:
        nv = {"v": decay * _local(v["v"]) + (1 - decay) * g2}
        del g2
        step = gl / (torch.sqrt(nv["v"]) + cfg.eps)
    step = step + cfg.weight_decay * pl.float()
    new_p = (pl.float() - lr * step).to(p.dtype)
    if mesh is None:
        return new_p, nv
    from torch.distributed.tensor import DTensor

    def placed(t, ref):
        return DTensor.from_local(t, mesh, ref.placements, run_check=False,
                                  shape=ref.shape, stride=ref.stride())

    return placed(new_p, p), {k: placed(t, v[k]) for k, t in nv.items()}


def make_optimizer(cfg: OptConfig, in_place: bool = False):
    """``(init, update)``; ``update(grads, state, params)`` in place with
    ``in_place``, else on copies."""
    if cfg.name == "adamw":
        return adamw_init, functools.partial(adamw_update, cfg,
                                             in_place=in_place)
    if cfg.name == "adafactor":
        return adafactor_init, functools.partial(adafactor_update, cfg,
                                                 in_place=in_place)
    raise ValueError(cfg.name)
