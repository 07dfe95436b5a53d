"""Pipeline parallelism (the port of ``repro/parallel/pipeline.py``): the
GPipe wavefront over S stages.

Every tick each stage applies its layers to what it holds, then hands its
activation to the next stage.  The rules are the reference's: stage 0
injects microbatch t at tick t, stage s computes during ticks
``[s, s + n_mb)`` (outside them it holds what it had), the last stage
drains microbatch ``t - (S - 1)``, and the schedule takes ``n_mb + S - 1``
ticks; the bubble fraction is ``(S - 1) / (n_mb + S - 1)``.

On a ``DeviceMesh`` stage s runs on mesh coordinate s of the ``stage``
axis, one rank per stage, and each tick's hand-off is the reference's
ring ``perm = [(i, (i + 1) % S)]`` (its ``lax.ppermute``) as one
``dist.batch_isend_irecv`` of a send to the next stage and a receive from
the one before.  The outputs are broadcast from the last stage by an
all-reduce sum over the stage axis, exact because every other stage
holds zeros (the reference's ``psum``).  With an int in the mesh's place,
or a mesh of one stage, the S stages run in turn on this device inside
the same wavefront, the hand-off indexing a list.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .. import tree
from .api import is_distributed


def stage_params(params_stacked, s: int):
    """Stage ``s``'s slice of a tree whose leaves lead with the stage
    axis (views)."""
    return tree.map(lambda a: a[s], params_stacked)


def drain_index(t: int, n_stages: int) -> int:
    """The microbatch the last stage finishes at tick ``t``."""
    return t - (n_stages - 1)


def pipeline_apply(stage_fn: Callable, params_stacked, x_microbatches,
                   mesh, axis: str = "stage"):
    """``y = stage_{S-1}(...stage_0(x))`` for every microbatch, as the
    GPipe wavefront.

    stage_fn(stage_params, h) -> h       (same shape in and out)
    params_stacked: a tree with leading dim S (plain tensors, every rank
        holding the stack, or DTensors sharded over ``axis``)
    x_microbatches: ``[n_mb, mb, ...]``, the same on every rank
    mesh: a ``DeviceMesh`` with an ``axis`` of S ranks, or the number of
        stages S to run in turn on this device
    returns: ``[n_mb, mb, ...]``, the last stage's outputs (on every rank)
    """
    if isinstance(mesh, int):
        return _one_device(stage_fn, params_stacked, x_microbatches, mesh)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    if S == 1:
        n = tree.leaves(params_stacked)[0].shape[0]
        return _one_device(stage_fn, _local_stack(params_stacked),
                           x_microbatches, n)
    return _on_mesh(stage_fn, params_stacked, x_microbatches, mesh, axis, S)


def _local_stack(params_stacked):
    """The stack with DTensor leaves as their local tensors."""
    return tree.map(lambda a: a.to_local() if is_distributed(a) else a,
                    params_stacked)


def _on_mesh(stage_fn, params_stacked, xs, mesh, axis: str, S: int):
    """The wavefront with stage s on rank s of ``axis``."""
    group = mesh.get_group(axis)
    sid = mesh.get_local_rank(axis)
    nxt = dist.get_global_rank(group, (sid + 1) % S)
    prv = dist.get_global_rank(group, (sid - 1) % S)
    p = tree.map(lambda a: a.to_local()[0] if is_distributed(a) else a[sid],
                 params_stacked)
    n_mb = xs.shape[0]
    h = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(n_mb + S - 1):
        if sid <= t < sid + n_mb:
            h_out = stage_fn(p, xs[t] if sid == 0 else h)
        else:
            h_out = h
        if sid == S - 1 and t >= S - 1:
            outs[drain_index(t, S)] = h_out
        h = torch.empty_like(h_out)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, h_out.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, h, prv, group)]):
            req.wait()
    dist.all_reduce(outs, group=group)
    return outs


def _one_device(stage_fn, params_stacked, x_microbatches, n_stages: int):
    """The wavefront with the stages in turn on this device."""
    S = n_stages
    n_mb = x_microbatches.shape[0]
    params = [stage_params(params_stacked, s) for s in range(S)]
    # what each stage holds at the start of a tick (its last output)
    held = [torch.zeros_like(x_microbatches[0]) for _ in range(S)]
    outs = torch.zeros_like(x_microbatches)
    for t in range(n_mb + S - 1):
        sent = []
        for s in range(S):
            if s <= t < s + n_mb:
                # stage 0 injects microbatch t; the others take what the
                # stage before them handed on at the end of the last tick
                h_in = x_microbatches[t] if s == 0 else held[s]
                h_out = stage_fn(params[s], h_in)
            else:
                h_out = held[s]
            if s == S - 1 and t >= S - 1:
                outs[drain_index(t, S)] = h_out
            sent.append(h_out)
        # hand each activation to the next stage (the ring's wrap into
        # stage 0 is never read: stage 0 always injects)
        held = [sent[(s - 1) % S] for s in range(S)]
    return outs


def bubble_fraction(n_microbatches: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
