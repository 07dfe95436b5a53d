"""Pipeline parallelism on one card (the port of
``repro/parallel/pipeline.py``): the GPipe wavefront over S stages.

The reference runs stage s on mesh device s, and every tick each stage
applies its layers to what it holds, then hands its activation to the
next stage with ``lax.ppermute``.  Here the S stages run in turn on the
one card inside the same ``n_mb + S - 1``-tick wavefront, with the
reference's rules: stage 0 injects microbatch t at tick t, stage s
computes during ticks ``[s, s + n_mb)`` (outside them it holds what it
had), the last stage drains microbatch ``t - (S - 1)``, and activations
pass from stage to stage by indexing a list in place of the
collective.  The bubble fraction is ``(S - 1) / (n_mb + S - 1)``.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import tree


def stage_params(params_stacked, s: int):
    """Stage ``s``'s slice of a tree whose leaves lead with the stage
    axis (views)."""
    return tree.map(lambda a: a[s], params_stacked)


def drain_index(t: int, n_stages: int) -> int:
    """The microbatch the last stage finishes at tick ``t``."""
    return t - (n_stages - 1)


def pipeline_apply(stage_fn: Callable, params_stacked, x_microbatches,
                   n_stages: int):
    """``y = stage_{S-1}(...stage_0(x))`` for every microbatch, as the
    GPipe wavefront.

    stage_fn(stage_params, h) -> h       (same shape in and out)
    params_stacked: a tree with leading dim ``n_stages``
    x_microbatches: ``[n_mb, mb, ...]``
    returns: ``[n_mb, mb, ...]``, the last stage's outputs
    """
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
