"""Sharding-constraint side channel (the port of ``repro/parallel/api.py``).

Model code may name a distribution-critical intermediate,
``constrain(x, "moe_dispatch")``; a launcher installs a rule table mapping
those names to specs (:func:`repro_torch.parallel.sharding.activation_rules`)
with :func:`sharding_rules`.  On a mesh the named tensor is a DTensor,
and :func:`constrain` redistributes it to the rule's placements (the
counterpart of ``jax.lax.with_sharding_constraint``).  Outside any rule
table, for a name no rule names, or on a plain tensor (one device) it
returns ``x`` unchanged, so the models run as they are on one card.

Every placement a gradient takes at a boundary the port draws is named
here, not left to the installed torch's defaults (which changed between
releases: 2.13 makes a ``Partial`` value's gradient ``Replicate``, older
releases kept it ``Partial`` and refused to reach it from a shard):
:func:`redistribute` and :func:`constrain` pin the gradient, and
:func:`local_map` runs a function on each rank's local tensors with the
gradients of its inputs and outputs placed as it says.  No gradient is
ever asked to become ``Partial``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def current_rules() -> dict | None:
    """The rule table installed on this thread, or None."""
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: dict):
    """Install ``rules`` for the ``with`` block (on this thread), then
    restore the table that was there before."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def is_distributed(t) -> bool:
    """Whether ``t`` is a DTensor (a tensor placed on a mesh)."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def on_mesh(leaves):
    """A context for arithmetic on mesh tensors: when any of ``leaves``
    is a DTensor, plain tensors met inside (positions, masks, step
    counts, learning rates, made alike on every rank) count as replicated
    over the mesh; otherwise nothing."""
    if any(is_distributed(t) for t in leaves):
        from torch.distributed.tensor.experimental import \
            implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def like(t, ref):
    """``t`` redistributed to the placements of ``ref`` when both are
    DTensors (a gradient to its parameter's, a new optimizer statistic to
    the one it replaces); otherwise ``t``."""
    if not (is_distributed(t) and is_distributed(ref)):
        return t
    if tuple(t.placements) == tuple(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def write_into(dst, src) -> None:
    """``dst.copy_(src)`` in place; on a mesh each rank copies into its
    own shard of ``dst`` from ``src`` (a DTensor on the same mesh) laid
    out as ``dst`` is."""
    if not is_distributed(dst):
        dst.copy_(src)
        return
    src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def plain(t):
    """A DTensor as the whole tensor on this rank (gathered if it is
    sharded, reduced if it is partial); a plain tensor as it is."""
    return t.full_tensor() if is_distributed(t) else t


def grad_placements(placements) -> tuple:
    """The placements of the gradient of a value placed so: each
    ``Partial`` made ``Replicate`` (a rank's term of a partial sum has the
    sum's whole gradient as its own), the others kept."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() else p for p in placements)


def _local(t):
    """A DTensor's local tensor, waited on when a collective made it."""
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor

    t = t.to_local()
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _moved(t, mesh, placements):
    """``t`` (a DTensor) at ``placements``, outside autograd."""
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(mesh, placements)


class _Redistribute(torch.autograd.Function):
    """A DTensor moved to ``placements``; its gradient moved to
    ``grads``."""

    @staticmethod
    def forward(ctx, x, placements, grads):
        ctx.mesh, ctx.grads = x.device_mesh, grads
        out = _moved(x, x.device_mesh, placements)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, g):
        if g is None or not is_distributed(g):
            return g, None, None
        return _moved(g, ctx.mesh, ctx.grads), None, None


def redistribute(x, placements, grads=None):
    """A DTensor ``x`` at ``placements`` on its own mesh, its gradient at
    ``grads`` (by default ``x``'s own placements, a partial sum's made
    replicated: :func:`grad_placements`); without autograd, the move
    alone."""
    placements = tuple(placements)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _moved(x, x.device_mesh, placements)
    grads = grad_placements(x.placements if grads is None else grads)
    return _Redistribute.apply(x, placements, grads)


class _Enter(torch.autograd.Function):
    """A DTensor's local tensor at ``placements``; the local gradient
    taken as placed at ``grads`` and moved to the DTensor's own placements
    (:func:`grad_placements`)."""

    @staticmethod
    def forward(ctx, x, placements, grads):
        ctx.mesh, ctx.grads = x.device_mesh, grads
        ctx.back = grad_placements(x.placements)
        ctx.shape, ctx.stride = x.shape, x.stride()
        out = _local(_moved(x, x.device_mesh, placements))
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        from torch.distributed.tensor import DTensor

        # contiguous, as a collective's result would be: the producer's
        # backward may view it
        g = DTensor.from_local(g.contiguous(), ctx.mesh, ctx.grads,
                               run_check=False, shape=ctx.shape,
                               stride=ctx.stride)
        return _moved(g, ctx.mesh, ctx.back), None, None


class _Leave(torch.autograd.Function):
    """A local tensor as a DTensor at ``placements``; the gradient moved
    to :func:`grad_placements` of them and taken local."""

    @staticmethod
    def forward(ctx, t, mesh, placements):
        from torch.distributed.tensor import DTensor

        ctx.mesh, ctx.back = mesh, grad_placements(placements)
        return DTensor.from_local(t, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, g):
        if g is not None and is_distributed(g):
            g = _local(_moved(g, ctx.mesh, ctx.back))
        return g, None, None


def whole(x):
    """A DTensor made whole on every rank (its shards gathered, its
    partial sums added), its gradient whole too (a loss's terms, before
    they meet a plain tensor); a plain tensor as it is."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate

    want = (Replicate(),) * x.device_mesh.ndim
    return redistribute(x, want, want)


def reduce_over(t, mesh, dims, op: str = "sum"):
    """A rank's local ``t`` reduced (``op``: ``"sum"`` or ``"avg"``) over
    the ranks of each of ``mesh``'s dimensions ``dims`` in turn, one
    functional all-reduce each (``t`` itself for none), outside
    autograd."""
    from torch.distributed import _functional_collectives as funcol

    for m in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, m)))
    return t


class _AllReduce(torch.autograd.Function):
    """A local tensor summed over mesh dimension ``dim``; its gradient
    summed there too (each rank's copy of the sum feeds its own terms)."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return reduce_over(t, mesh, (dim,))

    @staticmethod
    def backward(ctx, g):
        return reduce_over(g, ctx.mesh, (ctx.dim,)), None, None


def all_reduce(t, mesh, dim: int):
    """A rank's local ``t`` summed over the ranks of ``mesh`` dimension
    ``dim`` (a functional collective), differentiably: for use inside
    :func:`local_map`."""
    return _AllReduce.apply(t, mesh, dim)


def hold(x):
    """``x`` itself, its gradient moved to ``x``'s own placements
    (:func:`grad_placements`) before it meets the gradients of ``x``'s
    other uses, so that they sum at one placement and no layout is left
    to the installed DTensor's choice (a tied embedding table: the
    lookup's gradient and the unembedding's); a plain tensor as it is."""
    return redistribute(x, x.placements) if is_distributed(x) else x


def local_map(fn, out_placements, in_placements, in_grad_placements=None,
              device_mesh=None):
    """``fn`` run on each rank's local tensors: the counterpart of
    ``torch.distributed.tensor.experimental.local_map`` (its inputs
    redistributed to ``in_placements``), with every gradient placed by
    the port.  Each DTensor argument's local gradient is taken as placed
    at ``in_grad_placements`` (``in_placements`` by default; ``Partial``
    where a rank's gradient covers only its own terms) and moved to the
    argument's own placements; each output's gradient is moved to
    :func:`grad_placements` of ``out_placements`` before ``fn``'s
    backward reads it.  ``out_placements`` is a tuple of placement lists
    for a tuple of outputs.  Other arguments pass through."""
    grads = in_grad_placements or in_placements

    def run(*args):
        mesh = device_mesh or next(a.device_mesh for a in args
                                   if is_distributed(a))
        local = [_Enter.apply(a, tuple(p), tuple(g)) if is_distributed(a)
                 else a for a, p, g in zip(args, in_placements, grads)]
        out = fn(*local)
        if isinstance(out, tuple):
            return tuple(_Leave.apply(o, mesh, tuple(p))
                         for o, p in zip(out, out_placements))
        return _Leave.apply(out, mesh, tuple(out_placements))

    return run


def constrain(x, name: str):
    """``x`` redistributed to the placements of the installed rule
    ``name`` on its own mesh (a dimension its axes do not divide, such as
    a decode batch of 1 over ``data``, stays replicated: the same values
    as the reference's padded shards, with no uneven DTensor shards), and
    its gradient there too, as ``jax.lax.with_sharding_constraint``
    constrains the cotangent; ``x`` itself when no rule names ``name`` or
    ``x`` is a plain tensor."""
    rules = current_rules()
    if not rules or name not in rules or not is_distributed(x):
        return x
    from .sharding import placements

    want = placements(rules[name], x.device_mesh, x.shape)
    return redistribute(x, want, want)
