"""Sharding-constraint side channel (the port of ``repro/parallel/api.py``).

Model code may name a distribution-critical intermediate,
``constrain(x, "moe_dispatch")``; a launcher installs a rule table mapping
those names to specs (:func:`repro_torch.parallel.sharding.activation_rules`)
with :func:`sharding_rules`.  On a mesh the named tensor is a DTensor,
and :func:`constrain` redistributes it to the rule's placements (the
counterpart of ``jax.lax.with_sharding_constraint``).  Outside any rule
table, for a name no rule names, or on a plain tensor (one device) it
returns ``x`` unchanged, so the models run as they are on one card.
"""
from __future__ import annotations

import contextlib
import threading

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


def constrain(x, name: str):
    """``x`` redistributed to the placements of the installed rule
    ``name`` on its own mesh (a dimension its axes do not divide, such as
    a decode batch of 1 over ``data``, stays replicated: the same values
    as the reference's padded shards, with no uneven DTensor shards);
    ``x`` itself when no rule names ``name`` or ``x`` is a plain
    tensor."""
    rules = current_rules()
    if not rules or name not in rules or not is_distributed(x):
        return x
    from .sharding import placements

    want = placements(rules[name], x.device_mesh, x.shape)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
