"""Sharding-constraint side channel (the port of ``repro/parallel/api.py``).

Model code may name a distribution-critical intermediate,
``constrain(x, "moe_dispatch")``; a launcher installs a rule table mapping
those names to specs (:func:`repro_torch.parallel.sharding.activation_rules`)
with :func:`sharding_rules`.  The port runs on one card, where a
constraint has nothing to place: :func:`constrain` returns ``x``
unchanged, as the reference's does outside a mesh, so the port's models
leave the calls out (``models/blocks.py``, ``models/lm.py``).
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


def constrain(x, name: str):
    """``x`` itself: on one card a sharding constraint changes nothing,
    whether or not a rule names ``name``."""
    return x
