"""Structural netlist edits with stable indices (the port of
``repro/core/edits.py``, copied).

The incremental-repack contract (``core/repack.py``) is defined over
*index-stable* edits: the edited netlist must keep every signal id, LUT
index and chain index of its base so that a dirty set is meaningful.
:class:`repro_torch.core.netlist.Netlist` can't express that through its
public builders — ``add_lut`` canonicalizes through ``tt_reduce`` and
structural hashing, so re-building an edited circuit renumbers
everything.  This module provides the sanctioned mutators instead:
:func:`clone_netlist` copies a netlist field-by-field (bypassing the
hash-consing caches' rebuild), and the ``edit_*`` operators patch one
node while keeping the driver map and hash caches coherent.

Edit classes map onto repack paths as follows:

=====================  ==============================================
edit                   repack path
=====================  ==============================================
``edit_lut_tt``        tt-only: prefix shared, advised replay all-skip
``edit_rewire_fanin``  incremental: dirty-set replay (non-absorbed LUT)
``edit_add_lut``       full fallback (signal/LUT count changed)
``edit_remove_lut``    full fallback (LUT indices shifted)
``edit_extend_chain``  full fallback (chain shape changed)
=====================  ==============================================

Every operator returns the signal/index it touched so callers (fuzz
stream, serve benchmark) can chain edits; all of them keep the netlist
valid for ``pack()`` — acyclic, driver-complete, hash caches in sync.
"""
from __future__ import annotations

from .circuit_ir import levelize
from .netlist import CONST1, Chain, Netlist


def clone_netlist(net: Netlist) -> Netlist:
    """Deep-copy a netlist preserving every index — the base for an
    in-place structural edit.  Field-level copy, not re-construction:
    ``add_lut`` would canonicalize and hash-cons, renumbering nodes."""
    c = Netlist.__new__(Netlist)
    c.name = net.name
    c.n_signals = net.n_signals
    c.pis = list(net.pis)
    c.pi_buses = {k: list(v) for k, v in net.pi_buses.items()}
    c.pos = {k: list(v) for k, v in net.pos.items()}
    c.lut_inputs = list(net.lut_inputs)
    c.lut_tt = list(net.lut_tt)
    c.lut_out = list(net.lut_out)
    c.chains = [Chain(list(ch.a), list(ch.b), list(ch.sums), ch.cin,
                      ch.cout) for ch in net.chains]
    c._lut_cache = dict(net._lut_cache)
    c._chain_cache = dict(net._chain_cache)
    c.driver = dict(net.driver)
    return c


def _uncache_lut(net: Netlist, li: int) -> None:
    key = (net.lut_inputs[li], net.lut_tt[li])
    if net._lut_cache.get(key) == li:
        del net._lut_cache[key]


def _recache_lut(net: Netlist, li: int) -> None:
    key = (net.lut_inputs[li], net.lut_tt[li])
    net._lut_cache.setdefault(key, li)


def safe_rewire_sources(net: Netlist, li: int) -> list[int]:
    """Signals LUT ``li`` may legally take as an input: anything whose
    topological level is strictly below the LUT's output level (hence
    provably not in its transitive fanout) and not a constant."""
    _, _, sig_level = levelize(net)
    lv = sig_level.get(net.lut_out[li], 0)
    return [s for s in range(2, net.n_signals)
            if sig_level.get(s, 0) < lv and s in net.driver]


def edit_rewire_fanin(net: Netlist, li: int, pin: int,
                      new_sig: int) -> int:
    """Repoint pin ``pin`` of LUT ``li`` at ``new_sig`` in place.  The
    caller guarantees acyclicity (see :func:`safe_rewire_sources`)."""
    ins = net.lut_inputs[li]
    if not 0 <= pin < len(ins):
        raise IndexError(f"lut {li} has no pin {pin}")
    if new_sig >= net.n_signals or new_sig <= CONST1:
        raise ValueError(f"bad rewire target {new_sig}")
    _uncache_lut(net, li)
    net.lut_inputs[li] = ins[:pin] + (new_sig,) + ins[pin + 1:]
    _recache_lut(net, li)
    return net.lut_out[li]


def edit_lut_tt(net: Netlist, li: int, new_tt: int) -> int:
    """Replace LUT ``li``'s truth table in place (same support shape).
    Pack-irrelevant: ``pack_digest`` is unchanged."""
    k = len(net.lut_inputs[li])
    new_tt &= (1 << (1 << k)) - 1
    _uncache_lut(net, li)
    net.lut_tt[li] = new_tt
    _recache_lut(net, li)
    return net.lut_out[li]


def edit_add_lut(net: Netlist, inputs, tt: int,
                 po_bus: str = "__edit_taps") -> int:
    """Append a fresh LUT node (no canonicalization, no hash-cons hit)
    and tap it onto ``po_bus`` so it stays live through equivalence."""
    inputs = tuple(inputs)
    if not inputs or any(s >= net.n_signals for s in inputs):
        raise ValueError("bad LUT inputs")
    out = net.new_sig()
    li = len(net.lut_out)
    net.lut_inputs.append(inputs)
    net.lut_tt.append(tt & ((1 << (1 << len(inputs))) - 1))
    net.lut_out.append(out)
    net.driver[out] = ("lut", li)
    _recache_lut(net, li)
    net.pos.setdefault(po_bus, []).append(out)
    return li


def edit_remove_lut(net: Netlist, li: int) -> int:
    """Delete LUT ``li``; it must be dead (no consumer, no PO).  Shifts
    every higher LUT index down by one and remaps the driver table; the
    orphaned output signal keeps its id but loses its driver."""
    out = net.lut_out[li]
    for ins in net.lut_inputs:
        if out in ins:
            raise ValueError(f"lut {li} has LUT fanout")
    for ch in net.chains:
        if out in ch.a or out in ch.b or out == ch.cin:
            raise ValueError(f"lut {li} feeds a chain")
    if any(out in bus for bus in net.pos.values()):
        raise ValueError(f"lut {li} is a primary output")
    _uncache_lut(net, li)
    del net.lut_inputs[li], net.lut_tt[li], net.lut_out[li]
    del net.driver[out]
    net._lut_cache = {k: (v - 1 if v > li else v)
                      for k, v in net._lut_cache.items() if v != li}
    for s, drv in list(net.driver.items()):
        if drv[0] == "lut" and drv[1] > li:
            net.driver[s] = ("lut", drv[1] - 1)
    return out


def edit_extend_chain(net: Netlist, ci: int, a_sig: int, b_sig: int,
                      po_bus: str = "__edit_taps") -> int:
    """Grow chain ``ci`` by one full-adder bit fed by ``a_sig``/``b_sig``
    (which must not depend on the chain — callers pick PIs or upstream
    signals) and tap the new sum bit as a PO."""
    ch = net.chains[ci]
    old_key = (tuple(ch.a), tuple(ch.b), ch.cin)
    if net._chain_cache.get(old_key) == ci:
        del net._chain_cache[old_key]
    s = net.new_sig()
    ch.a.append(a_sig)
    ch.b.append(b_sig)
    ch.sums.append(s)
    net.driver[s] = ("chain", ci, len(ch.sums) - 1)
    net._chain_cache.setdefault((tuple(ch.a), tuple(ch.b), ch.cin), ci)
    net.pos.setdefault(po_bus, []).append(s)
    return s
