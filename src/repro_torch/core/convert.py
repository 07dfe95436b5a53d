"""Carry a netlist across packages as plain data.

A netlist is the CAD flow's state, as weights are a model's.  The JAX
package's ``Netlist`` and this package's are different classes, so a
netlist crosses as a plain dict of its defining fields; :func:`netlist_from_state`
rebuilds the port's :class:`~repro_torch.core.netlist.Netlist` from it,
including the derived ``driver`` map and the structural-hash caches, and
:func:`netlist_state` is the inverse.  The content digest survives the
round trip.
"""
from __future__ import annotations

from .netlist import Chain, Netlist


def netlist_state(net) -> dict:
    """The defining fields of a netlist (this package's or any object with
    the same attributes) as plain Python data.  Chains are
    ``(a, b, sums, cin, cout)`` tuples."""
    return {
        "name": net.name,
        "n_signals": int(net.n_signals),
        "pis": [int(s) for s in net.pis],
        "pi_buses": {k: [int(s) for s in v] for k, v in net.pi_buses.items()},
        "pos": {k: [int(s) for s in v] for k, v in net.pos.items()},
        "lut_inputs": [tuple(int(s) for s in ins) for ins in net.lut_inputs],
        "lut_tt": [int(t) for t in net.lut_tt],
        "lut_out": [int(s) for s in net.lut_out],
        "chains": [(list(c.a), list(c.b), list(c.sums), int(c.cin),
                    None if c.cout is None else int(c.cout))
                   for c in net.chains],
    }


def netlist_from_state(state: dict) -> Netlist:
    """Rebuild a :class:`Netlist` from :func:`netlist_state`'s dict, with
    its ``driver`` map and structural-hash caches (the last node of a
    duplicate key wins, as in the netlist rebuilds of ``Netlist.sweep``
    and ``techmap``)."""
    net = Netlist(state["name"])
    net.n_signals = int(state["n_signals"])
    net.pis = [int(s) for s in state["pis"]]
    net.pi_buses = {k: [int(s) for s in v]
                    for k, v in state["pi_buses"].items()}
    net.pos = {k: [int(s) for s in v] for k, v in state["pos"].items()}
    net.lut_inputs = [tuple(int(s) for s in ins)
                      for ins in state["lut_inputs"]]
    net.lut_tt = [int(t) for t in state["lut_tt"]]
    net.lut_out = [int(s) for s in state["lut_out"]]
    net.chains = [Chain(a=[int(s) for s in a], b=[int(s) for s in b],
                        sums=[int(s) for s in sums], cin=int(cin),
                        cout=None if cout is None else int(cout))
                  for a, b, sums, cin, cout in state["chains"]]
    for i, s in enumerate(net.pis):
        net.driver[s] = ("pi", i)
    for idx, (ins, tt, out) in enumerate(zip(net.lut_inputs, net.lut_tt,
                                             net.lut_out)):
        net._lut_cache[(ins, tt)] = idx
        net.driver[out] = ("lut", idx)
    for ci, ch in enumerate(net.chains):
        net._chain_cache[(tuple(ch.a), tuple(ch.b), ch.cin)] = ci
        for bi, s in enumerate(ch.sums):
            net.driver[s] = ("chain", ci, bi)
        if ch.cout is not None:
            net.driver[ch.cout] = ("cout", ci)
    return net
