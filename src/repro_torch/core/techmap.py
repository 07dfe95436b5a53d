"""ABC-lite technology mapping: collapse LUT logic into larger LUTs.

The paper emits compressor boolean equations as fine-grained gates and lets
ABC pack them into LUTs (§IV, *Compressor Tree Synthesis*).  We model the two
dominant ABC behaviours:

1. substitute a fan-out-1 LUT into its single consumer while the merged
   support stays within ``max_k`` inputs (topological order lets whole cones
   collapse bottom-up);
2. *duplicate* a small LUT into **all** of its consumers when each can absorb
   it — the classic compressor-tree case: an AND partial product feeding both
   the XOR3 (sum) and MAJ3 (carry) of a full adder merges into both, turning
   FA+ANDs into two 5-LUTs and retiring the AND.
"""
from __future__ import annotations

from collections import defaultdict

from .netlist import CONST1, MAX_LUT_K, Netlist, tt_compose, tt_reduce


def techmap(net: Netlist, max_k: int = MAX_LUT_K) -> Netlist:
    # fanout over LUT outputs (consumers: luts, chains, POs)
    fanout = defaultdict(int)
    for ins in net.lut_inputs:
        for s in ins:
            fanout[s] += 1
    for ch in net.chains:
        for s in list(ch.a) + list(ch.b):
            fanout[s] += 1
        if ch.cin > CONST1:
            fanout[ch.cin] += 1
    for bus in net.pos.values():
        for s in bus:
            fanout[s] += 1

    drv_lut: dict[int, int] = {net.lut_out[i]: i for i in range(net.n_luts)}

    # working defs, mutated as we collapse
    defs: dict[int, tuple[tuple[int, ...], int]] = {
        i: (net.lut_inputs[i], net.lut_tt[i]) for i in range(net.n_luts)
    }
    dead: set[int] = set()

    # topo order over LUT nodes only
    order = [idx for kind, idx in net.topo_order() if kind == "lut"]

    for vi in order:
        if vi in dead:
            continue
        changed = True
        while changed:
            changed = False
            ins, tt = defs[vi]
            best = None
            for pin, s in enumerate(ins):
                ui = drv_lut.get(s)
                if ui is None or ui in dead or fanout[s] != 1:
                    continue
                u_ins, _ = defs[ui]
                merged = set(ins) - {s} | set(u_ins)
                if len(merged) <= max_k:
                    if best is None or len(merged) < best[0]:
                        best = (len(merged), pin, s, ui)
            if best is not None:
                _, pin, s, ui = best
                u_ins, u_tt = defs[ui]
                new_ins, new_tt = tt_compose(tt, ins, pin, u_tt, u_ins)
                new_ins, new_tt = tt_reduce(new_ins, new_tt)
                defs[vi] = (tuple(new_ins), new_tt)
                dead.add(ui)
                # support may have changed; update fanouts conservatively
                for q in u_ins:
                    pass  # counts retained; merges are guarded by fanout==1
                changed = True

    # --- pass 2: duplication into all consumers -----------------------------
    # (only LUT consumers; nodes feeding chains/POs stay put)
    chain_or_po_sigs: set[int] = set()
    for ch in net.chains:
        chain_or_po_sigs.update(ch.a)
        chain_or_po_sigs.update(ch.b)
        chain_or_po_sigs.add(ch.cin)
    for bus in net.pos.values():
        chain_or_po_sigs.update(bus)

    for _round in range(4):
        # consumer index over live defs
        consumers: dict[int, list[int]] = {}
        for vi in order:
            if vi in dead:
                continue
            for s in defs[vi][0]:
                consumers.setdefault(s, []).append(vi)
        changed_any = False
        for ui in order:
            if ui in dead:
                continue
            u_out = net.lut_out[ui]
            u_ins, u_tt = defs[ui]
            if len(u_ins) > 3 or u_out in chain_or_po_sigs:
                continue
            cons = consumers.get(u_out, [])
            if not cons or len(cons) > 4:
                continue
            # all consumers must absorb u
            plans = []
            ok = True
            for vi in cons:
                if vi in dead or vi == ui:
                    ok = False
                    break
                v_ins, v_tt = defs[vi]
                merged = set(v_ins) - {u_out} | set(u_ins)
                if len(merged) > max_k:
                    ok = False
                    break
                plans.append(vi)
            if not ok or not plans:
                continue
            for vi in plans:
                v_ins, v_tt = defs[vi]
                while u_out in v_ins:
                    pin = v_ins.index(u_out)
                    n_ins, n_tt = tt_compose(v_tt, v_ins, pin, u_tt, u_ins)
                    n_ins, n_tt = tt_reduce(n_ins, n_tt)
                    v_ins, v_tt = tuple(n_ins), n_tt
                defs[vi] = (v_ins, v_tt)
            dead.add(ui)
            changed_any = True
        if not changed_any:
            break

    # rebuild netlist
    out = Netlist(net.name)
    out.n_signals = net.n_signals
    out.pis = list(net.pis)
    out.pi_buses = dict(net.pi_buses)
    for s in net.pis:
        out.driver[s] = net.driver[s]
    for vi in order:
        if vi in dead:
            continue
        ins, tt = defs[vi]
        idx = len(out.lut_out)
        out.lut_inputs.append(tuple(ins))
        out.lut_tt.append(tt)
        out.lut_out.append(net.lut_out[vi])
        out.driver[net.lut_out[vi]] = ("lut", idx)
        out._lut_cache[(tuple(ins), tt)] = idx
    for ci, ch in enumerate(net.chains):
        out.chains.append(ch)
        out._chain_cache[(tuple(ch.a), tuple(ch.b), ch.cin)] = ci
        for bi, s in enumerate(ch.sums):
            out.driver[s] = ("chain", ci, bi)
        if ch.cout is not None:
            out.driver[ch.cout] = ("cout", ci)
    out.pos = {k: list(v) for k, v in net.pos.items()}
    return out
