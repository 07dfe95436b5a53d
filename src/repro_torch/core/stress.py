"""Stress tests: packing stress (Fig. 9) and end-to-end SHA stress (Table IV).

The packing sweep drives pack → analyze through ``repro_torch.core.flow`` (the
same pipeline the figure benchmarks use); the Table IV capacity sweep uses
``pack`` directly for its capacity probes and analyzes only the packs that
fit — probe packs' metrics would be discarded.
"""
from __future__ import annotations

import random

from .alm import ArchParams
from .netlist import Netlist


def merge_netlists(nets: list[Netlist], name: str = "merged") -> Netlist:
    """Disjoint union of netlists (fresh signal ids per instance)."""
    out = Netlist(name)
    for k, net in enumerate(nets):
        remap: dict[int, int] = {0: 0, 1: 1}

        def m(s: int) -> int:
            if s not in remap:
                remap[s] = out.new_sig()
            return remap[s]

        for bus_name, bus in net.pi_buses.items():
            for s in bus:
                ns = m(s)
                out.pis.append(ns)
                out.driver[ns] = ("pi", len(out.pis) - 1)
            out.pi_buses[f"i{k}_{bus_name}"] = [remap[s] for s in bus]
        for i in range(net.n_luts):
            ins = tuple(m(s) for s in net.lut_inputs[i])
            idx = len(out.lut_out)
            o = m(net.lut_out[i])
            out.lut_inputs.append(ins)
            out.lut_tt.append(net.lut_tt[i])
            out.lut_out.append(o)
            out.driver[o] = ("lut", idx)
        for ch in net.chains:
            from .netlist import Chain

            ci = len(out.chains)
            nch = Chain(a=[m(s) for s in ch.a], b=[m(s) for s in ch.b],
                        sums=[m(s) for s in ch.sums], cin=m(ch.cin),
                        cout=m(ch.cout) if ch.cout is not None else None)
            out.chains.append(nch)
            for bi, s in enumerate(nch.sums):
                out.driver[s] = ("chain", ci, bi)
            if nch.cout is not None:
                out.driver[nch.cout] = ("cout", ci)
        for bus_name, bus in net.pos.items():
            out.pos[f"i{k}_{bus_name}"] = [remap[s] for s in bus]
    return out


def packing_stress_circuit(n_adders: int = 500, n_luts: int = 0,
                           chain_len: int = 20, op_pool: int = 600,
                           lut_pool: int = 200, seed: int = 0,
                           depth: int = 1) -> Netlist:
    """Fig. 9 synthetic circuit: ``n_adders`` FA bits in chains plus
    ``n_luts`` unrelated 5-LUTs with moderately shared inputs.

    ``depth > 1`` stacks further layers whose operands are drawn from the
    previous layer's outputs, with node counts shrinking 3x per layer —
    a wide-then-narrow level profile, the shape on which the fused
    evaluator's width-bucketed plan cuts padding waste (layer 1 is always
    the classic single-level Fig. 9 circuit).
    """
    rng = random.Random(seed)
    net = Netlist("stress" if depth == 1 else f"stress-d{depth}")
    ops = net.add_pi_bus("ops", op_pool)
    lin = net.add_pi_bus("lin", lut_pool)
    layer = 0
    la, ll = n_adders, n_luts
    while layer < depth and (la > 0 or ll > 0):
        next_ops: list[int] = []
        n_chains = (la + chain_len - 1) // chain_len
        done = 0
        for c in range(n_chains):
            L = min(chain_len, la - done)
            if L <= 0:
                break
            a = [ops[rng.randrange(len(ops))] for _ in range(L)]
            b = [ops[rng.randrange(len(ops))] for _ in range(L)]
            sums, _ = net.add_chain(a, b)
            net.set_po_bus(f"s{layer}_{c}", sums)
            next_ops.extend(sums)
            done += L
        for i in range(ll):
            ins = tuple(rng.sample(lin, min(5, len(lin))))
            tt = rng.getrandbits(32)
            o = net.add_lut(ins, tt)
            net.set_po_bus(f"l{layer}_{i}", [o])
            next_ops.append(o)
        layer += 1
        la, ll = la // 3, ll // 3
        if next_ops:
            ops = next_ops
            lin = next_ops if len(next_ops) >= 5 else lin
    return net


def run_packing_stress(arch: ArchParams, n_adders: int = 500,
                       lut_counts=None, seed: int = 0) -> list[dict]:
    """Sweep added-LUT count; report area and concurrent 5-LUTs (Fig. 9)."""
    from .flow import pack_and_analyze_one

    if lut_counts is None:
        lut_counts = list(range(0, 501, 50))
    out = []
    for nl in lut_counts:
        net = packing_stress_circuit(n_adders=n_adders, n_luts=nl, seed=seed)
        _, r = pack_and_analyze_one(net, arch, seed=seed)
        out.append({"n_luts": nl, "area_mwta": r["area_mwta"],
                    "alms": r["alms"], "concurrent": r["concurrent_luts"]})
    return out


def run_e2e_stress(base_net: Netlist, sha_net: Netlist, arch_list,
                   capacity_lbs: int | None = None, seed: int = 0,
                   max_instances: int = 64) -> dict:
    """Table IV: fix the FPGA size (LBs) from the baseline pack of the base
    circuit + margin, then count how many SHA instances each architecture
    can additionally fit."""
    from .packing import pack
    from .timing import analyze

    results = {}
    if capacity_lbs is None:
        # capacity probe: the pack's LB count is all we need — analyzing
        # here (or the final over-capacity pack below) would be wasted
        # work on the sweep's largest circuits
        p0 = pack(base_net, arch_list[0], seed=seed)
        capacity_lbs = int(p0.n_lbs * 1.3) + 1  # industry-style margin
    for arch in arch_list:
        best = None
        k = 0
        while k <= max_instances:
            merged = merge_netlists([base_net] + [sha_net] * k)
            p = pack(merged, arch, seed=seed)
            if p.n_lbs > capacity_lbs:
                break
            best = (k, p, analyze(p))
            k += 1
        if best is None:
            results[arch.name] = {"instances": 0}
            continue
        k, p, r = best
        n5 = sum(1 for ins in p.net.lut_inputs if len(ins) <= 5)
        results[arch.name] = {
            "instances": k,
            "adders": r["adders"],
            "luts5": n5,
            "concurrent": r["concurrent_luts"],
            "cpd_ps": r["critical_path_ps"],
            "alms": r["alms"],
            "lbs": r["lbs"],
            "area_mwta": r["area_mwta"],
        }
    results["capacity_lbs"] = capacity_lbs
    return results
