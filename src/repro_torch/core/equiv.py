"""Physical re-elaboration + equivalence checking for packed circuits.

The paper's area comparison is only meaningful if ``pack()`` produces
*functionally identical* circuits under every architecture — a co-packing or
LUT-absorption bug would silently corrupt every figure while all resource
counters still balance.  This module closes that hole the way the f4pga
repacker does: treat packing as a netlist-to-netlist transform and prove it.

Flow
----
1. :func:`reelaborate` rebuilds a *physical* :class:`Netlist` from a
   :class:`~repro_torch.core.packing.PackedCircuit` by walking every ALM and
   emitting exactly the logic its silicon implements:

   * **absorbed LUTs** — re-composed into the half's adder-side 4-LUT mask
     via :func:`~repro_torch.core.netlist.tt_compose` (the operand path is
     ``wire(LUT(x))``, so the absorbed table is substituted into a buffer);
   * **A–H-fed chain operands** (``fa_feed == "lut"``) — raw operands pass
     through the LUT path as wires, absorbed operands through their
     re-composed masks;
   * **Z-fed chain operands** (``fa_feed == "z"``, DD only) — operands
     bypass the LUTs entirely and connect straight to the adder;
   * **hosted LUTs** and **6-LUT spans** — the concurrent-use masks of
     mode-C halves / whole ALMs.

   Structural illegalities (a Z feed on a baseline ALM, a hosted LUT wider
   than its site, an absorbed LUT that is not 4-input single-fanout…)
   raise :class:`ReElaborationError` — they mean the packer corrupted the
   circuit's structure, not merely its function.

2. :func:`equivalence_report` drives source and physical netlists with the
   same random test-vector lanes (bit-parallel over arbitrary-width python
   ints, or — by default for large circuit pairs, ``use_fused="auto"`` —
   the fused torch engine (:mod:`repro_torch.core.eval_torch`, CUDA
   kernels on the card) over the unified
   :class:`~repro_torch.core.circuit_ir.CircuitIR` lowering, shared with every
   other consumer) and compares every primary output — plus every
   re-elaborated internal signal, so a mismatch localizes to the first
   corrupted node.

3. :func:`symbolic_equivalence_report` is the **per-ALM symbolic fast
   path**: every re-elaborated LUT mask is compared truth-table-to-truth-
   table against the source function (canonicalized over sorted support),
   and every arithmetic half's operand masks are composed into the half's
   sum and carry functions with :func:`~repro_torch.core.netlist.tt_compose` and
   compared directly.  When every cone stays within 6 inputs this proves
   equivalence without simulating a single vector — and a symbolic
   mismatch *localizes* the corrupted node.  Cones wider than 6 inputs
   fall back to lane simulation.

4. :func:`exhaustive_residue_report` closes symbolic residue cones with
   <= 16 support inputs by **full truth-table enumeration**: support
   signals become free variables with ``tt_var`` bit patterns over
   ``2^W`` lanes and both sides' cones evaluate bit-parallel over one
   python int — an exhaustive proof, not a sample.  Only cones wider
   than 16 inputs (or with unmapped leaves) remain for lane simulation —
   the SAT-shaped open item is now wide cones only.

5. :func:`check_pack_equivalence` / :func:`verify_all_archs` are the
   one-call gates used by tests and benchmarks: pack, re-elaborate, prove —
   for baseline, DD5 and DD6, so the A/B area comparison is provably
   apples-to-apples.  The gates run the symbolic fast path first, then
   the exhaustive residue closure, and only simulate what neither pass
   could close.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .alm import ARCHS, ArchParams
from .netlist import (CONST0, CONST1, TT_BUF, TT_MAJ3, TT_XOR3, Netlist,
                      eval_netlist, tt_compose, tt_eval, tt_reduce)
from .packing import PackedCircuit, pack


class ReElaborationError(RuntimeError):
    """The packed structure is physically unrealizable."""


@dataclass
class ReElaboration:
    """A physical netlist plus the source→physical signal correspondence."""

    phys: Netlist
    sig_map: dict[int, int]
    #: source lut idx -> role at its site: "absorbed" | "hosted" | "lut6"
    lut_role: dict[int, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# re-elaboration
# ---------------------------------------------------------------------------


def _lut_site_role(packed: PackedCircuit, li: int):
    """Locate LUT ``li`` in the packed fabric: (alm_idx, role, half)."""
    ai = packed.lut_site.get(li)
    if ai is None:
        raise ReElaborationError(f"LUT {li} has no site")
    alm = packed.alms[ai]
    if alm.lut6 == li:
        return ai, "lut6", None
    for h in alm.halves:
        if h.hosted_lut == li:
            return ai, "hosted", h
        if li in h.absorbed:
            return ai, "absorbed", h
    raise ReElaborationError(f"LUT {li} mapped to ALM {ai} but not present")


def reelaborate(packed: PackedCircuit) -> ReElaboration:
    """Rebuild the physical netlist a :class:`PackedCircuit` implements."""
    src = packed.net
    arch = packed.arch
    phys = Netlist(f"{src.name}@{arch.name}")
    sig_map: dict[int, int] = {CONST0: CONST0, CONST1: CONST1}
    lut_role: dict[int, str] = {}

    for name, bus in src.pi_buses.items():
        nbus = phys.add_pi_bus(name, len(bus))
        for s, ns in zip(bus, nbus):
            sig_map[s] = ns

    def mapped(s: int) -> int:
        try:
            return sig_map[s]
        except KeyError:
            raise ReElaborationError(f"signal {s} used before it is driven")

    def emit_lut(li: int, max_k: int, role: str) -> None:
        ins = src.lut_inputs[li]
        if len(ins) > max_k:
            raise ReElaborationError(
                f"{role} LUT {li} has {len(ins)} inputs > {max_k}")
        # the physical mask is wire∘LUT: substitute the source table into
        # a buffer, exactly what the half's LUT mask is programmed with
        comp_ins, comp_tt = tt_compose(
            TT_BUF, (src.lut_out[li],), 0, src.lut_tt[li], ins)
        out = phys.add_lut([mapped(s) for s in comp_ins], comp_tt)
        sig_map[src.lut_out[li]] = out
        lut_role[li] = role

    def emit_chain(ci: int) -> None:
        ch = src.chains[ci]
        a_ops: list[int] = []
        b_ops: list[int] = []
        for bi in range(len(ch.sums)):
            ai = packed.chain_site.get((ci, bi))
            if ai is None:
                raise ReElaborationError(f"chain bit ({ci},{bi}) has no site")
            half = None
            for h in packed.alms[ai].halves:
                if h.fa == (ci, bi):
                    half = h
                    break
            if half is None:
                raise ReElaborationError(
                    f"chain bit ({ci},{bi}) not in its site ALM {ai}")
            if half.fa_feed == "z":
                if not arch.concurrent:
                    raise ReElaborationError(
                        f"Z feed on non-concurrent arch {arch.name}")
                if half.absorbed:
                    raise ReElaborationError(
                        f"chain bit ({ci},{bi}): Z feed cannot carry "
                        f"absorbed LUT outputs")
                ops = [mapped(ch.a[bi]), mapped(ch.b[bi])]
            elif half.fa_feed == "lut":
                if half.hosted_lut is not None:
                    raise ReElaborationError(
                        f"chain bit ({ci},{bi}): LUT-path feed but the "
                        f"half's LUT hosts an unrelated function")
                # absorbed operands were already re-composed as LUT masks
                # (their mapped signal is the re-composed LUT output); raw
                # operands ride the LUT path as wires — both map directly
                ops = [mapped(ch.a[bi]), mapped(ch.b[bi])]
            else:
                raise ReElaborationError(
                    f"chain bit ({ci},{bi}) has feed {half.fa_feed!r}")
            if packed.alms[ai].lut6 is not None and half.fa_feed != "z":
                raise ReElaborationError(
                    f"chain bit ({ci},{bi}): 6-LUT span requires Z feeds")
            a_ops.append(ops[0])
            b_ops.append(ops[1])
        sums, cout = phys.add_chain(a_ops, b_ops, cin=mapped(ch.cin),
                                    want_cout=ch.cout is not None)
        for bi, s in enumerate(ch.sums):
            sig_map[s] = sums[bi]
        if ch.cout is not None:
            sig_map[ch.cout] = cout

    role_max_k = {"absorbed": 4, "hosted": 5, "lut6": 6}
    for nd in src.topo_order():
        kind, idx = nd
        if kind == "lut":
            ai, role, half = _lut_site_role(packed, idx)
            if role == "absorbed":
                if half.fa is None or half.fa_feed != "lut":
                    raise ReElaborationError(
                        f"absorbed LUT {idx}: half does not feed an FA "
                        f"through the LUT path")
            emit_lut(idx, role_max_k[role], role)
        else:
            emit_chain(idx)

    phys.pos = {name: [mapped(s) for s in bus]
                for name, bus in src.pos.items()}
    return ReElaboration(phys=phys, sig_map=sig_map, lut_role=lut_role)


# ---------------------------------------------------------------------------
# per-ALM symbolic fast path
# ---------------------------------------------------------------------------

# sentinel variable id for the free ripple-carry input of a chain bit;
# signals are >= 0, so negatives never collide
_CARRY_VAR = -1


def _canon(inputs, tt):
    """Canonical (sorted-support, reduced) form of a small boolean cone."""
    inputs, tt = tt_reduce(inputs, tt)
    order = sorted(range(len(inputs)), key=lambda j: inputs[j])
    new_inputs = tuple(inputs[j] for j in order)
    new_tt = 0
    for m in range(1 << len(inputs)):
        asgn = 0
        for nj, oj in enumerate(order):
            if (m >> nj) & 1:
                asgn |= 1 << oj
        if tt_eval(tt, asgn):
            new_tt |= 1 << m
    return new_inputs, new_tt


def _sig_cone(net: Netlist, s: int):
    """A signal as a one-level cone: its driving LUT's (inputs, tt), a
    constant, or itself as a free variable (PIs, chain sums/couts)."""
    if s == CONST0:
        return (), 0
    if s == CONST1:
        return (), 1
    drv = net.driver.get(s)
    if drv is not None and drv[0] == "lut":
        i = drv[1]
        return net.lut_inputs[i], net.lut_tt[i]
    return (s,), TT_BUF


def _compose_half(net: Netlist, a: int, b: int, cin, outer_tt: int):
    """Compose the operand cones of one FA bit into ``outer_tt(a, b, c)``.

    ``cin`` is a signal id for bit 0 or ``_CARRY_VAR`` for the free ripple
    carry.  Raises ValueError when the merged support exceeds 6 inputs —
    the caller falls back to lane simulation for that cone.
    """
    a_ins, a_tt = _sig_cone(net, a)
    b_ins, b_tt = _sig_cone(net, b)
    ins, tt = tt_compose(outer_tt, (-2, -3, cin), 0, a_tt, a_ins)
    pin_b = ins.index(-3)
    ins, tt = tt_compose(tt, ins, pin_b, b_tt, b_ins)
    return _canon(ins, tt)


def _prove_nodes(src: Netlist, re_elab: ReElaboration,
                 lut_scope=None, chain_scope=None):
    """The symbolic per-node proof loop, optionally scoped.

    ``lut_scope`` / ``chain_scope`` restrict the walk to those LUT
    indices / chain indices (``None`` = every node); nodes outside the
    scope are not visited at all.  This is the shared core of the
    full-circuit :func:`symbolic_equivalence_report` and the
    dirty-cluster :func:`verify_clusters` — one proof engine, two
    scopes, so a scoped verdict is by construction the full verdict
    restricted to the scope.  Returns ``(proven_luts, proven_bits,
    fallback, mismatches)``.
    """
    phys, sig_map = re_elab.phys, re_elab.sig_map
    proven_luts = proven_bits = 0
    fallback: list[tuple] = []
    mismatches: list[dict] = []

    def map_support(cone):
        """Re-express a source-space cone in physical signal ids (None when
        some input never got mapped — that cone goes to simulation)."""
        ins, tt = cone
        mapped = []
        for s in ins:
            if s < 0:  # the free carry variable
                mapped.append(s)
            elif s in sig_map:
                mapped.append(sig_map[s])
            else:
                return None
        return _canon(tuple(mapped), tt)

    for nd in src.topo_order():
        kind, idx = nd
        if kind == "lut":
            if lut_scope is not None and idx not in lut_scope:
                continue
            out = src.lut_out[idx]
            p_out = sig_map.get(out)
            want = map_support((src.lut_inputs[idx], src.lut_tt[idx]))
            if p_out is None or want is None:
                fallback.append(nd)
                continue
            # structural hashing may collapse the re-composed mask onto an
            # existing signal or constant — a wire/const `want` proves the
            # node by the mapping itself, no physical LUT to compare
            if (want == ((p_out,), TT_BUF)
                    or (want == ((), 0) and p_out == CONST0)
                    or (want == ((), 1) and p_out == CONST1)
                    or want == _canon(*_sig_cone(phys, p_out))):
                proven_luts += 1
            else:
                mismatches.append({"node": nd, "signal": out,
                                   "phys_signal": p_out, "want": want})
        else:
            if chain_scope is not None and idx not in chain_scope:
                continue
            ch = src.chains[idx]
            p_first = sig_map.get(ch.sums[0])
            drv = phys.driver.get(p_first) if p_first is not None else None
            if drv is None or drv[0] != "chain":
                fallback.append(nd)
                continue
            pch = phys.chains[drv[1]]
            if (len(pch.sums) != len(ch.sums)
                    or any(sig_map.get(s) != ps
                           for s, ps in zip(ch.sums, pch.sums))
                    or (ch.cout is not None
                        and sig_map.get(ch.cout) != pch.cout)):
                fallback.append(nd)
                continue
            for bi in range(len(ch.sums)):
                if bi == 0:
                    cin = sig_map.get(ch.cin, ch.cin)
                    if cin != pch.cin:
                        fallback.append((kind, idx, bi))
                        continue
                else:
                    cin = _CARRY_VAR
                # the half's operands reference the same physical signals on
                # both sides by construction; proving that (the shallow
                # skeleton) plus the per-LUT mask proofs above closes the
                # bit by induction along the carry
                shallow = (sig_map.get(ch.a[bi]) == pch.a[bi]
                           and sig_map.get(ch.b[bi]) == pch.b[bi])
                try:
                    deep = True
                    for outer in (TT_XOR3, TT_MAJ3):
                        want = map_support(_compose_half(
                            src, ch.a[bi], ch.b[bi], ch.cin
                            if bi == 0 else _CARRY_VAR, outer))
                        got = _compose_half(
                            phys, pch.a[bi], pch.b[bi], cin, outer)
                        if want is None:
                            raise ValueError("unmapped cone input")
                        if want != got:
                            deep = False
                            break
                    if deep or shallow:
                        # a deep!=shallow disagreement is a cone-depth
                        # artifact (wire-collapsed operand), not corruption
                        proven_bits += 1
                    else:
                        mismatches.append({
                            "node": (kind, idx, bi),
                            "signal": ch.sums[bi],
                            "phys_signal": pch.sums[bi]})
                except ValueError:  # merged cone support > 6 inputs
                    if shallow:
                        proven_bits += 1
                    else:
                        fallback.append((kind, idx, bi))

    return proven_luts, proven_bits, fallback, mismatches


def _po_ok(src: Netlist, re_elab: ReElaboration) -> bool:
    return all(
        [re_elab.sig_map.get(s) for s in bus] == re_elab.phys.pos.get(name)
        for name, bus in src.pos.items())


def symbolic_equivalence_report(src: Netlist,
                                re_elab: ReElaboration) -> dict:
    """Per-ALM symbolic equivalence: truth tables, not test vectors.

    Walks the source in topo order.  LUT nodes compare their canonical
    cone (inputs mapped into physical ids) against the physical driver's
    cone — this is where re-composed absorption masks are verified bit-for-
    bit.  Chain bits compose both sides' operand masks into the sum
    (``XOR3``) and carry (``MAJ3``) functions with ``tt_compose``; a
    merged support wider than 6 inputs is recorded in ``fallback`` for
    lane simulation instead.  ``equivalent`` is True only when every cone
    was proven and none fell back; a symbolic mismatch names the first
    corrupted source node in ``mismatches``.
    """
    proven_luts, proven_bits, fallback, mismatches = _prove_nodes(
        src, re_elab)
    po_ok = _po_ok(src, re_elab)
    sig_map = re_elab.sig_map
    return {
        "name": src.name,
        "method": "symbolic",
        "proven_luts": proven_luts,
        "proven_chain_bits": proven_bits,
        "fallback": fallback,
        "pos_checked": sum(len(b) for b in src.pos.values()),
        "signals_checked": len(sig_map),
        "mismatches": mismatches,
        "po_ok": po_ok,
        "complete": not fallback and po_ok,
        "equivalent": po_ok and not fallback and not mismatches,
    }


def verify_clusters(packed: PackedCircuit, lb_indices,
                    re_elab: ReElaboration | None = None) -> dict:
    """Verify-after-repack, scoped to the dirty clusters.

    Proves exactly the nodes whose ALMs live in ``lb_indices`` — hosted
    / 6-LUT / absorbed LUT cones and the chain bits sited there —
    through the same symbolic engine as the full-circuit report
    (:func:`_prove_nodes`), so the scoped verdict equals the full
    verdict restricted to the scope.  Re-elaboration itself is global
    (cone supports cross cluster boundaries and the signal map must be
    complete) but is linear and shared: pass ``re_elab`` to amortize it
    across calls, or let the function build it.

    Returns a report shaped like :func:`symbolic_equivalence_report`
    with ``method="symbolic_scoped"`` plus the scope description
    (``lbs``, ``scoped_luts``, ``scoped_chains``).  ``equivalent`` means
    every scoped cone proved with no fallback and the primary outputs
    map cleanly; an incremental repack whose dirty set misses a cluster
    this report would have flagged is exactly the bug class the
    property-fuzz suite hunts (scoped == full restricted to scope).
    """
    src = packed.net
    if re_elab is None:
        re_elab = reelaborate(packed)
    lbs = set(int(x) for x in lb_indices)
    alm_scope = {ai for ai, lb in enumerate(packed.alm_lb) if lb in lbs}
    lut_scope = {li for li, ai in packed.lut_site.items()
                 if ai in alm_scope}
    chain_scope = {ci for (ci, bi), ai in packed.chain_site.items()
                   if ai in alm_scope}
    proven_luts, proven_bits, fallback, mismatches = _prove_nodes(
        src, re_elab, lut_scope=lut_scope, chain_scope=chain_scope)
    po_ok = _po_ok(src, re_elab)
    return {
        "name": src.name,
        "method": "symbolic_scoped",
        "lbs": sorted(lbs),
        "scoped_luts": len(lut_scope),
        "scoped_chains": len(chain_scope),
        "proven_luts": proven_luts,
        "proven_chain_bits": proven_bits,
        "fallback": fallback,
        "mismatches": mismatches,
        "po_ok": po_ok,
        "equivalent": po_ok and not fallback and not mismatches,
    }


# ---------------------------------------------------------------------------
# exhaustive residue closure (cones the symbolic pass cannot close)
# ---------------------------------------------------------------------------

#: widest cone support enumerated exhaustively (2^16 assignments as one
#: bit-parallel python-int evaluation; beyond this, lane simulation remains)
EXHAUSTIVE_MAX_SUPPORT = 16

#: narrowest support for which a residue cone is closed through the
#: vectorized evaluator instead of python-int enumeration: the cone pair
#: is extracted into standalone netlists (support signals -> PIs), lowered
#: through the unified CircuitIR, and evaluated as ``2^W`` packed lanes.
#: The reference measured python ints winning at every width up to
#: :data:`EXHAUSTIVE_MAX_SUPPORT` on its host backend, so the default
#: disables the vector path; pass a lower ``vector_min_support`` to take
#: it (it runs on ``device``).
VECTOR_CONE_MIN_SUPPORT = EXHAUSTIVE_MAX_SUPPORT + 1

#: signal count above which lane simulation routes through the fused torch
#: evaluator by default (``use_fused="auto"``) — big re-elaborations are
#: where the python-int walk dominates equivalence wall time
VECTOR_SIM_MIN_SIGNALS = 4000


def _eval_cone(net: Netlist, targets, var_pat: dict[int, int], mask: int):
    """Bit-parallel evaluation of the cones of ``targets``, treating
    ``var_pat`` signals as free variables (their patterns enumerate every
    assignment).  Returns ``{target: int}``; raises KeyError when a cone
    leaf is neither a constant, a variable, nor a driven signal — that
    cone cannot be closed from this support."""
    val: dict[int, int] = {CONST0: 0, CONST1: mask}
    val.update(var_pat)

    def ev(s: int) -> int:
        if s in val:
            return val[s]
        drv = net.driver[s]        # KeyError -> unclosable leaf
        if drv[0] == "lut":
            i = drv[1]
            ins = [ev(q) for q in net.lut_inputs[i]]
            tt = net.lut_tt[i]
            out = 0
            for m in range(1 << len(ins)):
                if not tt_eval(tt, m):
                    continue
                term = mask
                for j, sv in enumerate(ins):
                    term &= sv if (m >> j) & 1 else (~sv & mask)
                    if term == 0:
                        break
                out |= term
            val[s] = out
            return out
        if drv[0] in ("chain", "cout"):
            ci = drv[1]
            ch = net.chains[ci]
            # ripple only as deep as the requested signal needs: a per-bit
            # residue entry's support covers bits 0..bi only, and deeper
            # bits' operand cones may leave the support entirely
            hi = drv[2] if drv[0] == "chain" else len(ch.sums) - 1
            c = ev(ch.cin)
            for bi in range(hi + 1):
                av, bv = ev(ch.a[bi]), ev(ch.b[bi])
                out = ch.sums[bi]
                if out in var_pat:
                    # the chosen support is not a cut: an enumerated
                    # variable is also an internal node of this cone, so
                    # a consistent valuation does not exist — unclosable
                    raise KeyError(out)
                val[out] = av ^ bv ^ c
                c = (av & bv) | (c & (av ^ bv))
            if drv[0] == "cout" and ch.cout is not None:
                if ch.cout in var_pat:
                    raise KeyError(ch.cout)
                val[ch.cout] = c
            return val[s]
        raise KeyError(s)          # a PI outside the chosen support

    return {t: ev(t) for t in targets}


def _packed_lanes(value: int, n_words: int):
    """A python int's low ``32 * n_words`` bits as uint32 lane words
    (little-endian 32-bit chunks) — the evaluator's vector layout."""
    import numpy as np

    return np.array([(value >> (32 * w)) & 0xFFFFFFFF
                     for w in range(n_words)], dtype=np.uint32)


def _lane_word_mask(n_bits: int, n_words: int):
    """Per-word mask selecting the low ``n_bits`` of an ``n_words``-word
    lane vector (the final word may be partial)."""
    import numpy as np

    mask = np.full(n_words, 0xFFFFFFFF, dtype=np.uint32)
    rem = n_bits - 32 * (n_words - 1)
    if rem < 32:
        mask[-1] = (1 << rem) - 1
    return mask


def _extract_cone_netlist(net: Netlist, targets, support):
    """Extract the cone of ``targets`` over the cut ``support`` into a
    standalone :class:`Netlist` whose PIs are the support signals.

    Mirrors :func:`_eval_cone`'s closure semantics exactly: raises
    ``KeyError`` when a cone leaf is neither a constant, a support
    variable nor a driven signal, and when the chosen support is not a
    cut (an emitted node writes a support signal).  Returns
    ``(mini, sig_map)`` where ``sig_map`` maps original to mini signals.
    """
    mini = Netlist(f"{net.name}.cone")
    pis = mini.add_pi_bus("cut", max(len(support), 1))
    smap: dict[int, int] = {CONST0: CONST0, CONST1: CONST1}
    for s, p in zip(support, pis):
        smap[s] = p
    support_set = set(support)
    chain_depth: dict[int, int] = {}   # emitted ripple depth per chain

    def emit_chain(ci: int, hi: int) -> None:
        ch = net.chains[ci]
        if hi <= chain_depth.get(ci, -1):
            return
        a = [ev(ch.a[b]) for b in range(hi + 1)]
        b_ = [ev(ch.b[b]) for b in range(hi + 1)]
        cin = ev(ch.cin)
        full = hi == len(ch.sums) - 1
        sums, cout = mini.add_chain(a, b_, cin=cin,
                                    want_cout=full and ch.cout is not None)
        for b in range(hi + 1):
            s = ch.sums[b]
            if s in support_set:
                raise KeyError(s)      # support is not a cut
            smap[s] = sums[b]
        if cout is not None:
            if ch.cout in support_set:
                raise KeyError(ch.cout)
            smap[ch.cout] = cout
        chain_depth[ci] = hi

    def ev(s: int) -> int:
        got = smap.get(s)
        if got is not None:
            return got
        drv = net.driver[s]            # KeyError -> undriven leaf
        if drv[0] == "lut":
            # support LUT outputs are pre-seeded into smap (returned as
            # PIs above), so the cut property holds trivially here — only
            # chain-written support signals can break it (emit_chain)
            i = drv[1]
            ins = tuple(ev(q) for q in net.lut_inputs[i])
            out = mini.add_lut(ins, net.lut_tt[i])
            smap[s] = out
            return out
        if drv[0] in ("chain", "cout"):
            ci = drv[1]
            hi = (drv[2] if drv[0] == "chain"
                  else len(net.chains[ci].sums) - 1)
            emit_chain(ci, hi)
            return smap[s]
        raise KeyError(s)              # a PI outside the chosen support

    # deepest-first: residue targets list a chain's sums in increasing
    # bit order, so evaluating in reverse emits each chain once at its
    # max needed depth instead of re-emitting ever-deeper prefixes
    # (emit_chain's depth guard keeps any order correct, just slower)
    for t in reversed(targets):
        ev(t)
    mapped = [smap[t] for t in targets]
    mini.set_po_bus("cone", mapped)
    return mini, smap


def _vector_close_cone(src: Netlist, re_elab: "ReElaboration",
                       support, outs, device=None) -> list:
    """Close one residue cone through the unified vectorized evaluator:
    both sides' cones are extracted into standalone netlists (support
    signals become PIs), lowered via the content-cached CircuitIR, and
    evaluated bit-parallel over all ``2^W`` assignments as packed uint32
    lanes.  Returns the mismatching output signals (source side).

    Raises ``KeyError`` exactly where the python-int enumeration would
    (leaf outside the support / support not a cut) — callers treat that
    as "unclosed" and fall back.
    """
    import numpy as np

    from .eval_torch import eval_netlist_fused
    from .netlist import tt_var

    sig_map, phys = re_elab.sig_map, re_elab.phys
    W = len(support)
    n_words = max(1, (1 << W) // 32)

    def lanes_for(mini):
        return {pi: (_packed_lanes(tt_var(j, W), n_words) if j < W
                     else np.zeros(n_words, dtype=np.uint32))
                for j, pi in enumerate(mini.pis)}

    mini_s, map_s = _extract_cone_netlist(src, outs, support)
    mini_p, map_p = _extract_cone_netlist(
        phys, [sig_map[o] for o in outs], [sig_map[s] for s in support])
    vals_s = eval_netlist_fused(mini_s, lanes_for(mini_s), n_words,
                                device=device)
    vals_p = eval_netlist_fused(mini_p, lanes_for(mini_p), n_words,
                                device=device)
    mask = _lane_word_mask(1 << W, n_words)
    bad = []
    for o in outs:
        d = (vals_s[map_s[o]] ^ vals_p[map_p[sig_map[o]]]) & mask
        if d.any():
            bad.append(o)
    return bad


def _residue_node_spec(src: Netlist, entry):
    """(support signals, output signals) of one symbolic-fallback entry."""
    if entry[0] == "lut":
        ins = [s for s in src.lut_inputs[entry[1]] if s > CONST1]
        return ins, [src.lut_out[entry[1]]]
    ci = entry[1]
    ch = src.chains[ci]
    hi = entry[2] if len(entry) > 2 else len(ch.sums) - 1
    support: list[int] = []
    for s in ([ch.cin] + [ch.a[b] for b in range(hi + 1)]
              + [ch.b[b] for b in range(hi + 1)]):
        if s > CONST1 and s not in support:
            support.append(s)
    outs = [ch.sums[b] for b in range(hi + 1)]
    if ch.cout is not None and hi == len(ch.sums) - 1:
        outs.append(ch.cout)
    return support, outs


def exhaustive_residue_report(src: Netlist, re_elab: ReElaboration,
                              residue,
                              max_support: int = EXHAUSTIVE_MAX_SUPPORT,
                              vector_min_support: int =
                              VECTOR_CONE_MIN_SUPPORT,
                              device=None) -> dict:
    """Close symbolic-fallback cones by full truth-table enumeration.

    Each residue entry (a ``symbolic_equivalence_report`` ``fallback``
    item) is re-checked over *every* assignment of its source-side
    support — an exhaustive proof, not a sample.  Narrow cones evaluate
    bit-parallel over one python int (:func:`_eval_cone`); cones with
    ``>= vector_min_support`` support inputs run through the unified
    vectorized evaluator instead (:func:`_vector_close_cone`: both cones
    extracted into standalone netlists with the support as PIs, lowered
    via the shared CircuitIR, ``2^W`` assignments as packed uint32
    lanes), falling back to python ints if extraction cannot close the
    cone.  Cones wider than ``max_support``, or whose physical cone
    reaches a leaf outside the mapped support, stay open (``unclosed``)
    and fall back to lane simulation exactly as before.
    """
    from .netlist import tt_var

    sig_map, phys = re_elab.sig_map, re_elab.phys
    proven = 0
    vector_cones = 0
    unclosed: list = []
    mismatches: list[dict] = []
    for entry in residue:
        support, outs = _residue_node_spec(src, entry)
        W = len(support)
        if (W > max_support or any(s not in sig_map for s in support)
                or any(o not in sig_map for o in outs)):
            unclosed.append(entry)
            continue
        bad = None
        if W >= vector_min_support:
            try:
                bad = _vector_close_cone(src, re_elab, support, outs,
                                         device=device)
                vector_cones += 1
            except KeyError:
                # extraction could not close the cone — the python-int
                # path handles it
                bad = None
        if bad is None:
            mask = (1 << (1 << W)) - 1
            pats = {s: tt_var(j, W) for j, s in enumerate(support)}
            try:
                want = _eval_cone(src, outs, pats, mask)
                got = _eval_cone(
                    phys, [sig_map[o] for o in outs],
                    {sig_map[s]: p for s, p in pats.items()}, mask)
            except KeyError:
                unclosed.append(entry)
                continue
            bad = [o for o in outs if want[o] != got[sig_map[o]]]
        if bad:
            mismatches.append({"node": entry, "signal": bad[0],
                               "phys_signal": sig_map[bad[0]],
                               "support": W})
        else:
            proven += 1
    return {
        "method": "exhaustive",
        "proven_cones": proven,
        "vector_cones": vector_cones,
        "unclosed": unclosed,
        "mismatches": mismatches,
        "max_support": max_support,
    }


# ---------------------------------------------------------------------------
# equivalence checking
# ---------------------------------------------------------------------------


def _resolve_use_fused(use_fused, src: Netlist, phys: Netlist) -> bool:
    """``use_fused="auto"`` routes lane simulation through the fused
    vectorized evaluator (one CircuitIR lowering per side, shared with
    every other consumer) once the circuit pair is big enough for the
    transfer/dispatch overhead to pay off; booleans force either path."""
    if use_fused != "auto":
        return bool(use_fused)
    return src.n_signals + phys.n_signals >= VECTOR_SIM_MIN_SIGNALS


def equivalence_report(src: Netlist, re_elab: ReElaboration,
                       n_vectors: int = 256, seed: int = 0,
                       use_fused: bool | str = "auto",
                       device=None) -> dict:
    """Random-vector equivalence proof over ``n_vectors`` lanes.

    Compares every primary output *and* every mapped internal signal, so a
    failure names the first corrupted source signal.  ``use_fused`` routes
    both sides through the fused torch engine on ``device`` (same lanes,
    uint32 words); otherwise the bit-parallel python oracle runs on
    arbitrary-width ints.  The default ``"auto"`` picks the fused engine
    for large circuit pairs (>= :data:`VECTOR_SIM_MIN_SIGNALS` combined
    signals).
    """
    import random

    rng = random.Random(seed)
    phys, sig_map = re_elab.phys, re_elab.sig_map
    use_fused = _resolve_use_fused(use_fused, src, phys)
    pi_vals = {s: rng.getrandbits(n_vectors) for s in src.pis}
    phys_pi_vals = {sig_map[s]: v for s, v in pi_vals.items()}

    def mismatch_entry(s: int, diff: int) -> dict:
        vec = (diff & -diff).bit_length() - 1
        return {
            "signal": s, "phys_signal": sig_map[s], "vector": vec,
            "pi_assignment": {p: (pi_vals[p] >> vec) & 1 for p in src.pis},
        }

    mismatched: list[dict] = []
    if use_fused:
        import numpy as np

        from .eval_torch import eval_netlist_fused

        n_words = (n_vectors + 31) // 32

        def lanes(vals):
            return {s: _packed_lanes(v, n_words) for s, v in vals.items()}

        gv = eval_netlist_fused(src, lanes(pi_vals), n_words, device=device)
        pv = eval_netlist_fused(phys, lanes(phys_pi_vals), n_words,
                                device=device)
        # vectorized compare of every mapped signal at once; python ints
        # are reconstructed only for the (<= 4 reported) mismatching rows
        idx_src = np.array(sorted(sig_map), dtype=np.int64)
        idx_phys = np.array([sig_map[s] for s in idx_src], dtype=np.int64)
        word_mask = _lane_word_mask(n_vectors, n_words)
        diff_words = (gv[idx_src] ^ pv[idx_phys]) & word_mask[None, :]
        bad_rows = np.nonzero(diff_words.any(axis=1))[0]
        row_of = {int(s): r for r, s in enumerate(idx_src)}
        for r in bad_rows[:4]:
            diff = sum(int(diff_words[r, w]) << (32 * w)
                       for w in range(n_words))
            mismatched.append(mismatch_entry(int(idx_src[r]), diff))
        po_ok = not any(
            diff_words[row_of[s]].any()
            for bus in src.pos.values() for s in bus)
    else:
        src_val = eval_netlist(src, pi_vals, n_vectors)
        phys_val = eval_netlist(phys, phys_pi_vals, n_vectors)
        for s in sorted(sig_map):
            ps = sig_map[s]
            if s not in src_val or ps not in phys_val:
                continue
            if src_val[s] != phys_val[ps]:
                mismatched.append(
                    mismatch_entry(s, src_val[s] ^ phys_val[ps]))
                if len(mismatched) >= 4:
                    break
        po_ok = all(
            src_val[s] == phys_val[sig_map[s]]
            for bus in src.pos.values() for s in bus)
    return {
        "name": src.name,
        "equivalent": po_ok and not mismatched,
        "n_vectors": n_vectors,
        "pos_checked": sum(len(b) for b in src.pos.values()),
        "signals_checked": len(sig_map),
        "mismatches": mismatched,
    }


def assert_equivalent(src: Netlist, re_elab: ReElaboration,
                      n_vectors: int = 256, seed: int = 0,
                      use_fused: bool | str = "auto", device=None) -> dict:
    rep = equivalence_report(src, re_elab, n_vectors=n_vectors, seed=seed,
                             use_fused=use_fused, device=device)
    if not rep["equivalent"]:
        first = rep["mismatches"][0] if rep["mismatches"] else {}
        raise AssertionError(
            f"{src.name}: packed circuit is NOT equivalent "
            f"(first mismatch: {first})")
    return rep


def check_pack_equivalence(net: Netlist, arch: ArchParams, seed: int = 0,
                           n_vectors: int = 256,
                           use_fused: bool | str = "auto",
                           method: str = "auto", device=None,
                           **pack_kwargs) -> dict:
    """Pack ``net`` under ``arch``, re-elaborate, and prove equivalence.

    ``method``: ``"auto"`` runs the per-ALM symbolic fast path first,
    closes any residue cones with <= :data:`EXHAUSTIVE_MAX_SUPPORT`
    support inputs by full truth-table enumeration
    (:func:`exhaustive_residue_report`), and falls back to lane
    simulation only for cones neither pass could close (wide cones — the
    remaining SAT-shaped gap); ``"simulate"`` forces the random-lane
    proof; ``"symbolic"`` returns the symbolic report as-is
    (``equivalent`` is False when incomplete).  ``device`` is where lane
    simulation runs when it takes the fused engine.
    """
    if method not in ("auto", "symbolic", "simulate"):
        raise ValueError(f"unknown equivalence method {method!r}")
    packed = pack(net, arch, seed=seed, **pack_kwargs)
    re_elab = reelaborate(packed)
    if method in ("auto", "symbolic"):
        rep = symbolic_equivalence_report(net, re_elab)
        if (method == "auto" and not rep["equivalent"] and rep["po_ok"]
                and rep["fallback"] and not rep["mismatches"]):
            ex = exhaustive_residue_report(net, re_elab, rep["fallback"],
                                           device=device)
            rep["exhaustive_proven"] = ex["proven_cones"]
            if ex["mismatches"]:
                rep["mismatches"] = ex["mismatches"]
            else:
                rep["fallback"] = ex["unclosed"]
                if not ex["unclosed"]:
                    rep["method"] = "symbolic+exhaustive"
                    rep["complete"] = True
                    rep["equivalent"] = True
        if method == "auto" and not rep["equivalent"]:
            # incomplete or suspected corruption: the random-lane proof is
            # the authority; keep the symbolic localization alongside
            srep = rep
            rep = equivalence_report(net, re_elab, n_vectors=n_vectors,
                                     seed=seed, use_fused=use_fused,
                                     device=device)
            rep["method"] = "simulate"
            if srep["mismatches"]:
                rep["symbolic_mismatches"] = srep["mismatches"]
    else:
        rep = equivalence_report(net, re_elab, n_vectors=n_vectors,
                                 seed=seed, use_fused=use_fused,
                                 device=device)
        rep["method"] = "simulate"
    rep["arch"] = arch.name
    rep["alms"] = packed.n_alms
    rep["concurrent_luts"] = packed.concurrent_luts
    rep["z_fed_bits"] = sum(
        1 for alm in packed.alms for h in alm.halves
        if h.fa is not None and h.fa_feed == "z")
    return rep


def verify_all_archs(net: Netlist, seed: int = 0, n_vectors: int = 256,
                     use_fused: bool | str = "auto",
                     method: str = "auto", device=None) -> dict[str, dict]:
    """The apples-to-apples gate: prove pack equivalence under every arch."""
    return {name: check_pack_equivalence(net, arch, seed=seed,
                                         n_vectors=n_vectors,
                                         use_fused=use_fused, method=method,
                                         device=device)
            for name, arch in ARCHS.items()}
