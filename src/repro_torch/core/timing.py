"""Static timing + area analysis over a packed circuit.

Levelized longest-path analysis with the Table II path delays.  An edge
is *local* (same LB, through the local feedback + crossbar) or *global*
(fixed inter-LB routing delay); with a grid placement
(:mod:`repro_torch.core.place`) the global leg additionally pays a wire-tier
delay derived from the Manhattan hop distance between the two LB slots
(1-hop / 2-hop / long wires, zero by default so placement-free numbers
are unchanged).  This is deliberately coarser than VPR's timing-driven
router, but it is applied identically to baseline/DD5/DD6 so the
architectural deltas (Z-path vs LUT-path adder feeds, DD6 output-mux
penalty) dominate the comparison, as in the paper.

Two implementations share this recurrence:

* :func:`analyze_oracle` — the original per-signal Python walk, kept
  verbatim as the ground truth; :func:`analyze_placed_oracle` is the
  same walk with the placement-derived wire term, the ground truth for
  placed timing;
* the **vectorized analyzer** (:mod:`repro_torch.core.timing_vec`) — the pack is
  lowered once to the columnar :class:`~repro_torch.core.circuit_ir.CircuitIR`
  and the arrival recurrence runs as levelized array programs (numpy per
  circuit, or a ``lax.scan``/``vmap`` batched jit across circuits x
  architectures for design-space sweeps).  It is bit-identical to the
  oracle — float64, same addition association order, exact max — which
  tests assert for both the unplaced and the placed paths.

:func:`analyze` dispatches (``method="vector"`` default, ``"oracle"`` for
the reference, optional ``placement=``) and accounts every call's wall
time in :data:`TIMING_WALL` so benchmark drivers can report how much of
a figure was spent in static timing.
"""
from __future__ import annotations

import time

from .alm import ArchParams
from .netlist import CONST0, CONST1, Netlist
from .packing import PackedCircuit

#: cumulative static-timing wall clock (seconds) + call count, accounted by
#: :func:`analyze` and by the sweep engine; benchmark sections report the
#: per-section delta (see ``benchmarks/run.py``)
TIMING_WALL = {"s": 0.0, "calls": 0}

#: open :func:`timing_section` scopes (innermost last) — while any scope is
#: open, recordings land in it instead of the global counter, so nested
#: accounting sites (``sweep_suite`` inside a flow wrapper that itself
#: accounts, ``analyze`` inside either) report **once**, not once per layer
_SCOPE_STACK: list[dict] = []


def reset_timing_wall() -> None:
    TIMING_WALL["s"] = 0.0
    TIMING_WALL["calls"] = 0


def read_timing_wall() -> dict:
    return dict(TIMING_WALL)


def record_timing_wall(seconds: float, calls: int = 1) -> None:
    """Account ``seconds`` of static-timing wall clock.

    Scope-aware: inside an open :func:`timing_section` the amount is
    credited to that section (whose eventual single commit already spans
    it) instead of the global counter — the fix for flow paths that
    drive ``sweep_suite`` *and* call :func:`analyze` under one
    accounted region double-counting the shared span."""
    if _SCOPE_STACK:
        _SCOPE_STACK[-1]["s"] += seconds
        _SCOPE_STACK[-1]["calls"] += calls
    else:
        TIMING_WALL["s"] += seconds
        TIMING_WALL["calls"] += calls


class timing_section:
    """Context manager marking one accounted static-timing region.

    ``measure=True`` (default) commits the section's *elapsed wall
    clock* on exit — any ``record_timing_wall`` issued inside (directly
    or by nested sections) is subsumed by that span rather than added on
    top.  ``measure=False`` commits only the amounts explicitly recorded
    inside (for engines like ``sweep_suite`` that account sub-phases and
    exclude packing).  Either way a nested section contributes to its
    parent, and exactly one commit reaches :data:`TIMING_WALL` per
    outermost section — per-section deltas in ``benchmarks/run.py`` are
    therefore non-overlapping by construction (asserted there against
    each section's real elapsed time).
    """

    def __init__(self, calls: int = 0, measure: bool = True):
        self._calls = calls
        self._measure = measure

    def __enter__(self) -> dict:
        self._scope = {"s": 0.0, "calls": self._calls}
        _SCOPE_STACK.append(self._scope)
        self._t0 = time.perf_counter()
        return self._scope

    def __exit__(self, *exc) -> None:
        _SCOPE_STACK.pop()
        dt = time.perf_counter() - self._t0
        s = dt if self._measure else self._scope["s"]
        record_timing_wall(s, self._scope["calls"])


def analyze(packed: PackedCircuit, method: str = "vector",
            placement=None) -> dict:
    """Timing + area record for one packed circuit.

    ``method="vector"`` lowers to CircuitIR and runs the numpy vectorized
    analyzer (bit-identical to the oracle, no per-signal Python walk);
    ``method="oracle"`` runs the original reference implementation.
    With ``placement`` (a :class:`repro_torch.core.place.GridPlacement` of this
    pack) the inter-LB wire-tier term is included on either path.
    """
    with timing_section(calls=1):
        if method == "oracle":
            rec = (analyze_oracle(packed) if placement is None
                   else analyze_placed_oracle(packed, placement))
        elif method == "vector":
            from .circuit_ir import apply_placement
            from .timing_vec import analyze_ir

            ir = packed.lower_ir()
            if placement is not None:
                ir = apply_placement(ir, placement)
            rec = analyze_ir(ir, packed.arch)
        else:
            raise ValueError(f"unknown timing method {method!r}")
    return rec


def analyze_placed_oracle(packed: PackedCircuit, placement) -> dict:
    """Ground-truth placed timing: :func:`analyze_oracle`'s walk with the
    placement-derived wire-tier delay on every inter-LB edge.

    Wire delay is added between the route and pin components (the
    vectorized association order ``(((arrival + route) + wire) + pin) +
    path``) and only when both endpoints are placed in *different* LBs —
    PIs, constants and intra-LB / absorbed edges never touch the fabric
    grid.  At all-zero wire-tier delays this is bit-identical to
    :func:`analyze_oracle` (``x + 0.0 == x``), which tests pin.
    """
    if placement.n_lbs != packed.n_lbs:
        raise ValueError(
            f"{packed.net.name}: placement has {placement.n_lbs} LB slots "
            f"but the pack has {packed.n_lbs} LBs")
    return analyze_oracle(packed, placement)


def analyze_oracle(packed: PackedCircuit, placement=None) -> dict:
    net = packed.net
    arch = packed.arch

    # production site (alm index) per signal; PIs -> -1
    site: dict[int, int] = {}
    for s in net.pis:
        site[s] = -1
    for li, out in enumerate(net.lut_out):
        ai = packed.lut_site.get(li, -2)
        site[out] = ai
    for ci, ch in enumerate(net.chains):
        for bi, s in enumerate(ch.sums):
            site[s] = packed.chain_site.get((ci, bi), -2)
        if ch.cout is not None:
            site[ch.cout] = packed.chain_site.get((ci, len(ch.sums) - 1), -2)

    def lb_of(ai: int) -> int:
        if ai < 0:
            return -1
        return packed.alm_lb[ai]

    arr: dict[int, float] = {CONST0: 0.0, CONST1: 0.0}
    for s in net.pis:
        arr[s] = 0.0

    def edge_in(s: int, dst_lb: int, pin: str) -> float:
        """Arrival of signal s at an ALM input pin in LB dst_lb."""
        t = arr[s]
        src_lb = lb_of(site.get(s, -1))
        if s <= CONST1:
            return 0.0
        if src_lb == dst_lb and src_lb >= 0:
            t += arch.t_route_local
        else:
            t += arch.t_route_global
            if placement is not None and src_lb >= 0 and dst_lb >= 0:
                d = (abs(int(placement.lb_x[src_lb])
                         - int(placement.lb_x[dst_lb]))
                     + abs(int(placement.lb_y[src_lb])
                           - int(placement.lb_y[dst_lb])))
                t += (arch.t_wire_hop1 if d <= 1 else
                      arch.t_wire_hop2 if d == 2 else arch.t_wire_long)
        t += arch.t_lbin_to_z if pin == "z" else arch.t_lbin_to_ah
        return t

    # map (chain,bit) -> half for feed info
    feed: dict[tuple[int, int], tuple[str, list[int]]] = {}
    absorbed_all: set[int] = set()
    for alm in packed.alms:
        for h in alm.halves:
            if h.fa is not None:
                feed[h.fa] = (h.fa_feed, h.absorbed)
                absorbed_all.update(h.absorbed)

    out_extra = arch.t_out_mux_extra

    for nd in net.topo_order():
        kind, idx = nd
        if kind == "lut":
            out = net.lut_out[idx]
            ai = packed.lut_site.get(idx)
            if ai is None:
                # absorbed LUT timing handled at chain; skip (arr set there)
                continue
            dst_lb = lb_of(ai)
            k = len(net.lut_inputs[idx])
            t_in = max((edge_in(s, dst_lb, "ah") for s in net.lut_inputs[idx]
                        if s > CONST1), default=0.0)
            # absorbed LUTs have their delay folded into t_ah_to_adder
            if idx in absorbed_all:
                arr[out] = t_in
            else:
                arr[out] = t_in + arch.lut_delay(k) + arch.t_alm_out + out_extra
        else:
            ch = net.chains[idx]
            carry = 0.0
            if ch.cin > CONST1:
                ai0 = packed.chain_site.get((idx, 0), -2)
                carry = edge_in(ch.cin, lb_of(ai0), "ah") + arch.t_ah_to_adder
            for bi in range(len(ch.sums)):
                ai = packed.chain_site.get((idx, bi), -2)
                dst_lb = lb_of(ai)
                fkind, absorbed = feed.get((idx, bi), ("lut", []))
                ops = [ch.a[bi], ch.b[bi]]
                t_op = 0.0
                absorbed_outs = {net.lut_out[li] for li in absorbed}
                for s in ops:
                    if s <= CONST1:
                        continue
                    if s in absorbed_outs:
                        # operand computed in the half's own LUTs
                        li = next(l for l in absorbed if net.lut_out[l] == s)
                        tin = max((edge_in(q, dst_lb, "ah")
                                   for q in net.lut_inputs[li] if q > CONST1),
                                  default=0.0)
                        t_op = max(t_op, tin + arch.t_ah_to_adder)
                    elif fkind == "z":
                        t_op = max(t_op, edge_in(s, dst_lb, "z")
                                   + arch.t_z_to_adder)
                    else:
                        t_op = max(t_op, edge_in(s, dst_lb, "ah")
                                   + arch.t_ah_to_adder)
                t_here = max(t_op, carry)
                arr[ch.sums[bi]] = t_here + arch.t_sum_out + out_extra
                carry = t_here + arch.t_carry
            if ch.cout is not None:
                arr[ch.cout] = carry + arch.t_sum_out + out_extra

    # absorbed luts that never got arr (dangling) -> 0
    cp = 0.0
    for bus in net.pos.values():
        for s in bus:
            cp = max(cp, arr.get(s, 0.0))
    cp = max(cp, 1.0)

    area = packed.total_area
    return {
        "arch": arch.name,
        "critical_path_ps": cp,
        "fmax_mhz": 1e6 / cp,
        "alms": packed.n_alms,
        "lbs": packed.n_lbs,
        "area_mwta": area,
        "adp": area * cp,
        "adders": net.n_adders,
        "luts": net.n_luts,
        "concurrent_luts": packed.concurrent_luts,
    }


def channel_utilization(packed: PackedCircuit,
                        channel_width: int | None = None) -> list[float]:
    """Per-LB routing-demand proxy for the Fig. 8 congestion histogram.

    Utilization of the channels around an LB is approximated by the number of
    distinct signals crossing its boundary (external inputs + consumed-
    elsewhere outputs) against the channel capacity serving one LB span.
    ``channel_width`` defaults to the arch's routing capacity
    (``ArchParams.channel_width``, 400 tracks on every canonical arch so
    recorded fig8 numbers are reproducible); pass a value to override.
    The placement-derived successor is
    :func:`repro_torch.core.place.channel_congestion`.
    """
    if channel_width is None:
        channel_width = packed.arch.channel_width
    net = packed.net
    util = []
    # signals consumed per LB + reverse index signal -> consuming LBs
    lb_consumes: list[set[int]] = [set() for _ in packed.lbs]
    consumers_of: dict[int, set[int]] = {}
    for lbi in range(len(packed.lbs)):
        for ai in packed.lbs[lbi].alms:
            ah, z = packed.alms[ai].input_signals(net)
            lb_consumes[lbi] |= ah | z
        for s in lb_consumes[lbi]:
            consumers_of.setdefault(s, set()).add(lbi)
    po_sigs = {s for bus in net.pos.values() for s in bus}
    for lbi in range(len(packed.lbs)):
        produced = packed.produced_in_lb(lbi)
        ext_in = lb_consumes[lbi] - produced
        ext_out = {s for s in produced
                   if (consumers_of.get(s, set()) - {lbi}) or s in po_sigs}
        util.append((len(ext_in) + len(ext_out)) / channel_width)
    return util
