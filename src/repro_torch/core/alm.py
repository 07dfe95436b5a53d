"""ALM / logic-block architecture models: baseline Stratix-10-like, DD5, DD6.

Area numbers are the paper's Table I (MWTA = minimum-width transistor areas),
path delays are Table II.  Delays not published (plain LUT logic delay, carry
hop, routing) are free parameters of the model, chosen to land the baseline
suites near the paper's Table III Fmax range and held **identical across
architectures** so relative comparisons are fair.  DD6's extra output-mux
delay models the ~8 % frequency penalty reported in §V-B.

An ALM is modeled as two *halves*; each half owns one 1-bit full adder and
two 4-LUTs (combinable into one 5-LUT).  Modes per half:

* ``R`` (related, all archs) — FA operands arrive through the LUT path; the
  half's LUTs may implement fan-out-1 logic feeding the adder (absorption) or
  act as pass-through wires.  The half's LUT output pins are unusable.
* ``C`` (concurrent, DD only) — FA operands arrive through the Z pins
  (AddMux); the half's LUTs host one *unrelated* <=5-input LUT whose output
  uses the spare output pin (O2/O4).
* logic half — no FA in use; hosts one <=5-input LUT (both archs; a plain
  logic ALM is two such halves, or a single 6-LUT across both halves).

Design-space parameterization
-----------------------------
``ArchParams`` is fully data-driven: the DD features are two integers —
``bypass_inputs`` (Z-path operand inputs per ALM half: 0 = baseline,
2 = DD5/DD6) and ``addmux_fanin`` (the per-Z-pin crossbar mux fan-in;
10/60 inputs = the paper's 17 %-populated AddMux) — plus the
``concurrent_6lut`` flag.  :func:`make_arch` derives everything else
(area model, Z-source budget, delay table) from those knobs, so
``BASELINE``/``DD5``/``DD6`` are literally three rows of an architecture
grid (:func:`arch_grid`) and the DD5-vs-DD6 design-space question
("how many bypass inputs, how much AddMux crossbar") becomes a sweep
axis (see :mod:`repro_torch.core.sweep`).

Two views matter to the rest of the stack:

* :meth:`ArchParams.structural_key` — the pack-affecting fields.  Grid
  points sharing a structural key produce *identical* packs, so a sweep
  packs once per key and re-times many delay rows (delays never affect
  packing).
* :meth:`ArchParams.delay_table` — the Table II + free-parameter delays
  as a flat float64 vector over :data:`DELAY_FIELDS`, the row format the
  vectorized timing analyzer (:mod:`repro_torch.core.timing_vec`) gathers from.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

#: canonical order of the delay parameters inside a delay-table row
DELAY_FIELDS = (
    "t_lbin_to_ah", "t_lbin_to_z", "t_ah_to_adder", "t_z_to_adder",
    "t_lut4", "t_lut5", "t_lut6", "t_carry", "t_sum_out", "t_alm_out",
    "t_out_mux_extra", "t_route_global", "t_route_local",
    "t_wire_hop1", "t_wire_hop2", "t_wire_long",
)


@dataclass(frozen=True)
class ArchParams:
    name: str
    concurrent: bool              # DD5 / DD6: unrelated LUTs in arith ALMs
    concurrent_6lut: bool         # DD6 only
    # per-ALM *tile* area (ALM + its share of crossbars/routing).  Table I
    # gives ALM-only areas (2167.3 -> 2366.6 MWTA) and calls the increase
    # +3.72 % "tile area"; solving (2366.6-2167.3+77.91)/x = 3.72 % puts the
    # baseline tile at ~7452 MWTA/ALM, which we adopt.
    alm_area_mwta: float
    # DD design-space knobs (see module docstring); the canonical DD5/DD6
    # point is (bypass_inputs=2, addmux_fanin=10)
    bypass_inputs: int = 0        # Z-path FA operand inputs per half
    addmux_fanin: int = 10        # crossbar mux fan-in per Z pin (of 60 ins)
    # cluster geometry / budgets
    alms_per_lb: int = 10
    lb_inputs: int = 60
    ext_pin_util: float = 0.9
    direct_link_inputs: int = 40  # LB-to-LB direct wires usable as extra inputs
    lb_outputs: int = 40
    # The AddMux crossbar is 17 % populated: each of the 40 Z pins is a mux
    # with fan-in 10 drawn from the LB's 60 inputs (10/60 crosspoints).  With
    # spread subsets, bipartite matching succeeds until demand nears the pin
    # count, so the budget is one distinct signal per Z pin; Z sources also
    # debit the ordinary LB input budget.  A sparser crossbar (smaller
    # ``addmux_fanin``) supports proportionally fewer distinct sources —
    # :func:`make_arch` derives ``min(lb_outputs, 4 * addmux_fanin)``.
    z_sources: int = 40
    z_local_free: bool = True     # direct-link taps carry neighbouring outputs
    # Table II path delays (ps)
    t_lbin_to_ah: float = 72.61
    t_lbin_to_z: float = 77.05
    t_ah_to_adder: float = 133.4
    t_z_to_adder: float = 68.77
    # model free parameters (ps) — identical across archs
    t_lut4: float = 150.0
    t_lut5: float = 165.0
    t_lut6: float = 180.0
    t_carry: float = 15.0
    t_sum_out: float = 90.0
    t_alm_out: float = 60.0
    t_out_mux_extra: float = 0.0  # DD6 output-mux penalty
    t_route_global: float = 620.0
    t_route_local: float = 160.0
    # routed-fabric model (see repro_torch.core.place): the LB grid the placer
    # legalizes onto and the tiered wire hierarchy an inter-LB edge rides
    # (tile-local / 1-hop / 2-hop / long wires, apicula-style).  Wire-tier
    # delays default to ZERO so the placement-free timing numbers are
    # reproduced bit-for-bit; a routed-fabric grid point sets them.
    grid_aspect: float = 1.0      # W/H aspect of the LB placement grid
    channel_width: int = 400      # routing tracks per channel (Fig. 8 proxy)
    t_wire_hop1: float = 0.0      # extra ps for a 1-hop inter-LB route
    t_wire_hop2: float = 0.0      # extra ps for a 2-hop route
    t_wire_long: float = 0.0      # extra ps for a long-wire (>2 hop) route

    @property
    def input_budget(self) -> int:
        return int(self.lb_inputs * self.ext_pin_util) + int(
            self.direct_link_inputs * self.ext_pin_util
        )

    @property
    def output_budget(self) -> int:
        return self.lb_outputs

    def lut_delay(self, k: int) -> float:
        if k <= 4:
            return self.t_lut4
        if k == 5:
            return self.t_lut5
        return self.t_lut6

    # -- data-driven views ---------------------------------------------------
    def delay_table(self) -> np.ndarray:
        """All delay parameters as a float64 vector over DELAY_FIELDS —
        one row of the batched delay tensor the vectorized timing
        analyzer gathers from."""
        return np.array([getattr(self, f) for f in DELAY_FIELDS],
                        dtype=np.float64)

    def structural_key(self) -> tuple:
        """The pack-affecting fields.  Two archs with equal structural
        keys produce identical ``pack()`` results (delays never steer the
        packer), which is what lets a design-space sweep pack once per
        key and re-time every delay row of the class in one batch."""
        return (self.concurrent, self.concurrent_6lut, self.bypass_inputs,
                self.alms_per_lb, self.lb_inputs, self.ext_pin_util,
                self.direct_link_inputs, self.lb_outputs, self.z_sources,
                self.z_local_free)

    def placement_key(self) -> tuple:
        """The placement-affecting fields: the structural key (it decides
        the pack, hence the LB graph) plus the grid geometry.  Wire-tier
        delays and ``channel_width`` are deliberately absent — the
        analytic placer minimizes wirelength, not timing, so every delay
        row of a class shares one placement (the sweep engine's
        place-once-retime-many contract)."""
        return self.structural_key() + (self.grid_aspect,)


_FIELD_DEFAULTS = {f.name: f.default for f in fields(ArchParams)}

# -- the area/delay model behind make_arch ----------------------------------
_BASE_TILE = 7452.0
#: Table I: the AddMux crossbar's share of the +3.72 % DD5 tile delta,
#: at the canonical (2 bypass inputs x fan-in 10) point
_XBAR_MWTA = 77.91
#: the remaining ALM-internal share (AddMux drivers + output muxing):
#: 0.0372 * 7452 - 77.91, so the canonical point lands exactly on x1.0372
_ALM_BYPASS_MWTA = 0.0372 * _BASE_TILE - _XBAR_MWTA
#: DD6's extra 6-LUT output muxing (estimated): lands exactly on x1.043
_LUT6_MWTA = (1.043 - 1.0372) * _BASE_TILE
#: ps of extra Z-pin mux delay per crossbar input beyond the canonical 10
_T_Z_FANIN_SLOPE = 0.9


def make_arch(name: str, bypass_inputs: int = 0, addmux_fanin: int = 10,
              lut6: bool = False, z_sources: int | None = None,
              **overrides) -> ArchParams:
    """Build an architecture grid point from the DD design-space knobs.

    Everything the packer and timer need is derived:

    * ``concurrent`` = ``bypass_inputs >= 1`` (an FA operand can bypass
      the LUTs at all), ``concurrent_6lut`` = ``lut6``;
    * area: baseline tile + the ALM-internal bypass cost (scales with
      bypass width) + the AddMux crossbar cost (scales with bypass width
      x fan-in) + the DD6 output-mux cost.  The canonical points
      reproduce Table I exactly: (2, 10) -> x1.0372, +lut6 -> x1.043;
    * ``z_sources`` = ``min(lb_outputs, 4 * addmux_fanin)`` — a sparser
      crossbar resolves fewer distinct sources by bipartite matching;
    * delays: with any bypass the LUT-path adder feed pays the AddMux
      (Table II: 133.4 -> 202.2 ps), and the Z-pin mux slows by
      ``_T_Z_FANIN_SLOPE`` ps per crossbar input beyond fan-in 10.

    ``overrides`` are applied last (escape hatch for ablations).
    """
    if bypass_inputs < 0 or bypass_inputs > 2:
        raise ValueError("bypass_inputs must be 0..2 (2 FA operands/half)")
    if lut6 and bypass_inputs < 2:
        raise ValueError("concurrent 6-LUTs require 2 bypass inputs/half")
    concurrent = bypass_inputs >= 1
    w = bypass_inputs / 2.0
    if bypass_inputs == 2 and addmux_fanin == 10:
        # the published Table I points, verbatim (the additive
        # decomposition below reproduces them only to the last ulp)
        area = _BASE_TILE * (1.043 if lut6 else 1.0372)
    else:
        area = _BASE_TILE + w * _ALM_BYPASS_MWTA \
            + w * _XBAR_MWTA * (addmux_fanin / 10.0)
        if lut6:
            area += _LUT6_MWTA
    lb_outputs = overrides.get("lb_outputs", _FIELD_DEFAULTS["lb_outputs"])
    params = dict(
        name=name,
        concurrent=concurrent,
        concurrent_6lut=lut6,
        alm_area_mwta=area,
        bypass_inputs=bypass_inputs,
        addmux_fanin=addmux_fanin,
        z_sources=(min(lb_outputs, 4 * addmux_fanin) if z_sources is None
                   else z_sources),
        t_ah_to_adder=202.2 if concurrent else 133.4,
        t_lbin_to_z=77.05 + _T_Z_FANIN_SLOPE * (addmux_fanin - 10),
        t_out_mux_extra=60.0 if lut6 else 0.0,
    )
    params.update(overrides)
    return ArchParams(**params)


def arch_grid(bypass_inputs=(0, 2), addmux_fanin=(5, 10, 20),
              lut6=(False, True), alms_per_lb=(10,), lb_inputs=(60,),
              ext_pin_util=(0.9,), direct_link_inputs=(40,),
              wire_delays=((0.0, 0.0, 0.0),)) -> list[ArchParams]:
    """The DD design-space grid: bypass width x crossbar population x
    6-LUT concurrency, crossed with the **structural cluster-geometry
    axes** the paper holds fixed at the Stratix-10-like point —
    ``alms_per_lb`` (LB capacity), ``lb_inputs`` (crossbar input pins)
    and ``ext_pin_util`` (usable-pin fraction) — and with the
    **routed-fabric axis** ``wire_delays``: ``(t_wire_hop1, t_wire_hop2,
    t_wire_long)`` tier triples the placement-aware timing path consumes
    (non-structural: every triple of a class shares one pack AND one
    placement).  All extra axes default to singleton canonical values, so
    the historical 7-point grid is unchanged; widening any of them
    multiplies the grid (the incremental repacker in
    :mod:`repro_torch.core.repack` and the placement cache in
    :mod:`repro_torch.core.place` are what keep that affordable).  Infeasible
    corners (lut6 without full bypass) and redundant baseline fan-in
    points are dropped; the canonical baseline/DD5/DD6 rows appear under
    grid names (``b0``, ``b2_f10``, ``b2_f10_l6``) with identical
    parameters; non-canonical points carry
    ``_a<alms>``/``_i<inputs>``/``_u<util%>``/``_w<hop1>`` suffixes."""
    grid: list[ArchParams] = []
    seen: set[tuple] = set()
    for b in bypass_inputs:
        fanins = addmux_fanin if b else (10,)   # no crossbar without bypass
        for f in fanins:
            for l6 in lut6:
                if l6 and b < 2:
                    continue
                for apl in alms_per_lb:
                    for li in lb_inputs:
                        for u in ext_pin_util:
                            for dli in direct_link_inputs:
                                for wd in wire_delays:
                                    w1, w2, wl = wd
                                    name = (f"b{b}" + (f"_f{f}" if b else "")
                                            + ("_l6" if l6 else "")
                                            + (f"_a{apl}" if apl != 10
                                               else "")
                                            + (f"_i{li}" if li != 60 else "")
                                            + (f"_u{round(u * 100)}"
                                               if u != 0.9 else "")
                                            + (f"_d{dli}" if dli != 40
                                               else "")
                                            + (f"_w{round(w1)}" if any(wd)
                                               else ""))
                                    key = (b, f if b else 10, l6, apl, li,
                                           u, dli, wd)
                                    if key in seen:
                                        continue
                                    seen.add(key)
                                    grid.append(make_arch(
                                        name, bypass_inputs=b,
                                        addmux_fanin=f, lut6=l6,
                                        alms_per_lb=apl, lb_inputs=li,
                                        ext_pin_util=u,
                                        direct_link_inputs=dli,
                                        t_wire_hop1=w1, t_wire_hop2=w2,
                                        t_wire_long=wl))
    return grid


def full_arch_grid(wire_delays=((0.0, 0.0, 0.0),)) -> list[ArchParams]:
    """The *entire* DD design-space cross-product — every axis of
    :func:`arch_grid` widened at once:

    bypass (0/1/2) x AddMux fan-in (5/8/10/14/20) x 6-LUT concurrency x
    ``alms_per_lb`` (6/8/10/12/14) x ``lb_inputs`` (40/48/60) x
    ``ext_pin_util`` (0.7/0.8/0.9/1.0) x ``direct_link_inputs`` (20/40)
    = **1920 grid points over 1200 structural classes**.  Fan-ins
    10/14/20 saturate the ``z_sources`` budget, so they pack identically
    and differ only in delay rows — every point is still a distinct
    delay row (fan-in moves the Z-pin mux delay).

    ``wire_delays`` crosses in the wire-tier axis (``_w{n}``-suffixed
    rows per extra profile).  The default keeps it flat: in an unplaced
    sweep all wire rows time identically, padding the point count
    without adding design space.  A *placed* search
    (``search_archs(place=True)``) passes real profiles here — annealed
    placements price the tiers, so the wire rows stop tying and the
    axis becomes searchable.

    This is the search space :mod:`repro_torch.core.search` halves over —
    dense-sweeping it costs ~1200 re-clusterings per circuit, which is
    exactly what the successive-halving driver avoids.
    """
    return arch_grid(
        bypass_inputs=(0, 1, 2),
        addmux_fanin=(5, 8, 10, 14, 20),
        lut6=(False, True),
        alms_per_lb=(6, 8, 10, 12, 14),
        lb_inputs=(40, 48, 60),
        ext_pin_util=(0.7, 0.8, 0.9, 1.0),
        direct_link_inputs=(20, 40),
        wire_delays=wire_delays)


def subgrid(archs, n: int, must_include=("b0", "b2_f10")) -> list[ArchParams]:
    """A deterministic ``n``-point slice of ``archs`` for dense-vs-search
    cost comparisons: evenly strided over the grid order, with the named
    canonical rows (baseline, DD5) forced in so ratios stay anchored."""
    by_name = {a.name: a for a in archs}
    picked: dict[str, ArchParams] = {}
    for name in must_include:
        if name in by_name:
            picked[name] = by_name[name]
    stride = max(1, len(archs) // max(n, 1))
    for a in archs[::stride]:
        if len(picked) >= n:
            break
        picked.setdefault(a.name, a)
    return list(picked.values())


def group_archs_by_structure(archs) -> list[list[int]]:
    """Indices of ``archs`` grouped by structural key (pack-sharing
    classes), preserving first-seen order."""
    groups: dict[tuple, list[int]] = {}
    for i, a in enumerate(archs):
        groups.setdefault(a.structural_key(), []).append(i)
    return list(groups.values())


# canonical paper rows — three points of the grid (checked by tests to land
# exactly on the Table I ratios the seed hard-coded)
BASELINE = make_arch("baseline", bypass_inputs=0)
DD5 = make_arch("dd5", bypass_inputs=2, addmux_fanin=10)
DD6 = make_arch("dd6", bypass_inputs=2, addmux_fanin=10, lut6=True)

ARCHS = {a.name: a for a in (BASELINE, DD5, DD6)}


def get_arch(name: str) -> ArchParams:
    return ARCHS[name]
