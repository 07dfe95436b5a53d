"""Unified columnar circuit IR: one lowering serves eval, timing and
equivalence.

The repro used to carry three independent lowering substrates for the
same packed circuit — the evaluator's padded level tensors
(``eval_jax._level_rows``), the timing stack's signal/edge columns
(``pack_ir.lower_ir``) and the equivalence checker's python-int cone
walks.  Each levelized the netlist again and each kept its own cache.
This module collapses them onto one :class:`CircuitIR` with two lowering
stages:

* **functional lowering** (:func:`lower_netlist_ir`) — once per netlist
  *content digest*: topological levelization, per-level LUT rows with
  64-entry truth-table words (``tt_lo``/``tt_hi``) and chain rows with
  their operand/sum/cout signals, per-signal kind/level columns, the
  fanin CSR topology and the primary-output list.  No architecture, no
  placement.  This is everything the fused evaluator and the
  equivalence lanes need, and it is the shared base of every packed
  lowering of the circuit.  Cached in the registry
  (:mod:`repro_torch.core.plan`, cache ``netlist_ir``).
* **placement patch** (:func:`lower_pack_ir` /
  :func:`lower_pack_ir_incremental`) — once per (digest, structural
  class): a vectorized pass that fills in the placement-derived columns
  — per-signal site/LB, per-ALM mode columns, node delay classes
  (absorption) and every edge delay class (routing locality, A–H vs Z
  pin, adder path).  Both entry points run the *same* patch function
  (:func:`_patch_placement`); they differ only in where the
  netlist-shaped arrays come from (the cached functional IR vs a sibling
  class's :class:`CircuitIR` template), so fresh and
  template-incremental lowering are identical column-for-column **by
  construction**.

Column layout
-------------
Per signal (length ``n_signals``): ``sig_site`` (producing ALM; -1 for
PIs/constants; the -2 "unplaced" sentinel survives in the encoding but
an unplaced LUT *raises* at lowering — the level tables carry every LUT,
so a siteless one would corrupt timing, and the packer must place all of
them), ``sig_lb``, ``sig_kind`` (:data:`K_CONST` … :data:`K_COUT`),
``sig_level``.

Fanin CSR: ``fanin_ptr [S+1]`` / ``fanin_sig [E]`` / ``fanin_cls [E]``
(timing edges, excluding the intra-chain carry recurrence; ``fanin_cls``
is all-zero in functional IRs).

Per ALM (length ``n_alms``; empty in functional IRs): ``alm_lb``,
``alm_is_arith``, ``alm_feed [A, 2]`` (0 = no FA, 1 = LUT-path feed,
2 = Z feed), ``alm_hosted [A, 2]``, ``alm_lut6``.

Levelized node tables: ``lut_levels[t]`` / ``chain_levels[t]`` hold
exact-size (unpadded) row arrays per topological level; executors
pad/stack them as their batching needs dictate (the evaluator via
:func:`repro_torch.core.eval_torch.plan_from_ir`, the timing program via
``timing_vec._pad_levels``).  Constant operands are kept **verbatim** in
the signal columns (``ins`` / ``a_sig`` / ``b_sig`` / ``cin_sig``) with
the null edge class 0: the evaluator must read CONST1's all-ones lane,
and the timing executors gather an arrival of 0.0 through signal 0 *or*
1 with zero delay components either way — bit-identical to the oracle's
"skip constants" reductions.

Edge delay classes
------------------
An edge's delay is the sum of three components — routing
(none / local / global), LB input pin (none / A–H / Z) and adder path
(none / A–H→adder / Z→adder) — encoded as ``route * 9 + pin * 3 + path``
(27 classes).  The per-arch component table is built by
:func:`repro_torch.core.timing_vec.delay_components`; classes are structural
(decided at pack time), components are per delay row, which is exactly
the split that makes arch-grid batching a gather.  Class 0 is the null
edge (constants / padding): all components zero.

Node delay classes (``NDC_*``): absorbed LUTs add nothing (their delay
is folded into the A–H→adder path); placed LUTs add
``lut_delay(k) + t_alm_out + t_out_mux_extra``.

Instrumentation
---------------
:data:`LOWER_COUNTS` counts functional lowerings and placement patches
(full vs template); the no-duplicate-lowering property of the sweep
engine is asserted against it in ``tests/core/test_circuit_ir.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from . import plan as _planner
from .netlist import CONST1, Netlist, tt_words64

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (packing lazily
    from .packing import PackedCircuit  # imports this module via lower_ir)

# signal kinds
K_CONST, K_PI, K_LUT, K_LUT_ABS, K_SUM, K_COUT = range(6)

# edge-class components
ROUTE_NULL, ROUTE_LOCAL, ROUTE_GLOBAL = 0, 1, 2
PIN_NULL, PIN_AH, PIN_Z = 0, 1, 2
PATH_NULL, PATH_AH, PATH_Z = 0, 1, 2
N_EDGE_CLASSES = 27

# wire tiers of a placed inter-LB edge (repro_torch.core.place): tier 0 is the
# null/tile-local wire (zero delay — also every edge of an unplaced IR),
# 1-hop and 2-hop wires carry Manhattan-distance-1/-2 routes, and any
# longer route rides one long wire (the 8-hop spans of the apicula-style
# hierarchy cover the grids the suites legalize onto).
TIER_NONE, TIER_HOP1, TIER_HOP2, TIER_LONG = range(4)
N_WIRE_TIERS = 4

# node delay classes for LUT rows
NDC_ABSORBED, NDC_LUT4, NDC_LUT5, NDC_LUT6 = range(4)
N_NODE_CLASSES = 4


def edge_class(route: int, pin: int, path: int) -> int:
    return route * 9 + pin * 3 + path


#: the unique class of an absorbed chain operand (no route, no pin, the
#: folded A-H adder path) — structural, never produced by any other edge
_CLS_ABSORBED = edge_class(ROUTE_NULL, PIN_NULL, PATH_AH)

#: functional IRs per netlist content digest — the single levelization
_IR_CACHE = _planner.register_cache("netlist_ir", cap=256)

#: packed IRs produced by :func:`apply_pack_delta`, keyed by
#: ``(base_digest, new_digest, structural_key)``.  Invalidation rule:
#: both digests are *content* digests, so an entry can never go stale —
#: a different edit or circuit is a different key — and the cache is
#: eviction-only (LRU) plus the registry-wide ``clear_caches()``.
_PACK_DELTA_CACHE = _planner.register_cache("pack_delta_ir", cap=128)

#: lowering-stage counters (see module docstring); tests assert the
#: one-lowering-per-(circuit, structural class) property against these
LOWER_COUNTS = {"functional": 0, "functional_patch": 0,
                "placement_full": 0, "placement_incremental": 0,
                "placement_delta": 0}


def reset_lower_counts() -> None:
    for k in LOWER_COUNTS:
        LOWER_COUNTS[k] = 0


def read_lower_counts() -> dict[str, int]:
    return dict(LOWER_COUNTS)


@dataclass(frozen=True)
class LutLevelRows:
    """Unpadded LUT rows of one topological level."""

    ins: np.ndarray       # [M, 6] int32 fanin signals (consts kept verbatim,
    #                       padded pins -> CONST0; tt replication makes padded
    #                       pins don't-care for the evaluator)
    tt_lo: np.ndarray     # [M] uint32 64-entry replicated mask, low word
    tt_hi: np.ndarray     # [M] uint32 high word
    cls: np.ndarray       # [M, 6] int32 edge classes (0 on const/padded pins;
    #                       all-zero in functional IRs)
    hop: np.ndarray       # [M, 6] int32 wire tier (0 in unplaced IRs)
    ndc: np.ndarray       # [M] int32 node delay class
    out: np.ndarray       # [M] int32 output signal


@dataclass(frozen=True)
class ChainLevelRows:
    """Unpadded chain rows of one topological level (row width = level's
    widest chain; shorter chains pad bits with null ops and ``sums`` -1)."""

    a_sig: np.ndarray     # [C, B] int32 (consts kept verbatim)
    a_cls: np.ndarray     # [C, B] int32
    a_hop: np.ndarray     # [C, B] int32 wire tier (0 in unplaced IRs)
    b_sig: np.ndarray     # [C, B] int32
    b_cls: np.ndarray     # [C, B] int32
    b_hop: np.ndarray     # [C, B] int32
    cin_sig: np.ndarray   # [C] int32 (the chain's real cin, consts included)
    cin_cls: np.ndarray   # [C] int32
    cin_hop: np.ndarray   # [C] int32
    sums: np.ndarray      # [C, B] int32 (-1 on padded bits)
    cout: np.ndarray      # [C] int32 (-1 when the chain has no cout)
    last: np.ndarray      # [C] int32 index of the last real bit


@dataclass(frozen=True)
class CircuitIR:
    """The unified columnar IR (see module docstring for the layout).

    Functional IRs (from :func:`lower_netlist_ir`) carry
    ``arch_name=None`` / ``structural_key=None``, empty ALM columns and
    all-zero edge/node delay classes; packed IRs (from
    :func:`lower_pack_ir`) fill every column."""

    name: str
    #: content digest of the source netlist — the incremental-lowering
    #: template guard (same-shaped but different circuits must not patch
    #: each other's IRs) and the registry cache key
    net_digest: str
    arch_name: str | None
    structural_key: tuple | None
    n_signals: int
    # per-signal columns
    sig_site: np.ndarray
    sig_lb: np.ndarray
    sig_kind: np.ndarray
    sig_level: np.ndarray
    # per-signal placement columns: grid coordinates of the producing LB
    # (-1 for PIs/constants and in unplaced IRs; see apply_placement)
    sig_x: np.ndarray
    sig_y: np.ndarray
    # fanin CSR (timing edges)
    fanin_ptr: np.ndarray
    fanin_sig: np.ndarray
    fanin_cls: np.ndarray
    fanin_hop: np.ndarray
    # per-ALM columns
    alm_lb: np.ndarray
    alm_is_arith: np.ndarray
    alm_feed: np.ndarray
    alm_hosted: np.ndarray
    alm_lut6: np.ndarray
    # levelized node tables (index 0 = first computing level)
    lut_levels: tuple[LutLevelRows, ...]
    chain_levels: tuple[ChainLevelRows, ...]
    # primary outputs + scalar stats
    po_sig: np.ndarray
    n_alms: int
    n_lbs: int
    n_luts: int
    n_adders: int
    concurrent_luts: int
    # placement metadata (0 / None until apply_placement fills the grid)
    grid_w: int = 0
    grid_h: int = 0
    placement_seed: int | None = None

    @property
    def placed(self) -> bool:
        return self.grid_w > 0

    @property
    def n_levels(self) -> int:
        return len(self.lut_levels)

    def level_profile(self):
        """Per-level (lut rows, chain rows, widest chain) — the width
        profile bucketing/batching decisions consume."""
        m = [lv.out.shape[0] for lv in self.lut_levels]
        c = [lv.cout.shape[0] for lv in self.chain_levels]
        b = [lv.a_sig.shape[1] if lv.cout.shape[0] else 0
             for lv in self.chain_levels]
        return m, c, b

    @property
    def envelope(self) -> tuple[int, int, int, int]:
        """Single worst-case ``(L, M, C, B)`` envelope — the shape the
        shared grouping planner (:func:`repro_torch.core.plan.group_by_envelope`)
        clusters on."""
        m, c, b = self.level_profile()
        return (self.n_levels, max(m, default=0), max(c, default=0),
                max(b, default=0))


def levelize(net: Netlist):
    """Nodes grouped by topological level (a node's level is one past its
    deepest input).  Returns ``(by_luts, by_chains, sig_level)``.  The
    single levelization of the stack — the evaluator, the timing lowering
    and the seed per-level dispatcher all consume this."""
    sig_level: dict[int, int] = {s: 0 for s in net.pis}
    sig_level[0] = 0
    sig_level[1] = 0
    by_luts: dict[int, list[int]] = {}
    by_chains: dict[int, list[int]] = {}
    for nd in net.topo_order():
        lv = 0
        for s in net.node_inputs(nd):
            lv = max(lv, sig_level.get(s, 0))
        lv += 1
        for s in net.node_outputs(nd):
            sig_level[s] = lv
        if nd[0] == "lut":
            by_luts.setdefault(lv, []).append(nd[1])
        else:
            by_chains.setdefault(lv, []).append(nd[1])
    return by_luts, by_chains, sig_level


# ---------------------------------------------------------------------------
# functional lowering (per netlist content digest)
# ---------------------------------------------------------------------------


def lower_netlist_ir(net: Netlist, digest: str | None = None) -> CircuitIR:
    """Functional lowering of a bare netlist — content-cached; see the
    module docstring.  Pass ``digest`` to skip recomputing it."""
    key = digest if digest is not None else net.content_digest()
    hit = _IR_CACHE.get(key)
    if hit is not None:
        return hit
    ir = _lower_functional(net, key)
    _IR_CACHE.put(key, ir)
    return ir


def _lower_functional(net: Netlist, digest: str) -> CircuitIR:
    LOWER_COUNTS["functional"] += 1
    S = net.n_signals

    sig_kind = np.full(S, K_PI, dtype=np.int32)
    sig_kind[: min(2, S)] = K_CONST
    for out in net.lut_out:
        sig_kind[out] = K_LUT
    for ch in net.chains:
        for s in ch.sums:
            sig_kind[s] = K_SUM
        if ch.cout is not None:
            sig_kind[ch.cout] = K_COUT

    by_luts, by_chains, sig_level_map = levelize(net)
    sig_level = np.zeros(S, dtype=np.int32)
    for s, lv in sig_level_map.items():
        sig_level[s] = lv
    levels = sorted(set(by_luts) | set(by_chains))

    # fanin CSR accumulators (append order is the patch-scatter contract:
    # per level, LUT rows' non-const pins in pin order, then chain rows'
    # a/b edges per bit plus cin on bit 0)
    csr_sig: list[list[int]] = [[] for _ in range(S)]

    lut_levels: list[LutLevelRows] = []
    chain_levels: list[ChainLevelRows] = []
    for lv in levels:
        # ---- LUT rows ----
        ids = by_luts.get(lv, ())
        M = len(ids)
        ins = np.zeros((M, 6), dtype=np.int32)
        tt_lo = np.zeros(M, dtype=np.uint32)
        tt_hi = np.zeros(M, dtype=np.uint32)
        ndc = np.zeros(M, dtype=np.int32)
        out = np.zeros(M, dtype=np.int32)
        for r, li in enumerate(ids):
            sig_ins = net.lut_inputs[li]
            k = len(sig_ins)
            ins[r, :k] = sig_ins
            lo, hi = tt_words64(net.lut_tt[li], k)
            tt_lo[r] = lo
            tt_hi[r] = hi
            ndc[r] = (NDC_LUT4 if k <= 4 else
                      NDC_LUT5 if k == 5 else NDC_LUT6)
            osig = net.lut_out[li]
            out[r] = osig
            for q in sig_ins:
                if q > CONST1:
                    csr_sig[osig].append(q)
        lut_levels.append(LutLevelRows(
            ins=ins, tt_lo=tt_lo, tt_hi=tt_hi,
            cls=np.zeros((M, 6), dtype=np.int32),
            hop=np.zeros((M, 6), dtype=np.int32), ndc=ndc, out=out))

        # ---- chain rows ----
        cids = by_chains.get(lv, ())
        C = len(cids)
        B = max((len(net.chains[ci].sums) for ci in cids), default=0)
        a_sig = np.zeros((C, max(B, 1)), dtype=np.int32)
        b_sig = np.zeros((C, max(B, 1)), dtype=np.int32)
        cin_sig = np.zeros(C, dtype=np.int32)
        sums = np.full((C, max(B, 1)), -1, dtype=np.int32)
        cout = np.full(C, -1, dtype=np.int32)
        last = np.zeros(C, dtype=np.int32)
        for r, ci in enumerate(cids):
            ch = net.chains[ci]
            n = len(ch.sums)
            last[r] = n - 1
            a_sig[r, :n] = ch.a
            b_sig[r, :n] = ch.b
            cin_sig[r] = ch.cin
            sums[r, :n] = ch.sums
            if ch.cout is not None:
                cout[r] = ch.cout
            for bi in range(n):
                for q in (ch.a[bi], ch.b[bi]):
                    if q > CONST1:
                        csr_sig[ch.sums[bi]].append(q)
                if bi == 0 and ch.cin > CONST1:
                    csr_sig[ch.sums[0]].append(ch.cin)
        chain_levels.append(ChainLevelRows(
            a_sig=a_sig, a_cls=np.zeros_like(a_sig),
            a_hop=np.zeros_like(a_sig),
            b_sig=b_sig, b_cls=np.zeros_like(b_sig),
            b_hop=np.zeros_like(b_sig),
            cin_sig=cin_sig, cin_cls=np.zeros_like(cin_sig),
            cin_hop=np.zeros_like(cin_sig),
            sums=sums, cout=cout, last=last))

    fanin_ptr = np.zeros(S + 1, dtype=np.int32)
    for s in range(S):
        fanin_ptr[s + 1] = fanin_ptr[s] + len(csr_sig[s])
    fanin_sig = np.array([q for lst in csr_sig for q in lst], dtype=np.int32)

    po_sig = np.array(sorted({s for bus in net.pos.values() for s in bus}),
                      dtype=np.int32)

    empty_i32 = np.zeros(0, dtype=np.int32)
    return CircuitIR(
        name=net.name, net_digest=digest,
        arch_name=None, structural_key=None,
        n_signals=S,
        sig_site=np.full(S, -1, dtype=np.int32),
        sig_lb=np.full(S, -1, dtype=np.int32),
        sig_kind=sig_kind, sig_level=sig_level,
        sig_x=np.full(S, -1, dtype=np.int32),
        sig_y=np.full(S, -1, dtype=np.int32),
        fanin_ptr=fanin_ptr, fanin_sig=fanin_sig,
        fanin_cls=np.zeros_like(fanin_sig),
        fanin_hop=np.zeros_like(fanin_sig),
        alm_lb=empty_i32, alm_is_arith=np.zeros(0, dtype=bool),
        alm_feed=np.zeros((0, 2), dtype=np.int32),
        alm_hosted=np.zeros((0, 2), dtype=np.int32),
        alm_lut6=empty_i32,
        lut_levels=tuple(lut_levels), chain_levels=tuple(chain_levels),
        po_sig=po_sig,
        n_alms=0, n_lbs=0, n_luts=net.n_luts, n_adders=net.n_adders,
        concurrent_luts=0,
    )


# ---------------------------------------------------------------------------
# functional dirty-row patch (per edited-netlist content digest)
# ---------------------------------------------------------------------------


def patch_functional_ir(base: CircuitIR, new_net: Netlist,
                        edited_luts, tt_luts,
                        digest: str | None = None) -> CircuitIR | None:
    """Patch a functional :class:`CircuitIR` for an index-stable LUT
    edit instead of re-levelizing the whole netlist.

    ``base`` is the functional IR of the *base* netlist; ``edited_luts``
    are the LUT indices whose fanin tuples changed and ``tt_luts`` those
    whose truth tables changed (from
    :func:`repro_torch.core.repack.netlist_structural_diff` — the caller has
    already proven the edit index-stable).  Only the touched rows are
    rewritten: the edited LUTs' ``ins``/``tt``/``ndc`` entries inside
    their level tables and their output signals' fanin-CSR rows.

    **Levels-stable gate**: the patch requires every edited LUT's
    topological level to be unchanged under its new fanins (level =
    ``max(input levels) + 1``).  An unchanged output level means no
    downstream level can move either, so the level tables keep exactly
    their base rows.  Returns ``None`` when the gate fails and the
    caller must run the full :func:`lower_netlist_ir`.

    Within-level row *order* is inherited from the base IR (fresh
    lowering orders rows by Kahn-queue pop order, which an edit can
    permute); every consumer — the evaluator, the vectorized timing
    program, the equivalence walks — reduces per signal, so results are
    bit-identical regardless of row order within a level.
    """
    import dataclasses

    if base.arch_name is not None:
        raise ValueError("patch_functional_ir needs a functional IR base")
    sig_level = base.sig_level
    edited_luts = sorted(set(edited_luts))
    for li in edited_luts:
        out = new_net.lut_out[li]
        lv = 0
        for s in new_net.lut_inputs[li]:
            lv = max(lv, int(sig_level[s]))
        if lv + 1 != int(sig_level[out]):
            return None
    LOWER_COUNTS["functional_patch"] += 1

    # locate each touched LUT's (level-table, row) slot by output signal
    def find_row(out_sig: int) -> tuple[int, int]:
        for t, ll in enumerate(base.lut_levels):
            r = np.nonzero(ll.out == out_sig)[0]
            if r.size:
                return t, int(r[0])
        raise ValueError(f"signal {out_sig} has no LUT row")

    touched: dict[int, dict[int, int]] = {}   # table idx -> {row: li}
    for li in set(edited_luts) | set(tt_luts):
        t, r = find_row(new_net.lut_out[li])
        touched.setdefault(t, {})[r] = li

    lut_levels = list(base.lut_levels)
    for t, rows in touched.items():
        ll = lut_levels[t]
        ins = ll.ins.copy()
        tt_lo = ll.tt_lo.copy()
        tt_hi = ll.tt_hi.copy()
        ndc = ll.ndc.copy()
        from .netlist import tt_words64 as _ttw
        for r, li in rows.items():
            sig_ins = new_net.lut_inputs[li]
            k = len(sig_ins)
            ins[r] = 0
            ins[r, :k] = sig_ins
            lo, hi = _ttw(new_net.lut_tt[li], k)
            tt_lo[r] = lo
            tt_hi[r] = hi
            ndc[r] = (NDC_LUT4 if k <= 4 else
                      NDC_LUT5 if k == 5 else NDC_LUT6)
        lut_levels[t] = dataclasses.replace(
            ll, ins=ins, tt_lo=tt_lo, tt_hi=tt_hi, ndc=ndc)

    # fanin-CSR rows of the edited outputs (per-occurrence, consts
    # dropped — mirrors _lower_functional's append rule)
    ptr = base.fanin_ptr
    new_rows = {}
    for li in edited_luts:
        out = new_net.lut_out[li]
        new_rows[out] = [q for q in new_net.lut_inputs[li] if q > CONST1]
    same_len = all(ptr[s + 1] - ptr[s] == len(row)
                   for s, row in new_rows.items())
    if same_len:
        fanin_ptr = ptr
        fanin_sig = base.fanin_sig.copy()
        for s, row in new_rows.items():
            fanin_sig[ptr[s]:ptr[s + 1]] = row
    else:
        S = base.n_signals
        lens = np.diff(ptr).astype(np.int64)
        for s, row in new_rows.items():
            lens[s] = len(row)
        fanin_ptr = np.zeros(S + 1, ptr.dtype)
        np.cumsum(lens, out=fanin_ptr[1:])
        segs: list[np.ndarray] = []
        prev = 0
        for s in sorted(new_rows):
            if prev < s:
                segs.append(base.fanin_sig[ptr[prev]:ptr[s]])
            segs.append(np.asarray(new_rows[s], base.fanin_sig.dtype))
            prev = s + 1
        if prev < S:
            segs.append(base.fanin_sig[ptr[prev]:ptr[S]])
        fanin_sig = np.concatenate(segs) if segs \
            else base.fanin_sig[:0]

    return dataclasses.replace(
        base,
        name=new_net.name,
        net_digest=(digest if digest is not None
                    else new_net.content_digest()),
        fanin_ptr=fanin_ptr, fanin_sig=fanin_sig,
        fanin_cls=np.zeros_like(fanin_sig),
        fanin_hop=np.zeros_like(fanin_sig),
        lut_levels=tuple(lut_levels))


def apply_pack_delta(packed: "PackedCircuit", base_net: Netlist,
                     edited_luts=(), tt_luts=()) -> CircuitIR:
    """Dirty-column lowering of an edited netlist's pack: patch the
    *base* netlist's cached functional IR row-wise
    (:func:`patch_functional_ir`) and restamp the placement columns with
    the same vectorized :func:`_patch_placement` pass every other
    lowering path runs — instead of re-levelizing from scratch.

    The patched functional IR is inserted into the ``netlist_ir``
    registry under the edited netlist's content digest, so any later
    fresh lowering of the same edited netlist (``pack_and_analyze``,
    sweeps) hits it identically; the packed result lands in the
    ``pack_delta_ir`` cache keyed ``(base_digest, new_digest,
    structural_key)`` (content-digest keys — entries cannot go stale;
    see the cache comment).  Falls back to the full functional lowering
    when the levels-stable gate fails, so it is total: every call
    returns the same arrays ``lower_pack_ir`` would produce up to
    within-level row order."""
    new_digest = packed.net.content_digest()
    base_digest = base_net.content_digest()
    key = (base_digest, new_digest, packed.arch.structural_key())
    hit = _PACK_DELTA_CACHE.get(key)
    if hit is not None:
        return hit
    func = _IR_CACHE.get(new_digest)
    if func is None:
        base_func = lower_netlist_ir(base_net, base_digest)
        func = patch_functional_ir(base_func, packed.net, edited_luts,
                                   tt_luts, new_digest)
        if func is None:
            func = lower_netlist_ir(packed.net, new_digest)
        else:
            _IR_CACHE.put(new_digest, func)
    LOWER_COUNTS["placement_delta"] += 1
    ir = _patch_placement(func, packed)
    _PACK_DELTA_CACHE.put(key, ir)
    return ir


# ---------------------------------------------------------------------------
# placement patch (per (digest, structural class))
# ---------------------------------------------------------------------------


def _placement_columns(packed: "PackedCircuit") -> dict:
    """The placement-derived columns every packed lowering needs: per-
    signal site/LB, the per-ALM mode columns, the absorbed-LUT set and
    the per-sum-signal Z-feed flags.  Single source of truth — the patch
    recomputes exactly what this builds."""
    net = packed.net
    S = net.n_signals

    sig_site = np.full(S, -1, dtype=np.int32)
    for li, out in enumerate(net.lut_out):
        sig_site[out] = packed.lut_site.get(li, -2)
    for ci, ch in enumerate(net.chains):
        for bi, s in enumerate(ch.sums):
            sig_site[s] = packed.chain_site.get((ci, bi), -2)
        if ch.cout is not None:
            sig_site[ch.cout] = packed.chain_site.get((ci, len(ch.sums) - 1),
                                                      -2)

    alm_lb_arr = np.asarray(packed.alm_lb, dtype=np.int32) \
        if packed.alm_lb else np.zeros(0, dtype=np.int32)
    sig_lb = np.full(S, -1, dtype=np.int32)
    placed = sig_site >= 0
    sig_lb[placed] = alm_lb_arr[sig_site[placed]]

    A = len(packed.alms)
    alm_is_arith = np.zeros(A, dtype=bool)
    alm_feed = np.zeros((A, 2), dtype=np.int32)
    alm_hosted = np.full((A, 2), -1, dtype=np.int32)
    alm_lut6 = np.full(A, -1, dtype=np.int32)
    absorbed_all: set[int] = set()
    z_of_sum = np.zeros(S, dtype=bool)
    for ai, alm in enumerate(packed.alms):
        alm_is_arith[ai] = alm.is_arith
        if alm.lut6 is not None:
            alm_lut6[ai] = alm.lut6
        for hi, h in enumerate(alm.halves):
            if h.fa is not None:
                alm_feed[ai, hi] = 2 if h.fa_feed == "z" else 1
                absorbed_all.update(h.absorbed)
                if h.fa_feed == "z":
                    ci, bi = h.fa
                    z_of_sum[net.chains[ci].sums[bi]] = True
            if h.hosted_lut is not None:
                alm_hosted[ai, hi] = h.hosted_lut

    return {"sig_site": sig_site, "sig_lb": sig_lb, "alm_lb": alm_lb_arr,
            "alm_is_arith": alm_is_arith, "alm_feed": alm_feed,
            "alm_hosted": alm_hosted, "alm_lut6": alm_lut6,
            "absorbed_all": absorbed_all, "z_of_sum": z_of_sum}


def _patch_placement(base: CircuitIR, packed: "PackedCircuit") -> CircuitIR:
    """Fill the placement-derived columns of ``base`` for ``packed``.

    ``base`` supplies the netlist-shaped arrays (level tables' signals and
    truth tables, fanin CSR topology, signal levels, primary outputs) —
    either the cached functional IR (fresh lowering) or a sibling
    structural class's packed IR (template-incremental lowering).  Both
    produce identical columns because this is the only classifier.

    Absorption is derived from the pack: an absorbed LUT is 4-input,
    single-fanout and consumed exactly at its absorbing half, so a global
    per-signal absorbed mask is equivalent to the per-half operand sets
    the object-graph walk used.  Constant operands keep class 0 (the
    null edge: gathered arrival 0.0, zero components) — bit-identical to
    the oracle's skip-constants reductions.
    """
    net = packed.net
    arch = packed.arch
    S = net.n_signals

    cols = _placement_columns(packed)
    sig_lb = cols["sig_lb"]
    z_of_sum = cols["z_of_sum"]

    if net.n_luts:
        lut_outs = np.asarray(net.lut_out, dtype=np.int64)
        if (cols["sig_site"][lut_outs] == -2).any():
            bad = int(lut_outs[cols["sig_site"][lut_outs] == -2][0])
            raise ValueError(
                f"{net.name}: LUT output signal {bad} has no site — an "
                f"unplaced LUT cannot be lowered (the packer must place "
                f"every LUT)")

    absorbed_sig = np.zeros(S, dtype=bool)
    for li in cols["absorbed_all"]:
        absorbed_sig[net.lut_out[li]] = True
    sig_kind = base.sig_kind.copy()
    sig_kind[absorbed_sig] = K_LUT_ABS

    cls_lut_local = edge_class(ROUTE_LOCAL, PIN_AH, PATH_NULL)
    cls_lut_global = edge_class(ROUTE_GLOBAL, PIN_AH, PATH_NULL)
    fanin_cls = np.zeros_like(base.fanin_cls)
    ptr = base.fanin_ptr

    lut_levels: list[LutLevelRows] = []
    chain_levels: list[ChainLevelRows] = []
    for ll, cl in zip(base.lut_levels, base.chain_levels):
        # ---- LUT rows: route locality is the only class variable ----
        mask = ll.ins > CONST1
        dst = sig_lb[ll.out][:, None]
        local = (sig_lb[ll.ins] == dst) & (sig_lb[ll.ins] >= 0)
        cls = np.where(mask, np.where(local, cls_lut_local, cls_lut_global),
                       0).astype(np.int32)
        ndc = np.where(absorbed_sig[ll.out], NDC_ABSORBED,
                       ll.ndc).astype(np.int32)
        lut_levels.append(LutLevelRows(ins=ll.ins, tt_lo=ll.tt_lo,
                                       tt_hi=ll.tt_hi, cls=cls,
                                       hop=np.zeros_like(cls), ndc=ndc,
                                       out=ll.out))
        if mask.any():
            offs = np.cumsum(mask, axis=1) - 1
            slots = ptr[ll.out][:, None] + offs
            fanin_cls[slots[mask]] = cls[mask]

        # ---- chain rows: absorption and feed kind are placement-derived
        # (via the per-signal absorbed / Z-feed masks), routing locality
        # comes from the LB columns ----
        C = cl.cout.shape[0]
        if C:
            sums_safe = np.clip(cl.sums, 0, None)
            dst = np.where(cl.sums >= 0, sig_lb[sums_safe], -1)
            feed_z = z_of_sum[sums_safe] & (cl.sums >= 0)

            def patch_ops(op_sig):
                m = op_sig > CONST1
                absorbed = absorbed_sig[op_sig] & m
                route = np.where((sig_lb[op_sig] == dst) & (sig_lb[op_sig]
                                                            >= 0),
                                 ROUTE_LOCAL, ROUTE_GLOBAL)
                c_z = route * 9 + PIN_Z * 3 + PATH_Z
                c_ah = route * 9 + PIN_AH * 3 + PATH_AH
                c = np.where(absorbed, _CLS_ABSORBED,
                             np.where(feed_z, c_z, c_ah))
                return np.where(m, c, 0).astype(np.int32), m

            a_cls, amask = patch_ops(cl.a_sig)
            b_cls, bmask = patch_ops(cl.b_sig)
            cmask = cl.cin_sig > CONST1
            route0 = np.where((sig_lb[cl.cin_sig] == dst[:, 0])
                              & (sig_lb[cl.cin_sig] >= 0),
                              ROUTE_LOCAL, ROUTE_GLOBAL)
            cin_cls = np.where(cmask, route0 * 9 + PIN_AH * 3 + PATH_AH,
                               0).astype(np.int32)
            # CSR order per sum: a-edge, b-edge, then cin on bit 0
            base_slots = ptr[sums_safe]
            if amask.any():
                fanin_cls[base_slots[amask]] = a_cls[amask]
            slots_b = base_slots + amask.astype(np.int32)
            if bmask.any():
                fanin_cls[slots_b[bmask]] = b_cls[bmask]
            slot_c = base_slots[:, 0] + amask[:, 0].astype(np.int32) \
                + bmask[:, 0].astype(np.int32)
            if cmask.any():
                fanin_cls[slot_c[cmask]] = cin_cls[cmask]
            chain_levels.append(ChainLevelRows(
                a_sig=cl.a_sig, a_cls=a_cls, a_hop=np.zeros_like(a_cls),
                b_sig=cl.b_sig, b_cls=b_cls, b_hop=np.zeros_like(b_cls),
                cin_sig=cl.cin_sig, cin_cls=cin_cls,
                cin_hop=np.zeros_like(cin_cls), sums=cl.sums,
                cout=cl.cout, last=cl.last))
        else:
            chain_levels.append(ChainLevelRows(
                a_sig=cl.a_sig, a_cls=np.zeros_like(cl.a_cls),
                a_hop=np.zeros_like(cl.a_cls),
                b_sig=cl.b_sig, b_cls=np.zeros_like(cl.b_cls),
                b_hop=np.zeros_like(cl.b_cls),
                cin_sig=cl.cin_sig, cin_cls=np.zeros_like(cl.cin_cls),
                cin_hop=np.zeros_like(cl.cin_cls),
                sums=cl.sums, cout=cl.cout, last=cl.last))

    return CircuitIR(
        name=net.name, net_digest=base.net_digest,
        arch_name=arch.name,
        structural_key=arch.structural_key(),
        n_signals=S,
        sig_site=cols["sig_site"], sig_lb=sig_lb,
        sig_kind=sig_kind, sig_level=base.sig_level,
        sig_x=np.full(S, -1, dtype=np.int32),
        sig_y=np.full(S, -1, dtype=np.int32),
        fanin_ptr=base.fanin_ptr, fanin_sig=base.fanin_sig,
        fanin_cls=fanin_cls,
        fanin_hop=np.zeros_like(fanin_cls),
        alm_lb=cols["alm_lb"], alm_is_arith=cols["alm_is_arith"],
        alm_feed=cols["alm_feed"], alm_hosted=cols["alm_hosted"],
        alm_lut6=cols["alm_lut6"],
        lut_levels=tuple(lut_levels), chain_levels=tuple(chain_levels),
        po_sig=base.po_sig,
        n_alms=packed.n_alms, n_lbs=packed.n_lbs, n_luts=net.n_luts,
        n_adders=net.n_adders, concurrent_luts=packed.concurrent_luts,
    )


def lower_pack_ir(packed: "PackedCircuit") -> CircuitIR:
    """Lower a :class:`~repro_torch.core.packing.PackedCircuit` to a full
    :class:`CircuitIR`: the content-cached functional IR of its netlist
    plus the placement patch.  Levelization therefore runs once per
    netlist digest no matter how many structural classes are lowered."""
    base = lower_netlist_ir(packed.net)
    LOWER_COUNTS["placement_full"] += 1
    return _patch_placement(base, packed)


def lower_pack_ir_incremental(packed: "PackedCircuit",
                              template: CircuitIR) -> CircuitIR:
    """Re-lower a pack by patching a sibling class's :class:`CircuitIR`.

    ``template`` must be a lowering of a pack of the *same netlist* (any
    structural class — typically the first class of a sweep).  Clustering
    can only move atoms between ALMs/LBs and flip chain-bit feeds, so the
    netlist-shaped columns are reused verbatim and only the
    placement-derived columns are recomputed — by the *same*
    :func:`_patch_placement` pass the fresh path runs, so the result is
    array-for-array identical to :func:`lower_pack_ir` by construction
    (the parity tests compare every column anyway).
    """
    if template.net_digest != packed.net.content_digest():
        raise ValueError(
            f"template CircuitIR {template.name!r} is not a lowering of "
            f"netlist {packed.net.name!r} — incremental patching needs a "
            f"sibling structural class of the same circuit (content "
            f"digests differ)")
    LOWER_COUNTS["placement_incremental"] += 1
    return _patch_placement(template, packed)


# ---------------------------------------------------------------------------
# grid-placement patch (per (digest, placement key, seed))
# ---------------------------------------------------------------------------


def apply_placement(ir: CircuitIR, placement) -> CircuitIR:
    """Fill the grid-placement columns of a packed :class:`CircuitIR`.

    ``placement`` is a :class:`repro_torch.core.place.GridPlacement` (anything
    with ``lb_x``/``lb_y``/``grid_w``/``grid_h``/``seed`` works) of the
    same pack — one slot per LB.  A third, orthogonal patch stage on top
    of the functional lowering and the placement-derived edge classes:
    it rewrites only the wire-tier columns (``hop`` per level-table pin,
    ``fanin_hop`` per CSR edge) and the per-signal grid coordinates.

    Wire tiers follow the Manhattan distance between the producing and
    consuming LB slots: same LB (or an absorbed operand, or a PI/constant
    source — nothing to route through the fabric grid) → :data:`TIER_NONE`
    (zero delay), distance 1 → :data:`TIER_HOP1`, distance 2 →
    :data:`TIER_HOP2`, anything farther rides one long wire
    (:data:`TIER_LONG`).  Tier delays are per-arch *data*
    (``t_wire_hop1/2``/``t_wire_long`` rows of the delay table), so every
    delay row of a structural class shares this one placed IR; at the
    all-zero default tier delays the placed timing path is bit-identical
    to the unplaced one.
    """
    import dataclasses

    if ir.arch_name is None:
        raise ValueError(
            f"{ir.name}: cannot place a functional IR — placement needs "
            f"the packed LB columns (lower the pack first)")
    lb_x = np.asarray(placement.lb_x, dtype=np.int32)
    lb_y = np.asarray(placement.lb_y, dtype=np.int32)
    if lb_x.shape[0] != ir.n_lbs:
        raise ValueError(
            f"{ir.name}: placement has {lb_x.shape[0]} LB slots but the "
            f"IR packs {ir.n_lbs} LBs — not a placement of this pack")

    sig_lb = ir.sig_lb
    S = ir.n_signals
    sig_x = np.full(S, -1, dtype=np.int32)
    sig_y = np.full(S, -1, dtype=np.int32)
    placed = sig_lb >= 0
    if lb_x.size:
        sig_x[placed] = lb_x[sig_lb[placed]]
        sig_y[placed] = lb_y[sig_lb[placed]]

    def tiers(op_sig, dst_lb):
        src_lb = sig_lb[op_sig]
        routed = (src_lb >= 0) & (dst_lb >= 0) & (src_lb != dst_lb)
        if not lb_x.size:
            return np.zeros(op_sig.shape, dtype=np.int32)
        sl = np.clip(src_lb, 0, None)
        dl = np.clip(dst_lb, 0, None)
        d = np.abs(lb_x[sl] - lb_x[dl]) + np.abs(lb_y[sl] - lb_y[dl])
        t = np.where(d <= 1, TIER_HOP1,
                     np.where(d == 2, TIER_HOP2, TIER_LONG))
        return np.where(routed, t, TIER_NONE).astype(np.int32)

    fanin_hop = np.zeros_like(ir.fanin_hop)
    ptr = ir.fanin_ptr
    lut_levels: list[LutLevelRows] = []
    chain_levels: list[ChainLevelRows] = []
    for ll, cl in zip(ir.lut_levels, ir.chain_levels):
        mask = ll.ins > CONST1
        hop = np.where(mask, tiers(ll.ins, sig_lb[ll.out][:, None]),
                       0).astype(np.int32)
        lut_levels.append(dataclasses.replace(ll, hop=hop))
        if mask.any():
            offs = np.cumsum(mask, axis=1) - 1
            slots = ptr[ll.out][:, None] + offs
            fanin_hop[slots[mask]] = hop[mask]

        C = cl.cout.shape[0]
        if C:
            sums_safe = np.clip(cl.sums, 0, None)
            dst = np.where(cl.sums >= 0, sig_lb[sums_safe], -1)
            amask = cl.a_sig > CONST1
            bmask = cl.b_sig > CONST1
            cmask = cl.cin_sig > CONST1
            a_hop = np.where(amask, tiers(cl.a_sig, dst), 0).astype(np.int32)
            b_hop = np.where(bmask, tiers(cl.b_sig, dst), 0).astype(np.int32)
            cin_hop = np.where(cmask, tiers(cl.cin_sig, dst[:, 0]),
                               0).astype(np.int32)
            chain_levels.append(dataclasses.replace(
                cl, a_hop=a_hop, b_hop=b_hop, cin_hop=cin_hop))
            # CSR order per sum: a-edge, b-edge, then cin on bit 0
            base_slots = ptr[sums_safe]
            if amask.any():
                fanin_hop[base_slots[amask]] = a_hop[amask]
            slots_b = base_slots + amask.astype(np.int32)
            if bmask.any():
                fanin_hop[slots_b[bmask]] = b_hop[bmask]
            slot_c = base_slots[:, 0] + amask[:, 0].astype(np.int32) \
                + bmask[:, 0].astype(np.int32)
            if cmask.any():
                fanin_hop[slot_c[cmask]] = cin_hop[cmask]
        else:
            chain_levels.append(cl)

    return dataclasses.replace(
        ir, sig_x=sig_x, sig_y=sig_y, fanin_hop=fanin_hop,
        lut_levels=tuple(lut_levels), chain_levels=tuple(chain_levels),
        grid_w=int(placement.grid_w), grid_h=int(placement.grid_h),
        placement_seed=int(placement.seed))
