"""Packing: netlist -> ALMs -> logic blocks, for baseline / DD5 / DD6.

A deliberately VPR-like greedy flow, held identical across architectures so
the A/B comparison isolates the architectural change (the paper runs VTR's
timing-driven packer; we model its resource behaviour, not its annealing):

1. **Absorption pre-pass** — fan-out-1, <=4-input LUTs driving a chain
   operand are absorbed into that FA's input LUTs (all architectures; this is
   the classical "LUT simplifies logic before addition" usage).
2. **Chain slotting** — a carry chain of L FA bits occupies ceil(L/2)
   consecutive ALM halves-pairs; chains may span LBs (carry links cross LABs).
3. **LUT pairing** — remaining LUTs are paired into ALM candidates
   (two <=4-LUTs with <=8 distinct inputs, two 5-LUTs sharing >=2 inputs, or a
   single 6-LUT).
4. **Greedy connectivity clustering** into LBs under input/output budgets.
5. **Concurrent co-packing (DD only)** — LUT pairs / singles are placed into
   free or Z-convertible halves of arithmetic ALMs in the same LB before a
   new logic ALM is opened; FA operands of a converted half move to the Z
   pins, debiting the LB's AddMux-crossbar budget (``z_sources`` distinct
   LB-external signals; in-LB producers ride the direct-link taps for free
   when ``z_local_free``).

The baseline architecture rejects step 5 structurally — that is the paper's
entire premise.

Every pack is *verifiable*: :mod:`repro_torch.core.equiv` re-elaborates a
:class:`PackedCircuit` back into the physical netlist its ALMs implement
(absorbed masks, Z-fed vs A–H-fed operands, hosted LUTs, 6-LUT spans) and
proves functional equivalence against the source over random vector lanes —
run ``check_pack_equivalence(net, arch)`` before trusting any area number.

Every pack is also *lowerable*: :meth:`PackedCircuit.lower_ir` flattens the
object graph into the unified :class:`~repro_torch.core.circuit_ir.CircuitIR` (per-
signal site/LB/kind columns, fanin CSR with timing edge classes, per-ALM
mode columns, levelized node tables) — the shared substrate of the
vectorized timing analyzer (:mod:`repro_torch.core.timing_vec`), the architecture
design-space sweep engine (:mod:`repro_torch.core.sweep`) and the benchmark flow
(:mod:`repro_torch.core.flow`).  Only ``ArchParams.structural_key()`` fields steer
this module; delay parameters never do, which is what lets a sweep reuse one
pack (and one CircuitIR) across every delay row of a structural class.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from itertools import islice

import numpy as np

from .alm import ArchParams
from .netlist import CONST0, CONST1, Netlist

#: diagnostic counters from the most recent :func:`pack` call
LAST_PACK_DEBUG: dict[str, int] = {}

#: drive the greedy re-cluster replay through the vectorized
#: ClusterPlan columns (numpy candidate-LB gathers, CSR frontier bumps,
#: batched host-feasibility masks).  The scalar path is kept verbatim as
#: the byte-identity reference — ``tests/core/test_repack.py`` proves
#: both flags produce identical packs across the structural grid.
VECTOR_CLUSTER = True

#: sentinel padding value of the per-ALM A-H signal columns
_SENT32 = np.int32(2**31 - 1)
#: per-ALM A-H column capacity.  An ALM whose A-H set overflows the cap
#: is decidable without the exact distinct count: ``|new_ah| >= ah_len -
#: moved_cnt`` and ``moved_cnt <= 4`` (two convertible halves x two live
#: operands), so ``ah_len > 12`` always fails the 8-pin check.
_AH_CAP = 12
#: below this many candidate ALMs the batched numpy mask costs more than
#: the scalar scan; both are exact, so these thresholds are pure perf —
#: profiled break-evens of numpy dispatch vs the tuned Python loops
_MASK_MIN_ALMS = 24
#: mean per-atom probe/neighbor list length above which a plan's replay
#: uses the numpy CSR gathers instead of the scalar list walks
_VEC_MIN_DEGREE = 48


@dataclass(slots=True)
class Half:
    """One ALM half: 1 FA bit + two 4-LUTs (one 5-LUT equivalent)."""

    fa: tuple[int, int] | None = None      # (chain_idx, bit_idx) or None
    fa_feed: str = "none"                  # "lut" (A-H route) | "z" | "none"
    absorbed: list[int] = field(default_factory=list)  # lut indices feeding FA
    hosted_lut: int | None = None          # unrelated LUT index (mode C/logic)


@dataclass(slots=True)
class ALM:
    halves: tuple[Half, Half]
    lut6: int | None = None                # a hosted 6-LUT spans both halves
    is_arith: bool = False

    def input_signals(self, net: Netlist) -> tuple[set[int], set[int]]:
        """Returns (ah_signals, z_signals) consumed by this ALM."""
        ah: set[int] = set()
        z: set[int] = set()
        for h in self.halves:
            if h.fa is not None:
                ci, bi = h.fa
                ch = net.chains[ci]
                ops = [ch.a[bi], ch.b[bi]]
                if h.fa_feed == "z":
                    z.update(s for s in ops if s > CONST1)
                else:
                    if h.absorbed:
                        for li in h.absorbed:
                            ah.update(s for s in net.lut_inputs[li] if s > CONST1)
                        absorbed_outs = {net.lut_out[li] for li in h.absorbed}
                        ah.update(s for s in ops
                                  if s > CONST1 and s not in absorbed_outs)
                    else:
                        ah.update(s for s in ops if s > CONST1)
            if h.hosted_lut is not None:
                ah.update(s for s in net.lut_inputs[h.hosted_lut] if s > CONST1)
        if self.lut6 is not None:
            ah.update(s for s in net.lut_inputs[self.lut6] if s > CONST1)
        return ah, z

    def output_signals(self, net: Netlist) -> set[int]:
        outs: set[int] = set()
        for h in self.halves:
            if h.fa is not None:
                ci, bi = h.fa
                ch = net.chains[ci]
                outs.add(ch.sums[bi])
                if ch.cout is not None and bi == len(ch.sums) - 1:
                    outs.add(ch.cout)
            if h.hosted_lut is not None:
                outs.add(net.lut_out[h.hosted_lut])
        if self.lut6 is not None:
            outs.add(net.lut_out[self.lut6])
        return outs


@dataclass(slots=True)
class LB:
    alms: list[int] = field(default_factory=list)  # indices into packed.alms


@dataclass
class PackedCircuit:
    net: Netlist
    arch: ArchParams
    alms: list[ALM]
    lbs: list[LB]
    lut_site: dict[int, int]       # lut idx -> alm idx (hosted/absorbed)
    chain_site: dict[tuple[int, int], int]  # (chain, bit) -> alm idx
    alm_lb: list[int]              # alm idx -> lb idx
    concurrent_luts: int           # unrelated LUTs co-packed with active FAs

    _ir: object | None = field(default=None, repr=False, compare=False)

    def lower_ir(self, cache: bool = True, template: object | None = None):
        """Lower to the unified :class:`~repro_torch.core.circuit_ir.CircuitIR` (flat
        per-signal / per-ALM / per-level arrays — the substrate the
        vectorized timing analyzer and the arch-sweep engine consume).
        The IR is cached on the packed circuit; it is immutable, so any
        later mutation of ``alms`` must pass ``cache=False``.

        **Incremental mode**: pass ``template`` — a full lowering of a
        sibling structural class of the same circuit/prefix — and only
        the placement-derived columns (sites, LBs, edge delay classes,
        ALM modes) are recomputed; the netlist-shaped columns (levels,
        fanin CSR topology, node tables' signals) are reused.  Identical
        output to a fresh lowering, at a fraction of the cost — this is
        what a cluster-geometry sweep pays per structural class."""
        if self._ir is None or not cache:
            from .circuit_ir import (lower_pack_ir,
                                     lower_pack_ir_incremental)

            ir = (lower_pack_ir_incremental(self, template)
                  if template is not None else lower_pack_ir(self))
            if not cache:
                return ir
            self._ir = ir
        return self._ir

    # -- stats -------------------------------------------------------------
    @property
    def n_alms(self) -> int:
        return len(self.alms)

    @property
    def n_lbs(self) -> int:
        return len(self.lbs)

    @property
    def total_area(self) -> float:
        return self.n_alms * self.arch.alm_area_mwta

    def produced_in_lb(self, lb_idx: int) -> set[int]:
        out: set[int] = set()
        for ai in self.lbs[lb_idx].alms:
            out.update(self.alms[ai].output_signals(self.net))
        return out

    def lb_external_ins(self, lb_idx: int) -> set[int]:
        produced = self.produced_in_lb(lb_idx)
        need: set[int] = set()
        for ai in self.lbs[lb_idx].alms:
            ah, z = self.alms[ai].input_signals(self.net)
            need.update(ah)
            need.update(z)
        return need - produced

    def stats(self) -> dict:
        return {
            "arch": self.arch.name,
            "alms": self.n_alms,
            "lbs": self.n_lbs,
            "area_mwta": self.total_area,
            "adders": self.net.n_adders,
            "luts": self.net.n_luts,
            "concurrent_luts": self.concurrent_luts,
        }


# ---------------------------------------------------------------------------
# packing driver
# ---------------------------------------------------------------------------


def pack(net: Netlist, arch: ArchParams, seed: int = 0,
         allow_unrelated: bool = True, strict_phases: tuple = (False,),
         pull_runs: bool = False) -> PackedCircuit:
    """Full pack = arch-invariant prefix + one re-clustering.

    The prefix (absorption, chain slotting, LUT pairing, cluster plan —
    see :mod:`repro_torch.core.repack`) depends only on the netlist and the
    seed; the clustering stage consumes the structural arch knobs.  A
    design-space sweep over cluster geometry computes the prefix once
    per circuit and replays only the clustering per structural class."""
    from .repack import pack_prefix, repack

    return repack(pack_prefix(net, seed=seed), arch,
                  allow_unrelated=allow_unrelated,
                  strict_phases=strict_phases, pull_runs=pull_runs)


def _fanout_counts(net: Netlist) -> dict[int, int]:
    fanout: dict[int, int] = defaultdict(int)
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
    return fanout


def _pair_luts(net: Netlist, free_luts: list[int], rng):
    """Pair LUTs into ALM-sized groups by shared-input affinity."""
    # per-LUT input sets/arities hoisted out of the greedy loops: can_pair
    # and the affinity score used to rebuild both sets on every probe,
    # which dominated the pass on large circuits.  Decisions (and
    # therefore the output) are unchanged — only the set construction
    # moved.
    in_set: dict[int, frozenset] = {
        li: frozenset(net.lut_inputs[li]) for li in free_luts}
    arity: dict[int, int] = {li: len(in_set[li]) for li in free_luts}
    by_sig: dict[int, list[int]] = defaultdict(list)
    for li in free_luts:
        for s in net.lut_inputs[li]:
            by_sig[s].append(li)
    unpaired = set(free_luts)
    pairs: list[tuple[int, int]] = []
    singles6: list[int] = []
    singles5: list[int] = []

    def can_pair(a: int, b: int) -> bool:
        ia, ib = in_set[a], in_set[b]
        ka, kb = arity[a], arity[b]
        if ka > 5 or kb > 5:
            return False
        shared = len(ia & ib)
        if ka + kb - shared > 8:
            return False
        if ka == 5 and kb == 5 and shared < 2:
            return False
        return True

    order = sorted(free_luts, key=lambda li: -len(net.lut_inputs[li]))
    for li in order:
        if li not in unpaired:
            continue
        k = len(net.lut_inputs[li])
        if k >= 6:
            unpaired.discard(li)
            singles6.append(li)
            continue
        # candidate partners sharing a signal
        best = None
        best_score = -1
        seen = set()
        ia = in_set[li]
        for s in net.lut_inputs[li]:
            for lj in by_sig[s]:
                if lj == li or lj not in unpaired or lj in seen:
                    continue
                seen.add(lj)
                if can_pair(li, lj):
                    score = len(ia & in_set[lj])
                    if score > best_score:
                        best_score, best = score, lj
        if best is None:
            # fall back: any unpaired small LUT
            for lj in unpaired:
                if lj != li and can_pair(li, lj):
                    best = lj
                    break
        if best is not None:
            unpaired.discard(li)
            unpaired.discard(best)
            pairs.append((li, best))
        else:
            unpaired.discard(li)
            singles5.append(li)
    return pairs, singles6, singles5


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------


class _LBState:
    def __init__(self, arch: ArchParams):
        self.arch = arch
        self.alm_ids: list[int] = []
        self.produced: set[int] = set()
        self.ext_in: set[int] = set()
        self.ext_out_capacity = arch.output_budget
        self.z_ext: set[int] = set()
        # arith ALMs with hostable halves, in placement order (the
        # hosting scans' first-fit order); pruned lazily as halves fill
        self.hostable: list[int] = []
        self.alm_pos: dict[int, int] = {}

    def n_alms(self) -> int:
        return len(self.alm_ids)

    def fits_inputs(self, new_in: set[int], new_z_ext: set[int]) -> bool:
        # membership counting instead of set algebra: add() keeps
        # ext_in ∩ produced = ∅, so |(ext_in ∪ new_in) − produced| is
        # |ext_in| plus the new signals not already external or local
        ext_in, produced = self.ext_in, self.produced
        tot_in = len(ext_in)
        for s in new_in:
            if s not in ext_in and s not in produced:
                tot_in += 1
        if tot_in > self.arch.input_budget:
            return False
        z_ext = self.z_ext
        tot_z = len(z_ext)
        for s in new_z_ext:
            if s not in z_ext:
                tot_z += 1
        if tot_z > self.arch.z_sources:
            return False
        return True

    def add(self, new_in: set[int], new_prod: set[int], new_z_ext: set[int]):
        self.ext_in |= new_in
        self.produced |= new_prod
        self.ext_in -= self.produced
        self.z_ext |= new_z_ext


@dataclass
class ClusterPlan:
    """Arch-invariant clustering inputs, computed once per (net, seed).

    Everything here depends only on the netlist, the chain-slotted ALM
    skeleton and the pairing RNG — never on cluster geometry — so a
    structural-axis sweep builds one plan per circuit and replays
    :func:`_cluster` under each grid point's LB budgets.
    """

    # Atom = ("run", chain_idx) | ("pair", a, b) | ("single6"/"single5", li)
    atoms: list[tuple]
    run_order: list[int]                  # connectivity-greedy chain order
    lut_order: list[int]                  # seeded shuffle of LUT atoms
    #: per skeleton-ALM (ah, z, prod) at placement time — ALMs are only
    #: mutated *after* they are placed, so these are arch-invariant
    skeleton_io: list[tuple[set[int], set[int], set[int]]]
    #: per atom, the (ah, z, prod) of its materialized logic ALM
    #: (``None`` for chain runs)
    atom_io: list[tuple[set[int], set[int], set[int]] | None]
    #: per atom, its frontier-bump targets as (neighbor, shared-signal
    #: count) pairs, ordered by first occurrence in the legacy
    #: signal-set x sig2atoms iteration (ties in the greedy pull are
    #: broken by first-seen order, so the order is semantic)
    atom_neighbors: list[list[tuple[int, int]]]
    #: per (chain, bit), the live (> CONST1) FA operand signals
    bit_live: dict[tuple[int, int], list[int]]
    #: per LUT atom, its candidate-LB probes in legacy order:
    #: (0, sig) — LB producing ``sig``; (1, alm) — LB of the (fixed,
    #: skeleton) ALM of a consuming chain bit; (2, lut) — LB hosting a
    #: consuming LUT (dynamic).  Empty for chain runs.
    atom_cand_ops: list[list[tuple[int, int]]]

    # --- vectorized replay columns (consumed when VECTOR_CLUSTER) --------
    #: CSR image of ``atom_cand_ops`` — one gather resolves a whole probe
    #: sequence instead of a Python loop per op
    cand_ptr: np.ndarray | None = None
    cand_code: np.ndarray | None = None
    cand_payload: np.ndarray | None = None
    #: CSR image of ``atom_neighbors`` for the batched frontier bump
    nbr_ptr: np.ndarray | None = None
    nbr_j: np.ndarray | None = None
    nbr_cnt: np.ndarray | None = None
    #: per LUT atom, its live A-H inputs sorted (int32; ``None`` for runs)
    atom_ah_arr: list | None = None
    #: per skeleton ALM: host-feasibility columns for the batched hosting
    #: prefilter — free-half count, per hosted-LUT-count variant (1 or 2)
    #: the max live-operand count over converted halves and the distinct
    #: moved-signal count, the A-H set size and its sorted padded image.
    #: Arch-invariant for the *unmutated* skeleton; ``_cluster`` copies
    #: them and refreshes single rows as hosting mutates ALMs.
    skel_fh: np.ndarray | None = None
    skel_need: np.ndarray | None = None
    skel_moved: np.ndarray | None = None
    skel_ah_len: np.ndarray | None = None
    skel_ah_pad: np.ndarray | None = None

    # --- incremental-repack ownership columns (delta plans only) ---------
    #: per atom, the LB that owned it in the *base* pack the delta plan
    #: was derived from (-1 for unknown/new atoms), and per atom the LBs
    #: the base greedy consulted while placing it (its decision
    #: dependencies).  Filled by ``repack.pack_prefix_delta`` from the
    #: base decision log; ``None`` on plans built fresh — fresh plans are
    #: shared across archs and ownership is arch-specific.
    atom_owner_lb: np.ndarray | None = None
    atom_dep_lbs: list | None = None


def _fill_host_cols(ai, alm, bit_live, ah_set, col_fh, col_need, col_moved,
                    col_ah_len, col_ah_pad) -> None:
    """(Re)compute one arith ALM's host-feasibility row.

    Shares the half-selection logic of ``_cluster``'s ``free_halves_of``
    (hostable halves, Z-free first, stable) so the columns predict the
    scalar scan's decisions exactly.  A 6-LUT span zeroes the free-half
    count — the scan prunes on that, covering the legacy ``lut6`` pop."""
    fh = []
    for h in alm.halves:
        if h.hosted_lut is not None:
            continue
        if h.fa is None:
            fh.append((h, False))
        elif not h.absorbed:
            fh.append((h, True))
    fh.sort(key=lambda x: x[1])
    col_fh[ai] = 0 if alm.lut6 is not None else len(fh)
    for k in (1, 2):
        conv_need = 0
        moved: set[int] = set()
        for h, needs_z in fh[:k]:
            if needs_z:
                live = bit_live[h.fa]
                if len(live) > conv_need:
                    conv_need = len(live)
                moved.update(live)
        col_need[ai, k - 1] = conv_need
        col_moved[ai, k - 1] = len(moved)
    col_ah_len[ai] = len(ah_set)
    col_ah_pad[ai, :] = _SENT32
    if len(ah_set) <= _AH_CAP:
        srt = sorted(ah_set)
        col_ah_pad[ai, : len(srt)] = srt


def _atom_sigs_of(net, atom) -> set[int]:
    """Live signal set of one atom — the connectivity currency of the
    plan (frontier counts, probe targets).  Insertion order is part of
    the plan contract: neighbor rows inherit it, so the delta-prefix
    path must build rows with exactly this sequence."""
    kind = atom[0]
    sigs: set[int] = set()
    if kind == "run":
        ci = atom[1]
        ch = net.chains[ci]
        for s in list(ch.a) + list(ch.b) + list(ch.sums):
            if s > CONST1:
                sigs.add(s)
    else:
        for li in atom[1:]:
            if isinstance(li, int):
                sigs.update(s for s in net.lut_inputs[li] if s > CONST1)
                sigs.add(net.lut_out[li])
    return sigs


def _build_cluster_plan(net, alms, chain_alm_runs, chain_site, pairs,
                        singles6, singles5, rng) -> ClusterPlan:
    """Build the :class:`ClusterPlan` — the atom list, connectivity
    indexes, placement orders and placement-time IO sets
    :func:`_cluster` consumes.  Must draw from ``rng`` exactly as the
    pre-refactor ``_cluster`` did (one shuffle of the LUT atoms) so
    packs stay byte-stable."""
    atoms: list[tuple] = []
    for ci, run in enumerate(chain_alm_runs):
        if run:
            atoms.append(("run", ci))
    for a, b in pairs:
        atoms.append(("pair", a, b))
    for li in singles6:
        atoms.append(("single6", li))
    for li in singles5:
        atoms.append(("single5", li))

    atom_sigs = [_atom_sigs_of(net, a) for a in atoms]

    # connectivity index
    sig2atoms: dict[int, list[int]] = defaultdict(list)
    for idx in range(len(atoms)):
        for s in atom_sigs[idx]:
            sig2atoms[s].append(idx)

    # consumer index: signal -> consuming sites (chain bits and luts)
    sig_consumers: dict[int, list[tuple]] = defaultdict(list)
    for li in range(net.n_luts):
        for s in net.lut_inputs[li]:
            if s > CONST1:
                sig_consumers[s].append(("lut", li))
    for ci, ch in enumerate(net.chains):
        for bi in range(len(ch.sums)):
            for s in (ch.a[bi], ch.b[bi]):
                if s > CONST1:
                    sig_consumers[s].append(("chain", ci, bi))

    # Chain runs are placed in *connectivity order*: start from the largest
    # run, then repeatedly take the unplaced run sharing the most signals
    # with what is already placed.  Consumer chains land next to their
    # producers, so Z conversions ride the free local/direct-link taps.
    run_idxs = [i for i, a in enumerate(atoms) if a[0] == "run"]
    run_order: list[int] = []
    if run_idxs:
        remaining = set(run_idxs)
        overlap: dict[int, int] = {i: 0 for i in run_idxs}
        sig2runs: dict[int, list[int]] = defaultdict(list)
        for i in run_idxs:
            for s in atom_sigs[i]:
                sig2runs[s].append(i)
        first = max(remaining, key=lambda i: len(chain_alm_runs[atoms[i][1]]))
        run_order.append(first)
        remaining.discard(first)
        for s in atom_sigs[first]:
            for j in sig2runs[s]:
                if j in remaining:
                    overlap[j] += 1
        while remaining:
            nxt = max(remaining,
                      key=lambda i: (overlap[i],
                                     len(chain_alm_runs[atoms[i][1]])))
            run_order.append(nxt)
            remaining.discard(nxt)
            for s in atom_sigs[nxt]:
                for j in sig2runs[s]:
                    if j in remaining:
                        overlap[j] += 1
    lut_order = [i for i, a in enumerate(atoms) if a[0] != "run"]
    rng.shuffle(lut_order)

    # placement-time IO sets: the skeleton ALMs (and the logic ALMs the
    # LUT atoms materialize) are queried by the clusterer only *before*
    # their first mutation, so their (ah, z, prod) never depends on the
    # architecture — computing them here keeps the greedy replay off the
    # ``input_signals`` object walk entirely
    skeleton_io = [(alm.input_signals(net) + (alm.output_signals(net),))
                   for alm in alms]

    def logic_atom_io(atom):
        if atom[0] == "run":
            return None
        ah: set[int] = set()
        prod: set[int] = set()
        for li in atom[1:]:
            ah.update(s for s in net.lut_inputs[li] if s > CONST1)
            prod.add(net.lut_out[li])
        return (ah, set(), prod)

    atom_io = [logic_atom_io(a) for a in atoms]

    # frontier-bump targets aggregated to (neighbor, count), first
    # occurrence following the legacy (signal-set order x sig2atoms
    # order) flattening — a bump is atomic between placements, so one
    # +count increment replays the legacy per-signal +1 sequence exactly
    atom_neighbors: list[list[tuple[int, int]]] = []
    for i in range(len(atoms)):
        agg: dict[int, int] = {}
        for s in atom_sigs[i]:
            for j in sig2atoms[s]:
                agg[j] = agg.get(j, 0) + 1
        atom_neighbors.append(list(agg.items()))

    bit_live = {(ci, bi): [s for s in (ch.a[bi], ch.b[bi]) if s > CONST1]
                for ci, ch in enumerate(net.chains)
                for bi in range(len(ch.sums))}

    # candidate-LB probe sequences: producer lookups and consumer sites
    # flattened per atom in the legacy per-LUT order; chain-bit consumer
    # sites resolve to *fixed* skeleton ALM indices already here
    atom_cand_ops: list[list[tuple[int, int]]] = []
    for atom in atoms:
        ops: list[tuple[int, int]] = []
        if atom[0] != "run":
            for li in atom[1:]:
                if isinstance(li, int):
                    for s in net.lut_inputs[li]:
                        ops.append((0, s))
                    for cons in sig_consumers.get(net.lut_out[li], ()):
                        if cons[0] == "chain":
                            ops.append((1, chain_site[(cons[1], cons[2])]))
                        else:
                            ops.append((2, cons[1]))
        atom_cand_ops.append(ops)

    # vectorized replay columns: CSR images of the probe/neighbor lists,
    # per-atom sorted A-H arrays and the skeleton host-feasibility rows
    n_atoms = len(atoms)
    cand_ptr = np.zeros(n_atoms + 1, np.int64)
    code_l: list[int] = []
    pay_l: list[int] = []
    for i, ops in enumerate(atom_cand_ops):
        cand_ptr[i + 1] = cand_ptr[i] + len(ops)
        for op, payload in ops:
            code_l.append(op)
            pay_l.append(payload)
    nbr_ptr = np.zeros(n_atoms + 1, np.int64)
    nj_l: list[int] = []
    nc_l: list[int] = []
    for i, nbrs in enumerate(atom_neighbors):
        nbr_ptr[i + 1] = nbr_ptr[i] + len(nbrs)
        for j, cnt in nbrs:
            nj_l.append(j)
            nc_l.append(cnt)
    atom_ah_arr = [None if io is None else np.array(sorted(io[0]), np.int32)
                   for io in atom_io]
    n_skel = len(alms)
    skel_fh = np.zeros(n_skel, np.int16)
    skel_need = np.zeros((n_skel, 2), np.int16)
    skel_moved = np.zeros((n_skel, 2), np.int16)
    skel_ah_len = np.zeros(n_skel, np.int32)
    skel_ah_pad = np.full((n_skel, _AH_CAP), _SENT32, np.int32)
    for ai, alm in enumerate(alms):
        _fill_host_cols(ai, alm, bit_live, skeleton_io[ai][0], skel_fh,
                        skel_need, skel_moved, skel_ah_len, skel_ah_pad)

    # atom_sigs / sig2atoms / sig_consumers are construction scaffolding:
    # everything the clusterer replays is baked into the orders, the
    # neighbor counts and the probe sequences, so the retained plan (it
    # lives as long as a sweep's prefix cache) stays slim
    return ClusterPlan(atoms=atoms, run_order=run_order,
                       lut_order=lut_order, skeleton_io=skeleton_io,
                       atom_io=atom_io, atom_neighbors=atom_neighbors,
                       bit_live=bit_live, atom_cand_ops=atom_cand_ops,
                       cand_ptr=cand_ptr,
                       cand_code=np.array(code_l, np.int8),
                       cand_payload=np.array(pay_l, np.int64),
                       nbr_ptr=nbr_ptr, nbr_j=np.array(nj_l, np.int64),
                       nbr_cnt=np.array(nc_l, np.int64),
                       atom_ah_arr=atom_ah_arr, skel_fh=skel_fh,
                       skel_need=skel_need, skel_moved=skel_moved,
                       skel_ah_len=skel_ah_len, skel_ah_pad=skel_ah_pad)


def _cluster(net, arch, alms, chain_alm_runs, plan: ClusterPlan,
             chain_site, lut_site, allow_unrelated=True,
             strict_phases=(True, False), pull_runs=True, replay=None):
    atoms = plan.atoms
    n_atoms = len(atoms)
    vector = VECTOR_CLUSTER and plan.cand_ptr is not None
    # The numpy replay paths each clear a profiled break-even before they
    # replace the tuned scalar loops (numpy dispatch loses below ~50
    # elements): the CSR probe gather and the batched frontier bump
    # engage per plan by mean list degree; the batched host mask engages
    # per probe by candidate count (_MASK_MIN_ALMS).  Every path is exact
    # — the A/B tests prove byte-identity in all four combinations.
    vector_gather = (vector and plan.cand_payload.size
                     >= _VEC_MIN_DEGREE * max(len(plan.lut_order), 1))
    vector_bump = (vector
                   and plan.nbr_j.size >= _VEC_MIN_DEGREE * n_atoms)

    placed = (np.zeros(n_atoms, dtype=bool) if vector_bump
              else [False] * n_atoms)
    lbs_state: list[_LBState] = []
    lb_list: list[LB] = []
    alm_lb: list[int] = [-1] * len(alms)
    concurrent = 0

    if vector:
        # runtime copies of the skeleton host-feasibility rows, refreshed
        # per ALM (lazily) as hosting mutates it — the batched host mask
        # gathers from these
        n_skel = len(plan.skeleton_io)
        col_fh = plan.skel_fh.copy()
        col_need = plan.skel_need.copy()
        col_moved = plan.skel_moved.copy()
        col_ah_len = plan.skel_ah_len.copy()
        col_ah_pad = plan.skel_ah_pad.copy()
    if vector_gather:
        # flat site/LB mirrors so a probe sequence resolves as one gather
        cand_ptr, cand_code = plan.cand_ptr, plan.cand_code
        cand_payload = plan.cand_payload
        lut_site_arr = np.full(net.n_luts, -1, np.int64)
        for _li, _ai in lut_site.items():
            lut_site_arr[_li] = _ai
        # capacity bound: clustering materializes at most one ALM per atom
        alm_lb_arr = np.full(len(alms) + n_atoms + 1, -1, np.int64)

    # host rows invalidated by a mutation, refreshed lazily on the next
    # scan that reads them (mirrors the alm_io/free_halves discipline —
    # an ALM hosted once and never rescanned costs nothing)
    cols_dirty: set[int] = set()

    def _refresh_host_cols(ai: int) -> None:
        cols_dirty.discard(ai)
        _fill_host_cols(ai, alms[ai], plan.bit_live, alm_io(ai)[0], col_fh,
                        col_need, col_moved, col_ah_len, col_ah_pad)

    # (ah, z, prod) per ALM — seeded from the plan's arch-invariant
    # placement-time sets, recomputed lazily after a mutation (hosting,
    # Z conversion) invalidates an entry.  Callers must treat the sets
    # as read-only (they may be shared across re-clusterings).
    alm_io_cache: dict[int, tuple] = dict(enumerate(plan.skeleton_io))
    # hostable halves per arith ALM, same invalidation discipline
    free_halves_cache: dict[int, list] = {}

    def alm_io(ai: int):
        r = alm_io_cache.get(ai)
        if r is None:
            ah, z = alms[ai].input_signals(net)
            prod = alms[ai].output_signals(net)
            r = (ah, z, prod)
            alm_io_cache[ai] = r
        return r

    def open_lb() -> int:
        lbs_state.append(_LBState(arch))
        lb_list.append(LB())
        return len(lbs_state) - 1

    # signal -> producing ALM (or -1); an ndarray when gathering so the
    # probe gather can fancy-index it (scalar reads/writes are identical)
    prod_site = (np.full(net.n_signals, -1, np.int64) if vector_gather
                 else [-1] * net.n_signals)
    host_capacity_lbs: set[int] = set()

    def _has_free_half(alm: ALM) -> bool:
        if not alm.is_arith or alm.lut6 is not None:
            return False
        for h in alm.halves:
            if h.hosted_lut is None and (h.fa is None or not h.absorbed):
                return True
        return False

    def place_alm(ai: int, lb_idx: int):
        st = lbs_state[lb_idx]
        ah, z, prod = alm_io(ai)
        z_ext = z - st.produced if arch.z_local_free else set(z)
        st.add(ah | z, prod, z_ext)
        st.alm_pos[ai] = len(st.alm_ids)
        st.alm_ids.append(ai)
        lb_list[lb_idx].alms.append(ai)
        alm_lb[ai] = lb_idx
        if vector_gather:
            alm_lb_arr[ai] = lb_idx
        for s in prod:
            prod_site[s] = ai
        if _has_free_half(alms[ai]):
            st.hostable.append(ai)
            if arch.concurrent:
                host_capacity_lbs.add(lb_idx)

    def try_fit_alm(ai: int, lb_idx: int) -> bool:
        st = lbs_state[lb_idx]
        if st.n_alms() >= arch.alms_per_lb:
            return False
        ah, z, prod = alm_io(ai)
        z_ext = z - st.produced if arch.z_local_free else set(z)
        return st.fits_inputs((ah | z) - prod, z_ext)

    # --- concurrent hosting helpers (DD only) ------------------------------
    def host_in_arith(lut_list: list[int], lb_idx: int,
                      strict_z: bool = False, ok_mask=None) -> bool:
        """Try to host LUT(s) in free/convertible halves of arith ALMs.

        A pair is first attempted in one ALM (shared A-H pins), then split
        across two ALMs of the same LB.  With ``strict_z`` only placements
        that add no *new* external AddMux-crossbar source are accepted
        (operands local to the LB or already-routed Z signals).
        ``ok_mask`` is the batched ALM-level prefilter and describes the
        *whole* atom — the split replays per-LUT A-H sets after a state
        commit, so it always runs the exact scan.
        """
        if len(lut_list) == 2:
            if _host_in_one_alm(lut_list, lb_idx, strict_z, ok_mask):
                return True
            st = lbs_state[lb_idx]
            # split: both halves must fit or neither (transactional)
            snapshot = (set(st.ext_in), set(st.produced), set(st.z_ext))
            if _host_in_one_alm([lut_list[0]], lb_idx, strict_z):
                if _host_in_one_alm([lut_list[1]], lb_idx, strict_z):
                    return True
                _unhost(lut_list[0], lb_idx, snapshot)
            return False
        return _host_in_one_alm(lut_list, lb_idx, strict_z, ok_mask)

    def _unhost(li: int, lb_idx: int, snapshot):
        nonlocal concurrent
        st = lbs_state[lb_idx]
        ai = lut_site.pop(li)
        alm_io_cache.pop(ai, None)
        free_halves_cache.pop(ai, None)
        for h in alms[ai].halves:
            if h.hosted_lut == li:
                h.hosted_lut = None
                if h.fa is not None and h.fa_feed == "z":
                    h.fa_feed = "lut"
                    concurrent -= 1
        st.ext_in, st.produced, st.z_ext = snapshot
        if vector:
            cols_dirty.add(ai)
        if vector_gather:
            lut_site_arr[li] = -1
        # the ALM regained hostable halves; restore it at its placement-
        # order slot if a scan pruned it while its halves were full
        if ai not in st.hostable:
            pos = st.alm_pos[ai]
            idx = 0
            while (idx < len(st.hostable)
                   and st.alm_pos[st.hostable[idx]] < pos):
                idx += 1
            st.hostable.insert(idx, ai)
            if replay is not None:
                replay.ev_ins(lb_idx, ai)

    def free_halves_of(ai: int) -> list:
        """Hostable halves of an arith ALM (Z-free first) — cached, with
        the same invalidation points as ``alm_io_cache``."""
        fh = free_halves_cache.get(ai)
        if fh is None:
            fh = []
            for h in alms[ai].halves:
                if h.hosted_lut is not None:
                    continue
                if h.fa is None:
                    fh.append((h, False))   # no Z needed
                elif not h.absorbed:
                    fh.append((h, True))    # needs Z conversion
            fh.sort(key=lambda x: x[1])     # prefer Z-free halves
            free_halves_cache[ai] = fh
        return fh

    def _host_mask(ids: list[int], k: int, atom_ah) -> dict:
        """Batched image of the scan's per-ALM rejections (free halves,
        bypass width, 8-pin budget) over every hostable ALM of the probed
        LBs.  Exact: ``|new_ah| = |ah ∪ atom_ah| - |moved|`` because a
        convertible half's live operands are always A-H-routed before
        conversion (``moved ⊆ ah``); rows whose A-H set overflows
        ``_AH_CAP`` reject unconditionally (see the cap's invariant)."""
        if cols_dirty:
            for ai in ids:
                if ai in cols_dirty:
                    _refresh_host_cols(ai)
        cand = np.array(ids, np.int64)
        fh = col_fh[cand]
        need = col_need[cand, k - 1]
        moved = col_moved[cand, k - 1].astype(np.int64)
        lens = col_ah_len[cand].astype(np.int64)
        mat = np.empty((cand.size, _AH_CAP + atom_ah.size), np.int32)
        mat[:, :_AH_CAP] = col_ah_pad[cand]
        if atom_ah.size:
            mat[:, _AH_CAP:] = atom_ah
        mat.sort(axis=1)
        nonpad = mat != _SENT32
        uniq = ((mat[:, 1:] != mat[:, :-1]) & nonpad[:, 1:]).sum(axis=1) \
            + nonpad[:, 0]
        new_ah = np.where(lens <= _AH_CAP, uniq, lens) - moved
        rej = (fh < k) | (need > arch.bypass_inputs) | (new_ah > 8)
        return dict(zip(ids, (~rej).tolist()))

    def _host_in_one_alm(lut_list: list[int], lb_idx: int,
                         strict_z: bool = False, ok_mask=None) -> bool:
        nonlocal concurrent
        if not (arch.concurrent and allow_unrelated):
            return False
        dbg = LAST_PACK_DEBUG
        dbg["host_calls"] = dbg.get("host_calls", 0) + 1
        st = lbs_state[lb_idx]
        hostable = st.hostable
        i = 0
        while i < len(hostable):
            ai = hostable[i]
            alm = alms[ai]
            if alm.lut6 is not None:
                hostable.pop(i)       # 6-LUT span: never hostable again
                if replay is not None:
                    replay.ev_pop(lb_idx, ai)
                continue
            free_halves = free_halves_of(ai)
            if not free_halves:
                hostable.pop(i)       # filled up; prune (order preserved)
                if replay is not None:
                    replay.ev_pop(lb_idx, ai)
                continue
            i += 1
            if ok_mask is not None and not ok_mask.get(ai, True):
                # the batched mask already proved an ALM-level rejection
                # (free halves / bypass width / 8-pin budget) — skip the
                # per-ALM set builds; survivors re-derive them below
                continue
            if len(free_halves) < len(lut_list):
                dbg["rej_nofree"] = dbg.get("rej_nofree", 0) + 1
                continue
            # input budget at ALM level: all residents' A-H pins <= 8
            ah, z, _ = alm_io(ai)
            new_ah = set(ah)
            for li in lut_list:
                new_ah.update(s for s in net.lut_inputs[li] if s > CONST1)
            # halves being converted move their FA operands to Z; a half
            # whose bit has more live operands than the arch has bypass
            # inputs cannot be converted at all
            conv = [fh for fh in free_halves[: len(lut_list)] if fh[1]]
            moved_z: set[int] = set()
            over_bypass = False
            for h, _ in conv:
                live = plan.bit_live[h.fa]
                if len(live) > arch.bypass_inputs:
                    over_bypass = True
                    break
                for s in live:
                    moved_z.add(s)
                    new_ah.discard(s)
            if over_bypass:
                dbg["rej_bypass"] = dbg.get("rej_bypass", 0) + 1
                continue
            if len(new_ah) > 8:
                dbg["rej_pin8"] = dbg.get("rej_pin8", 0) + 1
                continue
            z_ext = (moved_z | z) - st.produced if arch.z_local_free else (moved_z | z)
            if strict_z and (z_ext - st.z_ext):
                dbg["rej_strictz"] = dbg.get("rej_strictz", 0) + 1
                continue
            if len(st.z_ext | z_ext) > arch.z_sources:
                dbg["rej_zbud"] = dbg.get("rej_zbud", 0) + 1
                continue
            new_in = set(new_ah) | moved_z
            if not st.fits_inputs(new_in - st.produced, z_ext):
                dbg["rej_lbin"] = dbg.get("rej_lbin", 0) + 1
                continue
            # commit
            alm_io_cache.pop(ai, None)
            free_halves_cache.pop(ai, None)
            for li, (h, needs_z) in zip(lut_list, free_halves):
                h.hosted_lut = li
                lut_site[li] = ai
                if vector_gather:
                    lut_site_arr[li] = ai
                if needs_z:
                    h.fa_feed = "z"
                if h.fa is not None:
                    concurrent += 1
            new_prod = {net.lut_out[li] for li in lut_list}
            st.add(new_in, new_prod, z_ext)
            if vector:
                cols_dirty.add(ai)
            return True
        if not hostable:
            host_capacity_lbs.discard(lb_idx)
            if replay is not None:
                replay.ev_capd(lb_idx)
        return False

    def host6_in_arith(li: int, lb_idx: int) -> bool:
        nonlocal concurrent
        if not (arch.concurrent_6lut and allow_unrelated):
            return False
        st = lbs_state[lb_idx]
        for ai in st.alm_ids:
            alm = alms[ai]
            if not alm.is_arith or alm.lut6 is not None:
                continue
            if any(h.hosted_lut is not None or h.absorbed for h in alm.halves):
                continue
            moved_z: set[int] = set()
            over_bypass = False
            for h in alm.halves:
                if h.fa is not None:
                    live = plan.bit_live[h.fa]
                    if len(live) > arch.bypass_inputs:
                        over_bypass = True
                        break
                    moved_z.update(live)
            if over_bypass:
                continue
            new_ah = {s for s in net.lut_inputs[li] if s > CONST1}
            if len(new_ah) > 8:
                continue
            z_ext = moved_z - st.produced if arch.z_local_free else set(moved_z)
            if len(st.z_ext | z_ext) > arch.z_sources:
                continue
            new_in = new_ah | moved_z
            if not st.fits_inputs(new_in - st.produced, z_ext):
                continue
            alm_io_cache.pop(ai, None)
            free_halves_cache.pop(ai, None)
            alm.lut6 = li
            lut_site[li] = ai
            if vector_gather:
                lut_site_arr[li] = ai
            for h in alm.halves:
                if h.fa is not None:
                    h.fa_feed = "z"
                    concurrent += 1
            st.add(new_in, {net.lut_out[li]}, z_ext)
            if vector:
                cols_dirty.add(ai)
            return True
        return False

    def materialize_logic_alm(aidx: int) -> int:
        atom = atoms[aidx]
        kind = atom[0]
        if kind == "pair":
            a, b = atom[1], atom[2]
            alm = ALM(halves=(Half(hosted_lut=a), Half(hosted_lut=b)))
            ai = len(alms)
            alms.append(alm)
            alm_lb.append(-1)
            alm_io_cache[ai] = plan.atom_io[aidx]
            lut_site[a] = ai
            lut_site[b] = ai
            if vector_gather:
                lut_site_arr[a] = ai
                lut_site_arr[b] = ai
            return ai
        if kind == "single6":
            alm = ALM(halves=(Half(), Half()), lut6=atom[1])
        else:
            alm = ALM(halves=(Half(hosted_lut=atom[1]), Half()))
        ai = len(alms)
        alms.append(alm)
        alm_lb.append(-1)
        alm_io_cache[ai] = plan.atom_io[aidx]
        lut_site[atom[1]] = ai
        if vector_gather:
            lut_site_arr[atom[1]] = ai
        return ai

    # --- main greedy loop ---------------------------------------------------
    # Atom orders come precomputed from the plan: chain runs in
    # connectivity order, LUT atoms in the seeded shuffle.  The frontier
    # is a lazy max-heap over (score, first-seen order): the legacy dict
    # scan picked the earliest-inserted atom among the max scores, and
    # (-score, seen, atom) heap entries reproduce exactly that winner —
    # stale entries (superseded scores, placed atoms) pop through.
    # Scores/first-seen live in flat lists (atom-indexed) — the bump
    # loop is the hottest spot of a re-clustering.
    frontier_heap: list[tuple[int, int, int]] = []
    n_seen = 0
    eligible = [pull_runs or a[0] != "run" for a in atoms]
    heappush = heapq.heappush

    if vector_bump:
        # batched bump: one CSR slice per placement updates every
        # neighbor's score, assigns first-seen ranks in CSR (= legacy
        # flattening) order, and pushes the eligible survivors.  Scores
        # only ever grow, so each pushed entry carries the neighbor's
        # final score for this bump — exactly the legacy push sequence.
        frontier_scores = np.zeros(n_atoms, np.int64)
        frontier_seen = np.full(n_atoms, -1, np.int64)
        eligible_arr = np.array(eligible, dtype=bool)
        nbr_ptr, nbr_j, nbr_cnt = plan.nbr_ptr, plan.nbr_j, plan.nbr_cnt

        def bump_frontier(src_aidx: int):
            nonlocal n_seen
            lo, hi = nbr_ptr[src_aidx], nbr_ptr[src_aidx + 1]
            if hi == lo:
                return
            js = nbr_j[lo:hi]
            m = ~placed[js]
            if not m.any():
                return
            js = js[m]
            frontier_scores[js] += nbr_cnt[lo:hi][m]
            new = frontier_seen[js] < 0
            if new.any():
                idxs = js[new]
                frontier_seen[idxs] = n_seen + np.arange(idxs.size)
                n_seen += int(idxs.size)
            el = js[eligible_arr[js]]
            for v, seq, j in zip(frontier_scores[el].tolist(),
                                 frontier_seen[el].tolist(), el.tolist()):
                heappush(frontier_heap, (-v, seq, j))
    else:
        frontier_scores = [0] * n_atoms
        frontier_seen = [-1] * n_atoms

        def bump_frontier(src_aidx: int):
            nonlocal n_seen
            for j, cnt in plan.atom_neighbors[src_aidx]:
                if placed[j]:
                    continue
                v = frontier_scores[j] + cnt
                frontier_scores[j] = v
                seq = frontier_seen[j]
                if seq < 0:
                    seq = n_seen
                    frontier_seen[j] = seq
                    n_seen += 1
                if eligible[j]:
                    heappush(frontier_heap, (-v, seq, j))

    def place_atom(aidx: int, lb_idx: int | None) -> int | None:
        """Place atom; returns the (possibly new) current LB index."""
        atom = atoms[aidx]
        kind = atom[0]
        # The replay log shadows the greedy loop without steering it: in
        # record mode start_atom opens a step and adv_skips stays None; in
        # advise mode it returns the base run's consulted-but-rejected LBs
        # for this atom when the step is provably in sync (same atom order,
        # no diverged state touched) — those scans are skipped and their
        # recorded side effects (hostable prunes/reinserts, capacity-set
        # discards) applied verbatim, so every *executed* scan sees exactly
        # the state a fresh pack would.
        adv_skips = replay.start_atom(aidx) if replay is not None else None
        if kind == "run":
            ci = atom[1]
            tgts: list[int] = []
            for ai in chain_alm_runs[ci]:
                tgt = lb_idx
                if tgt is None or not try_fit_alm(ai, tgt):
                    # chains may spill into a fresh LB mid-run
                    tgt = open_lb()
                    if not try_fit_alm(ai, tgt):
                        # pathological (budget smaller than one ALM) — force
                        pass
                place_alm(ai, tgt)
                lb_idx = tgt
                tgts.append(tgt)
            placed[aidx] = True
            bump_frontier(aidx)
            if replay is not None:
                replay.note_atom(aidx, tuple(tgts), lb_idx, len(lbs_state))
            return lb_idx
        # LUT atoms: try concurrent hosting — connectivity-driven first
        # (current LB, then LBs producing this atom's inputs, then LBs
        # consuming its outputs), then VPR-style unrelated clustering over
        # any LB with spare arithmetic halves.  The probe sequence comes
        # precompiled from the plan (chain-bit consumer sites are fixed
        # skeleton ALMs); only the producer/hosting lookups are dynamic.
        cand_lbs: list[int] = []
        if lb_idx is not None:
            cand_lbs.append(lb_idx)
        if vector_gather:
            lo, hi = cand_ptr[aidx], cand_ptr[aidx + 1]
            if hi > lo:
                code = cand_code[lo:hi]
                pay = cand_payload[lo:hi]
                sites = np.empty(hi - lo, np.int64)
                m = code == 0
                sites[m] = prod_site[pay[m]]
                m = code == 1
                sites[m] = pay[m]
                m = code == 2
                sites[m] = lut_site_arr[pay[m]]
                lbs_arr = alm_lb_arr[sites[sites >= 0]]
                cand_lbs.extend(lbs_arr[lbs_arr >= 0].tolist())
        else:
            for op, payload in plan.atom_cand_ops[aidx]:
                if op == 0:
                    site = prod_site[payload]
                elif op == 1:
                    site = payload
                else:
                    site = lut_site.get(payload, -1)
                if site >= 0 and alm_lb[site] >= 0:
                    cand_lbs.append(alm_lb[site])
        n_conn = len(cand_lbs)
        if allow_unrelated and arch.concurrent:
            cand_lbs.extend(islice(host_capacity_lbs, 64))
        # Batched host-feasibility mask for the unrelated-clustering
        # fallback: the connectivity LBs (few, usually fruitful) run the
        # plain scan, but an atom that falls through them probes up to 64
        # spare-capacity LBs — one batched mask over all their hostable
        # ALMs replaces those per-ALM set walks.  Built lazily on the
        # first fallback probe; the state it snapshots cannot change
        # until a commit ends the placement, so it holds across LBs and
        # strict phases.
        ok_mask = None
        mask_built = kind == "single6" or not vector or adv_skips is not None
        for strict in strict_phases:
            seen_lb: set[int] = set()
            for pos, cand in enumerate(cand_lbs):
                if cand in seen_lb:
                    continue
                seen_lb.add(cand)
                if adv_skips is not None and adv_skips.try_skip(
                        cand, lbs_state, host_capacity_lbs):
                    # base run consulted this LB here and rejected it; its
                    # state is untouched by the edit, so the rejection (and
                    # the scan's pruning side effects) transfer verbatim
                    continue
                use_mask = None
                if pos >= n_conn:
                    if not mask_built:
                        mask_built = True
                        ids: list[int] = []
                        mseen: set[int] = set()
                        for lb2 in cand_lbs[n_conn:]:
                            if lb2 not in mseen:
                                mseen.add(lb2)
                                ids.extend(lbs_state[lb2].hostable)
                        if len(ids) >= _MASK_MIN_ALMS:
                            ok_mask = _host_mask(
                                ids, 2 if kind == "pair" else 1,
                                plan.atom_ah_arr[aidx])
                    use_mask = ok_mask
                if replay is not None:
                    replay.open_consult(cand)
                ok = False
                if kind == "pair":
                    ok = host_in_arith([atom[1], atom[2]], cand, strict,
                                       use_mask)
                elif kind == "single5":
                    ok = host_in_arith([atom[1]], cand, strict, use_mask)
                elif kind == "single6":
                    ok = host6_in_arith(atom[1], cand)
                if ok:
                    placed[aidx] = True
                    bump_frontier(aidx)
                    ret = lb_idx if lb_idx is not None else cand
                    if replay is not None:
                        replay.note_atom(aidx, (cand,), ret, len(lbs_state))
                    return ret
                if replay is not None:
                    replay.close_consult(cand)
        ai = materialize_logic_alm(aidx)
        tgt = lb_idx
        if tgt is None or not try_fit_alm(ai, tgt):
            # look for any LB with room before opening a new one
            tgt = None
            for cand in range(len(lbs_state) - 1, max(-1, len(lbs_state) - 9), -1):
                if try_fit_alm(ai, cand):
                    tgt = cand
                    break
            if tgt is None:
                tgt = open_lb()
        place_alm(ai, tgt)
        placed[aidx] = True
        bump_frontier(aidx)
        if replay is not None:
            replay.note_atom(aidx, (tgt,), tgt, len(lbs_state))
        return tgt

    cur_lb: int | None = None
    for aidx in plan.run_order:
        if placed[aidx]:
            continue
        cur_lb = place_atom(aidx, cur_lb)
        # pull in connected atoms (chains and LUTs) while there is room —
        # connectivity-ordered packing keeps chain operands local, which is
        # what lets Z pins ride the free direct-link taps.
        while True:
            cand = None
            while frontier_heap:
                negv, _, j = frontier_heap[0]
                if placed[j] or frontier_scores[j] != -negv:
                    heapq.heappop(frontier_heap)   # stale or already placed
                    continue
                cand = j
                break
            if cand is None or cur_lb is None:
                break
            before = len(lbs_state)
            cur_lb = place_atom(cand, cur_lb)
            if len(lbs_state) != before:
                break  # spilled into a new LB; go back to chain order

    for aidx in plan.lut_order:
        if not placed[aidx]:
            cur_lb = place_atom(aidx, cur_lb)

    # --- Z timing post-pass (DD only) -----------------------------------
    # Any raw-operand FA still fed through the (now slower) LUT path is
    # moved to the direct Z path when the AddMux budget allows: Table II
    # row 3 — Z->adder is 48 % faster than the baseline LUT route.  This is
    # why the paper's stress tests see *better* critical paths on DD5.
    if arch.concurrent:
        for lbi, st in enumerate(lbs_state):
            for ai in st.alm_ids:
                alm = alms[ai]
                if not alm.is_arith:
                    continue
                for h in alm.halves:
                    if (h.fa is None or h.fa_feed != "lut" or h.absorbed
                            or h.hosted_lut is not None):
                        continue
                    live = plan.bit_live[h.fa]
                    # each live operand *pin* needs its own bypass path,
                    # even when both pins carry the same signal
                    if len(live) > arch.bypass_inputs:
                        continue
                    ops = set(live)
                    z_ext = ops - st.produced if arch.z_local_free else ops
                    if len(st.z_ext | z_ext) > arch.z_sources:
                        continue
                    h.fa_feed = "z"
                    st.z_ext |= z_ext

    return PackedCircuit(
        net=net, arch=arch, alms=alms, lbs=lb_list, lut_site=lut_site,
        chain_site=chain_site, alm_lb=alm_lb, concurrent_luts=concurrent,
    )
