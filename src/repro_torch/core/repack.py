"""Incremental repacking: one arch-invariant prefix, many re-clusterings.

:func:`repro_torch.core.packing.pack` is two stages with very different
architecture sensitivity:

* the **prefix** — absorption pre-pass, chain slotting, LUT pairing and
  the cluster plan (atom list, connectivity indexes, placement orders) —
  depends only on the netlist and the placement seed, never on cluster
  geometry (``alms_per_lb``, ``lb_inputs``, ``ext_pin_util``,
  ``z_sources``);
* the **clustering** stage replays the shared atom list under one grid
  point's LB budgets and is the only part that must re-run per
  structural class.

:func:`pack_prefix` computes the first once per (circuit, seed);
:func:`repack` replays the second against any :class:`ArchParams` row.
``pack(net, arch, seed)`` is now literally ``repack(pack_prefix(net,
seed), arch)``, so both paths are byte-identical by construction — the
structural-grid oracle-parity tests (``tests/core/test_repack.py``) and
the pinned Fig-5/Table-III numbers hold it there.

A sweep over the cluster-geometry axes therefore costs::

    prefixes:    n_circuits                  (once, the expensive part)
    reclusters:  n_circuits x n_classes      (cheap greedy replay)

instead of ``n_circuits x n_classes`` full packs, and the lowering side
pairs with it: :meth:`PackedCircuit.lower_ir` accepts a ``template``
CircuitIR from any sibling class and patches only the columns clustering
can change (sites, LBs, edge delay classes, ALM modes) instead of
re-levelizing the whole netlist (see
:func:`repro_torch.core.circuit_ir.lower_pack_ir_incremental`; the
fresh path shares the same patch over the content-cached functional IR,
so fresh and template lowering are identical by construction).
"""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import numpy as np

from . import plan as _planner
from .alm import ArchParams
from .netlist import CONST1, Netlist
from .packing import (ALM, LAST_PACK_DEBUG, ClusterPlan, Half, PackedCircuit,
                      _atom_sigs_of, _build_cluster_plan, _cluster,
                      _fanout_counts, _pair_luts)

#: first fully-lowered CircuitIR per (netlist digest, seed) — the template
#: sibling structural classes patch instead of re-lowering.  Lives in the
#: shared registry (not on the prefix object) so one
#: :func:`repro_torch.core.plan.clear_caches` provably forces re-lowering and a
#: prefix at another seed can never serve a stale template.
_TEMPLATE_CACHE = _planner.register_cache("ir_template", cap=256)


@dataclass
class PackPrefix:
    """The arch-invariant prefix of a pack: chain-slotted ALM skeleton,
    absorbed-LUT assignment, LUT pairing and the cluster plan.  Immutable
    by convention — :func:`repack` copies every structure clustering
    mutates, so one prefix serves any number of re-clusterings."""

    net: Netlist
    seed: int
    alms: list[ALM]                      # chain-slotted arith skeleton
    chain_site: dict[tuple[int, int], int]
    lut_site: dict[int, int]             # absorbed LUTs only, at this stage
    chain_alm_runs: list[list[int]]
    pairs: list[tuple[int, int]]
    singles6: list[int]
    singles5: list[int]
    plan: ClusterPlan

    def _template_key(self) -> tuple:
        key = self.__dict__.get("_tpl_key")
        if key is None:
            key = (self.net.content_digest(), self.seed)
            self.__dict__["_tpl_key"] = key
        return key

    @property
    def ir_template(self):
        """First fully-lowered :class:`~repro_torch.core.circuit_ir.CircuitIR`
        of this prefix (any structural class) — registry-backed, keyed by
        (netlist content digest, seed)."""
        return _TEMPLATE_CACHE.get(self._template_key())

    @ir_template.setter
    def ir_template(self, ir) -> None:
        if ir is None:
            _TEMPLATE_CACHE.pop(self._template_key())
        else:
            _TEMPLATE_CACHE.put(self._template_key(), ir)


def pack_prefix(net: Netlist, seed: int = 0) -> PackPrefix:
    """Steps 1-3 of :func:`repro_torch.core.packing.pack` (absorption, chain
    slotting, LUT pairing) plus the cluster plan — everything that does
    not depend on the architecture."""
    import random

    rng = random.Random(seed)
    fanout = _fanout_counts(net)

    # --- 1. absorption pre-pass -------------------------------------------
    absorbed_of: dict[tuple[int, int], list[int]] = {}
    lut_absorbed: set[int] = set()
    for ci, ch in enumerate(net.chains):
        for bi in range(len(ch.sums)):
            got: list[int] = []
            for s in (ch.a[bi], ch.b[bi]):
                if s <= CONST1:
                    continue
                drv = net.driver.get(s)
                if (drv is not None and drv[0] == "lut"
                        and fanout[s] == 1
                        and len(net.lut_inputs[drv[1]]) <= 4
                        and drv[1] not in lut_absorbed):
                    got.append(drv[1])
                    lut_absorbed.add(drv[1])
            if got:
                absorbed_of[(ci, bi)] = got

    free_luts = [i for i in range(net.n_luts) if i not in lut_absorbed]

    # --- 2. chain slotting --------------------------------------------------
    alms: list[ALM] = []
    chain_site: dict[tuple[int, int], int] = {}
    lut_site: dict[int, int] = {}
    chain_alm_runs: list[list[int]] = []  # per chain, its ALM indices
    for ci, ch in enumerate(net.chains):
        run: list[int] = []
        for lo in range(0, len(ch.sums), 2):
            halves = []
            for bi in (lo, lo + 1):
                if bi < len(ch.sums):
                    ab = absorbed_of.get((ci, bi), [])
                    halves.append(Half(fa=(ci, bi), fa_feed="lut", absorbed=ab))
                else:
                    halves.append(Half())
            alm = ALM(halves=(halves[0], halves[1]), is_arith=True)
            ai = len(alms)
            alms.append(alm)
            run.append(ai)
            for bi in (lo, lo + 1):
                if bi < len(ch.sums):
                    chain_site[(ci, bi)] = ai
                    for li in absorbed_of.get((ci, bi), []):
                        lut_site[li] = ai
        chain_alm_runs.append(run)

    # --- 3. LUT pairing -----------------------------------------------------
    pairs, singles6, singles5 = _pair_luts(net, free_luts, rng)

    # --- cluster plan (atom list, connectivity, placement orders) -----------
    plan = _build_cluster_plan(net, alms, chain_alm_runs, chain_site,
                               pairs, singles6, singles5, rng)

    return PackPrefix(net=net, seed=seed, alms=alms, chain_site=chain_site,
                      lut_site=lut_site, chain_alm_runs=chain_alm_runs,
                      pairs=pairs, singles6=singles6, singles5=singles5,
                      plan=plan)


def _copy_skeleton(alms: list[ALM]) -> list[ALM]:
    """Fresh ALM objects for one re-clustering — clustering mutates
    halves (hosting, Z conversion) and appends logic ALMs, so the
    prefix's skeleton must never be handed out directly."""
    # bypasses the dataclass constructors (keyword plumbing is ~2x the
    # cost of the copy itself on large skeletons); absorbed lists are
    # shared — clustering never mutates them
    new_half, new_alm = Half.__new__, ALM.__new__
    out: list[ALM] = []
    for alm in alms:
        h0, h1 = alm.halves
        c0 = new_half(Half)
        c0.fa, c0.fa_feed = h0.fa, h0.fa_feed
        c0.absorbed, c0.hosted_lut = h0.absorbed, h0.hosted_lut
        c1 = new_half(Half)
        c1.fa, c1.fa_feed = h1.fa, h1.fa_feed
        c1.absorbed, c1.hosted_lut = h1.absorbed, h1.hosted_lut
        a2 = new_alm(ALM)
        a2.halves = (c0, c1)
        a2.lut6 = alm.lut6
        a2.is_arith = alm.is_arith
        out.append(a2)
    return out


def cluster_delta(base: PackedCircuit, new: PackedCircuit) -> dict:
    """Per-cluster membership diff between two packs of the *same arch*
    — the flow server's delta-path attribution (how much of a
    ``base_digest`` request's packing actually changed).

    An LB is *changed* when its multiset of ALM occupancies differs —
    ALM identity is taken structurally (the FA bits and hosted/absorbed
    LUT indices of each half, plus arith/lut6 flags), so two packs of
    netlists that share atom numbering (the delta-request contract)
    compare meaningfully.  Surviving clusters split into *frozen* (same
    signature at the same LB index) and *moved* (same signature at a
    different index — a pure renumbering); the remainder is
    *re-clustered* (membership actually changed).  Returns
    ``{"n_lbs_base", "n_lbs_new", "n_changed", "unchanged_frac",
    "n_frozen", "n_moved", "n_reclustered"}`` with ``n_reclustered ==
    n_changed`` (kept under both names for the serve delta contract);
    byte-identical packs report 0 changed clusters."""

    def alm_sig(pack: PackedCircuit, ai: int) -> tuple:
        alm = pack.alms[ai]
        return tuple((h.fa, h.fa_feed, tuple(h.absorbed), h.hosted_lut)
                     for h in alm.halves) + (alm.is_arith, alm.lut6)

    def lb_sigs(pack: PackedCircuit) -> list[tuple]:
        # sort by repr: signature fields mix None with tuples/ints, which
        # have no direct ordering — only a canonical multiset order is
        # needed, not a meaningful one
        return [tuple(sorted((alm_sig(pack, ai) for ai in lb.alms),
                             key=repr))
                for lb in pack.lbs]

    base_sigs = lb_sigs(base)
    new_sigs = lb_sigs(new)
    # greedy signature matching: clusters that survive verbatim cancel
    # out, position-independently (re-clustering may renumber LBs)
    surviving = Counter(base_sigs) & Counter(new_sigs)
    n_same = sum(surviving.values())
    n_changed = max(len(base_sigs), len(new_sigs)) - n_same
    # positional matches are always a valid subset of the Counter
    # matching (each consumes one base and one new copy of the same
    # signature), so frozen + moved partitions the survivors exactly
    n_frozen = sum(1 for b, n in zip(base_sigs, new_sigs) if b == n)
    return {
        "n_lbs_base": len(base_sigs),
        "n_lbs_new": len(new_sigs),
        "n_changed": int(n_changed),
        "unchanged_frac": n_same / max(len(new_sigs), 1),
        "n_frozen": int(n_frozen),
        "n_moved": int(n_same - n_frozen),
        "n_reclustered": int(n_changed),
    }


def repack(prefix: PackPrefix, arch: ArchParams,
           allow_unrelated: bool = True, strict_phases: tuple = (False,),
           pull_runs: bool = False) -> PackedCircuit:
    """Replay the clustering stage of ``pack()`` under ``arch``'s LB
    budgets.  Byte-identical to ``pack(prefix.net, arch, prefix.seed)``
    by construction, at the cost of one skeleton copy instead of the
    whole prefix."""
    LAST_PACK_DEBUG.clear()
    return _cluster(prefix.net, arch, _copy_skeleton(prefix.alms),
                    prefix.chain_alm_runs, prefix.plan,
                    dict(prefix.chain_site), dict(prefix.lut_site),
                    allow_unrelated=allow_unrelated,
                    strict_phases=strict_phases, pull_runs=pull_runs)


# =========================================================================
# Cluster-local incremental repack
# =========================================================================
#
# The greedy clusterer is a long sequence of *decisions* (per atom: which
# LBs were probed, which rejected, which accepted) over state that is
# almost entirely LB-local.  ``RepackLog`` records one real re-clustering
# at decision granularity; ``ReplayAdvisor`` replays a later
# re-clustering of an *edited* netlist against that log, skipping every
# probe whose verdict provably transfers (same atom sequence, same
# consult order, LB untouched by any divergence so far) and applying the
# recorded scan side effects (hostable prunes/reinserts, capacity-set
# discards) verbatim.  Everything else — every consult of a diverged LB,
# every dirty atom, every accept — runs the real code, so the result is
# byte-identical to a fresh ``pack()`` of the edited netlist by
# construction: the advisor only ever *verifies* that base state mirrors
# fresh state, it never steers a decision.  Any detected divergence
# demotes the involved LBs to the dirty set (always real-scanned from
# then on); the dirty-set growth bound and the order/LB-count checks are
# the escape hatches that degrade advice to a plain full re-cluster.


class RepackLog:
    """Decision log of one real re-clustering (record mode).

    Hook API consumed by :func:`repro_torch.core.packing._cluster` via its
    ``replay`` parameter: ``start_atom`` opens a step,
    ``open_consult``/``close_consult`` bracket one LB scan, ``ev_*``
    capture the scan's state side effects, ``note_atom`` seals the step
    with its outcome.  Recording is observation-only — a logged
    re-clustering is byte-identical to an unlogged one.

    Storage is **per LB**, not per step: ``hist[lb]`` is the ordered
    stream of operations that touched that LB — reject scans (with
    their pruning events), accepting scans, and whole-ALM commits (run
    bits, materializations).  An LB's state is a pure function of its
    op stream plus the acting atoms' data, which is what lets
    :class:`ReplayAdvisor` transfer verdicts *order-tolerantly*: the
    greedy loop of an edited netlist may visit atoms in a different
    global order (frontier scores shift), but any LB whose op stream
    still matches entry-for-entry is provably in the same state."""

    #: hist entry kinds
    REJ, ACC, COMMIT = 0, 1, 2
    #: event codes inside one consult, in firing order
    EV_POP, EV_INS, EV_CAPD = 0, 1, 2

    def __init__(self, arch: ArchParams, allow_unrelated: bool,
                 strict_phases: tuple, pull_runs: bool):
        self.arch = arch
        self.allow_unrelated = allow_unrelated
        self.strict_phases = tuple(strict_phases)
        self.pull_runs = pull_runs
        #: per-LB op stream: list of (kind, aidx, evs-tuple-or-None)
        self.hist: list[list[tuple]] = []
        #: per-atom outcome + consult footprint (ownership columns)
        self.atom_touched: dict[int, tuple] = {}
        self.atom_consults: dict[int, tuple] = {}
        self._aidx = -1
        self._step_lbs: list[int] = []
        self._fired: list | None = None
        self._open: int | None = None

    def _row(self, lb: int) -> list:
        hist = self.hist
        while len(hist) <= lb:
            hist.append([])
        return hist[lb]

    # -- record hooks ----------------------------------------------------
    def start_atom(self, aidx: int):
        self._aidx = aidx
        self._step_lbs = []
        self._fired = None
        self._open = None
        return None

    def open_consult(self, lb: int) -> None:
        self._step_lbs.append(lb)
        self._fired = None
        self._open = lb

    def ev_pop(self, lb: int, ai: int) -> None:
        f = self._fired
        if f is None:
            f = self._fired = []
        f.append((self.EV_POP, ai))

    def ev_ins(self, lb: int, ai: int) -> None:
        f = self._fired
        if f is None:
            f = self._fired = []
        f.append((self.EV_INS, ai))

    def ev_capd(self, lb: int) -> None:
        f = self._fired
        if f is None:
            f = self._fired = []
        f.append((self.EV_CAPD, -1))

    def close_consult(self, lb: int) -> None:
        self._row(lb).append(
            (self.REJ, self._aidx, tuple(self._fired) if self._fired
             else None))
        self._fired = None
        self._open = None

    def note_atom(self, aidx: int, touched: tuple, ret: int | None,
                  n_lbs: int) -> None:
        if self._open is not None:
            # host-accept exit: the only path reaching note_atom with an
            # unclosed consult
            self._row(self._open).append(
                (self.ACC, aidx, tuple(self._fired) if self._fired
                 else None))
        else:
            # run bits / materialization: one whole-ALM commit per
            # touched LB, in placement order
            for lb in touched:
                self._row(lb).append((self.COMMIT, aidx, None))
        self.atom_touched[aidx] = touched
        self.atom_consults[aidx] = tuple(self._step_lbs)
        self._fired = None
        self._open = None

    # -- queries ---------------------------------------------------------
    def n_ops(self) -> int:
        return sum(len(r) for r in self.hist)

    def ownership(self) -> tuple[np.ndarray, list]:
        """Per-atom owner LB (the last LB the step committed into; -1
        for never-committed steps) and per-atom consulted-LB dependency
        lists — the ClusterPlan ownership columns of a delta plan."""
        n = max(self.atom_touched, default=-1) + 1
        owner = np.full(n, -1, np.int64)
        deps: list = [()] * n
        for aidx, t in self.atom_touched.items():
            if t:
                owner[aidx] = t[-1]
            deps[aidx] = self.atom_consults.get(aidx, ())
        return owner, deps


class ReplayAdvisor:
    """Advise mode: replay an edited re-clustering against a base
    :class:`RepackLog`, skipping provably-transferable reject scans.

    Soundness discipline — per-LB verified sync.  The advisor keeps a
    pointer ``hp[lb]`` into each LB's logged op stream.  A reject scan
    of a clean LB is skipped only when the stream's next entry is a
    reject *by the same atom* (same atom + same LB state ⇒ same verdict
    and same pruning side effects, which are applied verbatim); every
    real scan of a clean LB is verified against the stream (same fired
    events advance the pointer, anything else — unexpected events, an
    accept where base rejected or vice versa, a commit by a different
    atom — demotes the LB to ``div``: diverged, never skipped again).
    Eventless reject scans are state-neutral and never break sync.
    Atom order may diverge freely: sync is per LB, not global.

    Escape hatches: dirty atoms (edited data) are never skipped and any
    LB they commit into diverges; ``len(div) > max_div`` turns advice
    off entirely (``fallback`` — the rest of the run is a plain full
    re-cluster); ``unsound`` flags a recorded event that failed to
    apply (the sync invariant was broken), after which callers must
    discard the result and re-cluster fully."""

    def __init__(self, log: RepackLog, dirty_atoms, max_div: int = 32):
        self.log = log
        self.dirty = frozenset(dirty_atoms)
        self.max_div = max_div
        self.active = True
        self.fallback = False
        self.unsound = False
        self.off_reason: str | None = None
        self.div: set[int] = set()
        self.n_skipped = 0
        self.n_scanned = 0
        self._hist = log.hist
        self._nhist = len(log.hist)
        self._hp = [0] * self._nhist
        self._aidx = -1
        self._adirty = False
        self._open: int | None = None
        self._mpos = -1
        self._fired: list | None = None

    # -- hooks -----------------------------------------------------------
    def start_atom(self, aidx: int):
        if not self.active:
            return None
        self._aidx = aidx
        self._adirty = aidx in self.dirty
        self._open = None
        self._fired = None
        return None if self._adirty else self

    def try_skip(self, cand: int, lbs_state, host_capacity_lbs) -> bool:
        """One call per enumerated candidate: skip iff the LB is clean
        and its logged stream's next op is this atom's reject; applying
        the recorded pruning events keeps the LB's live state marching
        in step with the log."""
        if not self.active or cand >= self._nhist or cand in self.div:
            return False
        row = self._hist[cand]
        p = self._hp[cand]
        if p >= len(row):
            return False
        kind, aidx, evs = row[p]
        if kind != 0 or aidx != self._aidx:
            return False
        self._hp[cand] = p + 1
        self.n_skipped += 1
        if evs:
            st = lbs_state[cand]
            hostable = st.hostable
            for k, ai in evs:
                if k == 0:        # EV_POP
                    try:
                        hostable.remove(ai)
                    except ValueError:
                        self.unsound = True
                        self._deactivate("event")
                elif k == 1:      # EV_INS — _unhost's positional insert
                    if ai in hostable:
                        self.unsound = True
                        self._deactivate("event")
                    else:
                        pos = st.alm_pos[ai]
                        idx = 0
                        while (idx < len(hostable)
                               and st.alm_pos[hostable[idx]] < pos):
                            idx += 1
                        hostable.insert(idx, ai)
                else:             # EV_CAPD
                    host_capacity_lbs.discard(cand)
        return True

    def open_consult(self, cand: int) -> None:
        if not self.active:
            return
        self.n_scanned += 1
        self._open = cand
        self._fired = None
        self._mpos = -1
        if cand in self.div or cand >= self._nhist:
            return
        self._mpos = self._hp[cand]

    def ev_pop(self, lb: int, ai: int) -> None:
        f = self._fired
        if f is None:
            f = self._fired = []
        f.append((0, ai))

    def ev_ins(self, lb: int, ai: int) -> None:
        f = self._fired
        if f is None:
            f = self._fired = []
        f.append((1, ai))

    def ev_capd(self, lb: int) -> None:
        f = self._fired
        if f is None:
            f = self._fired = []
        f.append((2, -1))

    def close_consult(self, cand: int) -> None:
        if not self.active:
            return
        fired = self._fired
        mpos = self._mpos
        self._open = None
        self._fired = None
        self._mpos = -1
        if mpos < 0:
            # diverged LB: its real scans run unverified (and unskipped)
            return
        row = self._hist[cand]
        if mpos < len(row):
            kind, aidx, evs = row[mpos]
            if kind == 0 and aidx == self._aidx                     and (tuple(fired) if fired else None) == evs:
                self._hp[cand] = mpos + 1   # verified: still in step
                return
        if fired:
            # this scan pruned the LB in a way the log never recorded
            # (or recorded differently): its state now diverges
            self._mark_div(cand)
        # eventless mismatches are state-neutral — sync holds as-is

    def note_atom(self, aidx: int, touched: tuple, ret: int | None,
                  n_lbs: int) -> None:
        if not self.active:
            return
        if self._open is not None:
            # host-accept: a commit into the consulted LB
            cand = self._open
            fired = self._fired
            mpos = self._mpos
            self._open = None
            self._fired = None
            self._mpos = -1
            if cand in self.div:
                pass
            elif self._adirty:
                # edited atom data committed into this LB
                self._mark_div(cand)
            elif mpos >= 0 and cand < self._nhist:
                row = self._hist[cand]
                ok = False
                if mpos < len(row):
                    kind, a2, evs = row[mpos]
                    ok = (kind == 1 and a2 == aidx
                          and (tuple(fired) if fired else None) == evs)
                if ok:
                    self._hp[cand] = mpos + 1
                else:
                    self._mark_div(cand)
            else:
                self._mark_div(cand)
        else:
            # run bits / materialization commits
            for lb in touched:
                if lb in self.div:
                    continue
                if self._adirty or lb >= self._nhist:
                    self._mark_div(lb)
                    continue
                row = self._hist[lb]
                p = self._hp[lb]
                if p < len(row) and row[p][0] == 2 and row[p][1] == aidx:
                    self._hp[lb] = p + 1
                else:
                    self._mark_div(lb)
        if len(self.div) > self.max_div and self.active:
            self._deactivate("growth")
            self.fallback = True

    def _mark_div(self, lb: int) -> None:
        self.div.add(lb)

    def _deactivate(self, reason: str) -> None:
        if self.active:
            self.active = False
            self.off_reason = reason


def repack_with_log(prefix: PackPrefix, arch: ArchParams,
                    allow_unrelated: bool = True,
                    strict_phases: tuple = (False,),
                    pull_runs: bool = False
                    ) -> tuple[PackedCircuit, RepackLog]:
    """:func:`repack` with decision recording — same pack, plus the
    :class:`RepackLog` a later :func:`repack_delta` replays against."""
    log = RepackLog(arch, allow_unrelated, strict_phases, pull_runs)
    LAST_PACK_DEBUG.clear()
    pack = _cluster(prefix.net, arch, _copy_skeleton(prefix.alms),
                    prefix.chain_alm_runs, prefix.plan,
                    dict(prefix.chain_site), dict(prefix.lut_site),
                    allow_unrelated=allow_unrelated,
                    strict_phases=strict_phases, pull_runs=pull_runs,
                    replay=log)
    return pack, log


def netlist_structural_diff(base: Netlist, new: Netlist) -> dict | None:
    """Index-stable structural diff of two netlists, or ``None`` when
    the edit is outside the dirty-set contract (changed shape, edited
    chains, renamed outputs) and the caller must fall back to a full
    :func:`pack_prefix`.  ``changed_inputs`` lists LUTs whose fanin
    tuple changed (the pack-relevant edits); ``changed_tt`` lists
    truth-table-only edits (pack-irrelevant — zero dirty atoms)."""
    if (base.n_signals != new.n_signals or base.n_luts != new.n_luts
            or len(base.chains) != len(new.chains)
            or base.pis != new.pis or base.pos != new.pos):
        return None
    for c0, c1 in zip(base.chains, new.chains):
        if (list(c0.a) != list(c1.a) or list(c0.b) != list(c1.b)
                or list(c0.sums) != list(c1.sums)
                or c0.cin != c1.cin or c0.cout != c1.cout):
            return None
    if list(base.lut_out) != list(new.lut_out):
        return None
    changed_inputs = [li for li in range(base.n_luts)
                      if base.lut_inputs[li] != new.lut_inputs[li]]
    changed_tt = [li for li in range(base.n_luts)
                  if base.lut_tt[li] != new.lut_tt[li]]
    return {"changed_inputs": changed_inputs, "changed_tt": changed_tt}


def _plan_scaffold(prefix: PackPrefix) -> dict:
    """Connectivity scaffolding of a prefix's plan — the indexes
    ``_build_cluster_plan`` discards (atom signal sets, signal->atoms,
    signal->consumers, fanout counts, LUT->atom map) rebuilt once and
    cached on the prefix, so a stream of edits against the same base
    amortizes the O(edges) passes."""
    sc = prefix.__dict__.get("_scaffold")
    if sc is not None:
        return sc
    net, plan = prefix.net, prefix.plan
    atoms = plan.atoms
    atom_sigs = [_atom_sigs_of(net, a) for a in atoms]
    sig2atoms: dict[int, list[int]] = defaultdict(list)
    for idx in range(len(atoms)):
        for s in atom_sigs[idx]:
            sig2atoms[s].append(idx)
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
    atom_of_lut: dict[int, int] = {}
    for idx, atom in enumerate(atoms):
        if atom[0] != "run":
            for li in atom[1:]:
                if isinstance(li, int):
                    atom_of_lut[li] = idx
    sc = {
        "atom_sigs": atom_sigs,
        "sig2atoms": dict(sig2atoms),
        "sig_consumers": dict(sig_consumers),
        "atom_of_lut": atom_of_lut,
        "fanout": Counter(_fanout_counts(net)),
    }
    prefix.__dict__["_scaffold"] = sc
    return sc


def _splice_csr(base_ptr: np.ndarray, base_arrs: tuple, changed: dict
                ) -> tuple:
    """Row-splice a CSR image: replace ``changed``'s rows (``{row:
    (col0_values, col1_values, ...)}``), keep every other row's slice —
    byte-identical to rebuilding the CSR from the patched row lists."""
    n = base_ptr.size - 1
    lens = np.diff(base_ptr)
    for r, vals in changed.items():
        lens[r] = len(vals[0])
    new_ptr = np.zeros(n + 1, base_ptr.dtype)
    np.cumsum(lens, out=new_ptr[1:])
    segs: list[list] = [[] for _ in base_arrs]
    prev = 0
    for r in sorted(changed):
        if prev < r:
            lo, hi = base_ptr[prev], base_ptr[r]
            for k, arr in enumerate(base_arrs):
                segs[k].append(arr[lo:hi])
        vals = changed[r]
        for k, arr in enumerate(base_arrs):
            segs[k].append(np.asarray(vals[k], arr.dtype))
        prev = r + 1
    if prev < n:
        lo, hi = base_ptr[prev], base_ptr[n]
        for k, arr in enumerate(base_arrs):
            segs[k].append(arr[lo:hi])
    new_arrs = tuple(
        np.concatenate(segs[k]) if segs[k] else base_arrs[k][:0]
        for k in range(len(base_arrs)))
    return (new_ptr,) + new_arrs


def pack_prefix_delta(base: PackPrefix, new_net: Netlist,
                      base_log: RepackLog | None = None,
                      diff: dict | None = None
                      ) -> tuple[PackPrefix | None, dict]:
    """Diff an edited netlist against a base prefix and build the edited
    prefix by splicing only the dirty rows of the base
    :class:`ClusterPlan` — byte-identical to ``pack_prefix(new_net,
    base.seed)`` whenever it returns a prefix.

    Eligibility gates (each one falls back to ``(None, {"reason":
    ...})`` and the caller runs the full prefix build): index-stable
    shape diff, no chain edits, no edits to absorbed LUTs, unchanged
    absorption decisions, unchanged LUT pairing.  The returned info dict
    names the ``dirty_atoms`` the re-clustering must treat as edited."""
    if diff is None:
        diff = netlist_structural_diff(base.net, new_net)
    if diff is None:
        return None, {"reason": "shape"}
    edited = diff["changed_inputs"]
    plan = base.plan
    if not edited:
        # tt-only edit: the prefix is pack-identical — share everything
        # (repack copies every structure clustering mutates)
        new_prefix = PackPrefix(
            net=new_net, seed=base.seed, alms=base.alms,
            chain_site=base.chain_site, lut_site=base.lut_site,
            chain_alm_runs=base.chain_alm_runs, pairs=base.pairs,
            singles6=base.singles6, singles5=base.singles5, plan=plan)
        if "_scaffold" in base.__dict__:
            new_prefix.__dict__["_scaffold"] = base.__dict__["_scaffold"]
        return new_prefix, {"mode": "tt_only", "dirty_atoms": frozenset(),
                            "changed_tt": diff["changed_tt"]}
    edited_set = set(edited)
    if any(li in base.lut_site for li in edited):
        # prefix-stage lut_site holds exactly the absorbed LUTs; editing
        # one rewrites skeleton ALM IO — full rebuild territory
        return None, {"reason": "absorbed_edit"}
    sc = _plan_scaffold(base)
    fanout = sc["fanout"]
    sig_consumers = sc["sig_consumers"]

    # --- absorption gate: the pre-pass must make identical decisions ----
    # Its predicate per chain operand reads only the operand's fanout and
    # its driver LUT's arity, so only operands touched by a changed
    # fanout count or a changed driver arity need rechecking.
    delta_fan: Counter = Counter()
    for li in edited:
        for s in base.net.lut_inputs[li]:
            delta_fan[s] -= 1
        for s in new_net.lut_inputs[li]:
            delta_fan[s] += 1
    new_fanout = fanout.copy()
    new_fanout.update(delta_fan)
    recheck = {s for s, d in delta_fan.items() if d and s > CONST1}
    recheck.update(new_net.lut_out[li] for li in edited)
    for s in recheck:
        for cons in sig_consumers.get(s, ()):
            if cons[0] != "chain":
                continue
            drv = new_net.driver.get(s)
            if drv is None or drv[0] != "lut":
                continue
            li2 = drv[1]
            was = li2 in base.lut_site
            now = (new_fanout[s] == 1
                   and len(new_net.lut_inputs[li2]) <= 4
                   and s > CONST1)
            if was != now:
                return None, {"reason": "absorption"}

    # --- pairing gate ---------------------------------------------------
    free_luts = [i for i in range(new_net.n_luts) if i not in base.lut_site]
    pairs, singles6, singles5 = _pair_luts(new_net, free_luts, None)
    if (pairs != base.pairs or singles6 != base.singles6
            or singles5 != base.singles5):
        return None, {"reason": "pairing"}

    # --- dirty rows -----------------------------------------------------
    atom_of_lut = sc["atom_of_lut"]
    dirty_atoms = sorted({atom_of_lut[li] for li in edited})
    atoms = plan.atoms
    old_sigs = sc["atom_sigs"]
    new_dirty_sigs = {d: _atom_sigs_of(new_net, atoms[d])
                      for d in dirty_atoms}
    changed_sigs: set[int] = set()
    for d in dirty_atoms:
        changed_sigs |= old_sigs[d] ^ new_dirty_sigs[d]

    # signal -> atoms rows touched by membership changes
    sig2atoms = sc["sig2atoms"]
    patched_s2a: dict[int, list[int]] = {}
    dirty_set = set(dirty_atoms)
    for s in changed_sigs:
        row = [a for a in sig2atoms.get(s, ()) if a not in dirty_set]
        for d in dirty_atoms:
            if s in new_dirty_sigs[d]:
                bisect.insort(row, d)
        patched_s2a[s] = row

    # signal -> consumers rows touched by occurrence changes
    changed_cons: set[int] = set()
    per_lut_delta: dict[int, tuple[Counter, Counter]] = {}
    for li in edited:
        oldc = Counter(s for s in base.net.lut_inputs[li] if s > CONST1)
        newc = Counter(s for s in new_net.lut_inputs[li] if s > CONST1)
        per_lut_delta[li] = (oldc, newc)
        for s in set(oldc) | set(newc):
            if oldc[s] != newc[s]:
                changed_cons.add(s)
    patched_cons: dict[int, list[tuple]] = {}
    for s in changed_cons:
        row = sig_consumers.get(s, ())
        lut_entries = [e for e in row
                       if e[0] == "lut" and e[1] not in edited_set]
        chain_entries = [e for e in row if e[0] == "chain"]
        lis = sorted(set(e[1] for e in lut_entries)
                     | {li for li in edited
                        if per_lut_delta[li][1].get(s, 0)})
        cnt_of = {e[1]: 0 for e in lut_entries}
        for e in lut_entries:
            cnt_of[e[1]] += 1
        merged: list[tuple] = []
        for li in lis:
            n = (per_lut_delta[li][1].get(s, 0) if li in edited_set
                 else cnt_of[li])
            merged.extend([("lut", li)] * n)
        patched_cons[s] = merged + chain_entries

    def s2a(s):
        r = patched_s2a.get(s)
        return r if r is not None else sig2atoms.get(s, ())

    def consumers(s):
        r = patched_cons.get(s)
        return r if r is not None else sig_consumers.get(s, ())

    # --- neighbor rows (frontier counts): dirty atoms + every sharer of
    # a membership-changed signal.  Reused signal sets iterate in the
    # exact order a fresh build would construct them (same insertion
    # sequence), so row entry order — which is semantic: frontier ties
    # break by first-seen — is preserved.
    nbr_rows = set(dirty_atoms)
    for s in changed_sigs:
        nbr_rows.update(sig2atoms.get(s, ()))
        nbr_rows.update(a for a in patched_s2a[s])
    new_neighbors = list(plan.atom_neighbors)
    nbr_changed_csr: dict[int, tuple] = {}
    for j in sorted(nbr_rows):
        sigs_j = new_dirty_sigs.get(j) or old_sigs[j]
        agg: dict[int, int] = {}
        for s in sigs_j:
            for k in s2a(s):
                agg[k] = agg.get(k, 0) + 1
        row = list(agg.items())
        new_neighbors[j] = row
        nbr_changed_csr[j] = ([k for k, _ in row], [c for _, c in row])

    # --- candidate-probe rows: dirty atoms + producers of signals whose
    # consumer multiset changed (their out-consumer probe entries moved)
    cand_rows = set(dirty_atoms)
    for s in changed_cons:
        drv = new_net.driver.get(s)
        if drv is not None and drv[0] == "lut":
            a = atom_of_lut.get(drv[1])
            if a is not None:
                cand_rows.add(a)
    new_cand_ops = list(plan.atom_cand_ops)
    cand_changed_csr: dict[int, tuple] = {}
    for j in sorted(cand_rows):
        ops: list[tuple[int, int]] = []
        for li in atoms[j][1:]:
            if isinstance(li, int):
                for s in new_net.lut_inputs[li]:
                    ops.append((0, s))
                for cons in consumers(new_net.lut_out[li]):
                    if cons[0] == "chain":
                        ops.append((1, base.chain_site[(cons[1], cons[2])]))
                    else:
                        ops.append((2, cons[1]))
        new_cand_ops[j] = ops
        cand_changed_csr[j] = ([op for op, _ in ops], [p for _, p in ops])

    # --- per-dirty-atom IO rows -----------------------------------------
    new_atom_io = list(plan.atom_io)
    new_ah_arr = list(plan.atom_ah_arr) if plan.atom_ah_arr is not None \
        else None
    for d in dirty_atoms:
        ah: set[int] = set()
        prod: set[int] = set()
        for li in atoms[d][1:]:
            if isinstance(li, int):
                ah.update(s for s in new_net.lut_inputs[li] if s > CONST1)
                prod.add(new_net.lut_out[li])
        new_atom_io[d] = (ah, set(), prod)
        if new_ah_arr is not None:
            new_ah_arr[d] = np.array(sorted(ah), np.int32)

    # --- CSR splices ----------------------------------------------------
    if plan.cand_ptr is not None:
        nbr_ptr, nbr_j, nbr_cnt = _splice_csr(
            plan.nbr_ptr, (plan.nbr_j, plan.nbr_cnt), nbr_changed_csr)
        cand_ptr, cand_code, cand_payload = _splice_csr(
            plan.cand_ptr, (plan.cand_code, plan.cand_payload),
            cand_changed_csr)
    else:
        nbr_ptr = nbr_j = nbr_cnt = None
        cand_ptr = cand_code = cand_payload = None

    owner, deps = (base_log.ownership() if base_log is not None
                   else (None, None))
    new_plan = ClusterPlan(
        atoms=atoms, run_order=plan.run_order, lut_order=plan.lut_order,
        skeleton_io=plan.skeleton_io, atom_io=new_atom_io,
        atom_neighbors=new_neighbors, bit_live=plan.bit_live,
        atom_cand_ops=new_cand_ops, cand_ptr=cand_ptr,
        cand_code=cand_code, cand_payload=cand_payload, nbr_ptr=nbr_ptr,
        nbr_j=nbr_j, nbr_cnt=nbr_cnt, atom_ah_arr=new_ah_arr,
        skel_fh=plan.skel_fh, skel_need=plan.skel_need,
        skel_moved=plan.skel_moved, skel_ah_len=plan.skel_ah_len,
        skel_ah_pad=plan.skel_ah_pad, atom_owner_lb=owner,
        atom_dep_lbs=deps)
    new_prefix = PackPrefix(
        net=new_net, seed=base.seed, alms=base.alms,
        chain_site=base.chain_site, lut_site=base.lut_site,
        chain_alm_runs=base.chain_alm_runs, pairs=pairs,
        singles6=singles6, singles5=singles5, plan=new_plan)

    # patched scaffold so an edit *stream* diffs against this prefix at
    # patch cost, not O(edges)
    new_sc = {
        "atom_sigs": [new_dirty_sigs.get(i, s)
                      for i, s in enumerate(old_sigs)],
        "sig2atoms": {**sig2atoms, **patched_s2a},
        "sig_consumers": {**sig_consumers, **patched_cons},
        "atom_of_lut": atom_of_lut,
        "fanout": new_fanout,
    }
    new_prefix.__dict__["_scaffold"] = new_sc
    return new_prefix, {
        "mode": "incremental",
        "dirty_atoms": frozenset(dirty_atoms),
        "changed_sigs": changed_sigs,
        "changed_tt": diff["changed_tt"],
        "n_plan_rows_patched": len(nbr_rows | cand_rows),
    }


def repack_delta(new_prefix: PackPrefix, base_log: RepackLog | None,
                 arch: ArchParams, dirty_atoms=frozenset(),
                 max_div: int = 32, allow_unrelated: bool = True
                 ) -> tuple[PackedCircuit, dict]:
    """Re-cluster an edited prefix with the base decision log as advice:
    only dirty members (and anything their divergence reaches) re-run
    the real scans; surviving LBs are frozen as placed obstacles whose
    recorded decisions replay without scanning.  Byte-identical to
    ``repack(new_prefix, arch)`` — i.e. to a fresh ``pack()`` of the
    edited netlist — in every mode, including the escape hatches."""
    if (base_log is None or base_log.arch != arch
            or base_log.strict_phases != (False,) or base_log.pull_runs
            or base_log.allow_unrelated != allow_unrelated):
        pack = repack(new_prefix, arch, allow_unrelated=allow_unrelated)
        return pack, {"mode": "full", "reason": "no_log"}
    adv = ReplayAdvisor(base_log, dirty_atoms, max_div=max_div)
    LAST_PACK_DEBUG.clear()
    pack = _cluster(new_prefix.net, arch, _copy_skeleton(new_prefix.alms),
                    new_prefix.chain_alm_runs, new_prefix.plan,
                    dict(new_prefix.chain_site), dict(new_prefix.lut_site),
                    allow_unrelated=allow_unrelated,
                    strict_phases=(False,), pull_runs=False, replay=adv)
    if adv.unsound:
        # a recorded event failed to apply: an earlier skip may have run
        # on diverged state — discard and re-cluster fully
        pack = repack(new_prefix, arch, allow_unrelated=allow_unrelated)
        return pack, {"mode": "fallback", "reason": "unsound",
                      "n_skipped": adv.n_skipped,
                      "n_scanned": adv.n_scanned}
    info = {
        "mode": ("fallback" if adv.fallback else "incremental"),
        "n_skipped": adv.n_skipped,
        "n_scanned": adv.n_scanned,
        "n_div_lbs": len(adv.div),
        "n_frozen_lbs": max(len(pack.lbs) - len(adv.div), 0),
        "div_lbs": sorted(adv.div),
        "advice_off_reason": adv.off_reason,
    }
    return pack, info
