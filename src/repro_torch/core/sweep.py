"""Architecture design-space sweep: pack once per structural class,
re-time a whole suite across an N-point arch grid in one batched program
(the port of ``repro/core/sweep.py``; the batched backend is the torch
program of :mod:`repro_torch.core.timing_vec`, on the card by default).

The paper compares three hand-picked architectures (baseline / DD5 / DD6).
With :func:`repro_torch.core.alm.make_arch` the DD design space is two integers
(bypass width x AddMux crossbar fan-in, plus the 6-LUT flag) — and because
delays never steer the packer, every grid point of a *structural class*
(:meth:`ArchParams.structural_key`) shares one ``pack()`` and one
:class:`~repro_torch.core.circuit_ir.CircuitIR`.  A sweep therefore costs:

    packs:   n_circuits x n_structural_classes      (Python, the slow part)
    timing:  one batched device program per class — circuits stacked on
             one axis, the class's delay-table rows on another

instead of ``n_circuits x n_grid_points`` Python timing walks.  This opens
the scenario the paper never measured: ADP frontiers over the
bypass-width x crossbar-population plane (:func:`adp_frontier`).

Results are bit-identical to ``timing.analyze_oracle`` per (circuit, grid
point); ``chip_smoke.py`` holds the sweep to that parity on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from . import plan as _planner
from .alm import ArchParams, group_archs_by_structure
from ..device import resolve_device
from .netlist import Netlist
from .packing import PackedCircuit, pack

#: packing prefixes per (circuit digest, seed) — the default store behind
#: ``sweep_suite(prefixes=None)``.  Registry-backed so ONE
#: :func:`repro_torch.core.plan.clear_caches` drops it together with the IR
#: templates the prefixes hand out (the rule the placement cache follows);
#: callers may still pass their own plain dict.
_PREFIX_CACHE = _planner.register_cache("pack_prefix", cap=64)
from .timing import record_timing_wall


def prefix_for_edit(base, new_net: Netlist, base_log=None, prefixes=None):
    """Resolve an *edited* netlist's packing prefix through the shared
    prefix store, deriving it with
    :func:`repro_torch.core.repack.pack_prefix_delta` on a miss.

    Edited prefixes are hosted under ``(edited pack digest, base content
    digest, base seed)``: pack digest because truth tables never steer
    packing (the same keying as the serving pack store), base digest
    because a delta-derived prefix replays the *base's* decisions, so
    derivations from two different bases must never collide.  On a hit
    whose cached ``.net`` is a different tt-variant of the same packing
    structure, the prefix is rebound to ``new_net`` — every other field
    is structure-only, and the IR template is content-keyed so it simply
    misses for the new truth tables.

    Returns ``(prefix | None, info)``; ``info`` is the
    ``pack_prefix_delta`` info dict plus a ``"store"`` key (``"hit"`` /
    ``"miss"``).  ``None`` means the edit is outside the delta-eligible
    class — the caller re-runs :func:`repro_torch.core.repack.pack_prefix`.
    """
    from dataclasses import replace

    from .repack import pack_prefix_delta

    store = _PREFIX_CACHE if prefixes is None else prefixes
    key = (new_net.pack_digest(), base.net.content_digest(), base.seed)
    hit = store.get(key)
    if hit is not None:
        prefix, info = hit
        info = dict(info, store="hit")
        if prefix.net.content_digest() != new_net.content_digest():
            prefix = replace(prefix, net=new_net)
            # the stored changed_tt describes the stored tt-variant;
            # recompute it against the actual request
            info["changed_tt"] = [
                li for li in range(base.net.n_luts)
                if base.net.lut_tt[li] != new_net.lut_tt[li]]
        return prefix, info
    prefix, info = pack_prefix_delta(base, new_net, base_log=base_log)
    if prefix is not None:
        # the info rides with the prefix: a later hit must replay with
        # the SAME dirty set or the advised re-cluster would trust
        # recorded decisions of atoms whose data changed
        store[key] = (prefix, dict(info))
    return prefix, dict(info, store="miss")
from .timing_vec import (build_suite_timing_program, delay_components,
                         critical_path_numpy, metrics_from_cp)


@dataclass
class SweepResult:
    """records[g][k] is the ``timing.analyze``-shaped metric dict of
    circuit ``g`` under arch ``k`` (plus ``net``/``suite`` keys)."""

    circuits: list[str]
    suites: list[str]
    archs: list[str]
    records: list[list[dict]]
    n_classes: int
    wall: dict = field(default_factory=dict)

    def by_arch(self, arch_name: str) -> list[dict]:
        try:
            k = self.archs.index(arch_name)
        except ValueError:
            raise ValueError(
                f"arch {arch_name!r} not in sweep result (swept: "
                f"{self.archs!r})") from None
        return [row[k] for row in self.records]


def _flatten(nets) -> tuple[list[str], list[Netlist]]:
    if isinstance(nets, dict):
        suites, flat = [], []
        for sname, ns in nets.items():
            for n in ns:
                suites.append(sname)
                flat.append(n)
        return suites, flat
    return [""] * len(nets), list(nets)


def _envelope_groups(irs, max_groups: int) -> list[list[int]]:
    """Cluster IRs into <= ``max_groups`` compatible-envelope groups —
    the same shared planner the evaluator uses
    (:func:`repro_torch.core.plan.group_by_envelope`; a :class:`CircuitIR`
    exposes ``.envelope`` / ``.n_signals`` directly, so the old adapter
    shim is gone) — one small circuit must not pad to the suite's widest
    member."""
    from .plan import group_by_envelope

    return group_by_envelope(irs, max_groups=max_groups)


def sweep_suite(nets, archs: Sequence[ArchParams], seed: int = 0,
                max_buckets: int = 3, max_groups: int = 4,
                backend: str = "torch", packs: dict | None = None,
                programs: dict | None = None,
                prefixes: dict | None = None,
                place: bool = False,
                refine: str | None = "anneal",
                device=None) -> SweepResult:
    """Pack + re-time ``nets`` under every arch of the grid.

    ``nets`` is a list of netlists or a ``{suite_name: [netlists]}`` dict.
    The arch-invariant packing prefix (absorption, chain slotting, LUT
    pairing, cluster plan — :func:`repro_torch.core.repack.pack_prefix`) is
    computed once per circuit at ``seed`` and *re-clustered* once per
    structural class, so a grid over pack-affecting knobs (``alms_per_lb``,
    ``lb_inputs``, ``ext_pin_util``, ``z_sources``, bypass width) costs
    ``n_circuits`` prefixes + cheap re-clusterings instead of
    ``n_circuits x n_classes`` full packs.  Lowering is incremental too:
    the first class lowers each circuit fully, sibling classes patch that
    template's placement-derived columns
    (:func:`repro_torch.core.circuit_ir.lower_pack_ir_incremental`; fresh
    lowering shares the same placement patch over the content-cached
    functional IR, so levelization runs once per circuit digest).

    Timing runs as <= ``max_groups`` batched torch programs per class on
    ``device`` (default: the card; circuits clustered by envelope
    compatibility so small members do not pad to the widest one;
    ``backend="torch"``, the counterpart of the reference's default
    ``"jax"``) or as per-circuit numpy level walks (``backend="numpy"`` —
    still vectorized, host only; useful for tiny grids).

    Pass ``packs``, ``programs`` and ``prefixes`` (plain dicts,
    caller-owned) to reuse pack results, built timing programs and
    packing prefixes across sweeps.  All caches key on the netlists'
    *content digest* (plus structural key / seed / grouping knobs; the
    program key also holds the device, since a program holds that
    device's tensors), so a cache warmed with one circuit list simply
    misses — never silently serves wrong entries — when reused with a
    different list.  A warm sweep then pays only the batched executions
    — delay tables are data, not shapes.

    ``place=True`` additionally grid-places every circuit and times the
    placed IRs (wire-tier delays included).  Placements are registry-
    cached per ``(circuit digest, arch placement key, seed)`` — the
    placement key is the structural key + grid aspect, *not* the delay
    row — so all wire-delay rows of a class share one placement: a grid
    crossing many wire profiles pays ``n_circuits x n_classes x
    n_aspects`` placements, not one per point (the reuse
    ``benchmarks/place_sweep.py`` gates at >= 2x).  Within a class,
    rows are subgrouped by grid aspect (aspect reshapes the grid, hence
    the hop columns) and each subgroup runs as its own batched program.

    ``refine`` (default ``"anneal"``) anneal-refines every placement
    through :mod:`repro_torch.core.anneal` before timing — transparent to the
    caller, billed separately in ``wall["anneal_s"]`` (a subset of
    ``place_s``).  ``refine=None`` times the raw analytic seeds.  The
    timing-driven mode (``"anneal_timing"``) weights moves by the
    subgroup *representative's* non-wire delay row (the first grid row
    of the class x aspect subgroup) — one placement must still serve
    every wire row of the subgroup, so the wire tiers never steer it.
    """
    from .repack import pack_prefix, repack

    if backend == "jax":
        raise ValueError(
            "the batched timing backend of the port is 'torch' (the "
            "reference's 'jax' program runs on the device in torch here)")
    if backend not in ("torch", "numpy"):
        raise ValueError(f"unknown sweep backend {backend!r}")
    dev = resolve_device(device) if backend == "torch" else None
    suites, flat = _flatten(nets)
    archs = list(archs)
    classes = group_archs_by_structure(archs)
    records: list[list[dict | None]] = [[None] * len(archs) for _ in flat]
    wall = {"pack_s": 0.0, "prefix_s": 0.0, "recluster_s": 0.0,
            "lower_s": 0.0, "place_s": 0.0, "anneal_s": 0.0,
            "build_s": 0.0, "timing_s": 0.0}
    if packs is None:
        packs = {}
    if programs is None:
        programs = {}
    if prefixes is None:
        prefixes = _PREFIX_CACHE
    digests = [net.content_digest() for net in flat]
    suite_key = tuple(digests)
    class_reps = [archs[idx[0]] for idx in classes]
    skeys = [rep.structural_key() for rep in class_reps]
    # --- phase 1: pack + lower, circuit-outer ---------------------------
    # One prefix per circuit, then its re-clusterings and IR patches for
    # every class back to back: the prefix's plan (and the IR template)
    # stay cache-hot across all classes, which a class-outer loop — one
    # touch per prefix per class, 16 circuits apart — would forfeit.
    all_irs: list[list] = [[] for _ in classes]
    for g, net in enumerate(flat):
        prefix = prefixes.get((digests[g], seed))
        t0 = time.perf_counter()
        circ_packs: list[PackedCircuit] = []
        for c, rep in enumerate(class_reps):
            p = packs.get((digests[g], skeys[c], seed))
            if p is None:
                if prefix is None:
                    t1 = time.perf_counter()
                    prefix = pack_prefix(net, seed=seed)
                    prefixes[(digests[g], seed)] = prefix
                    wall["prefix_s"] += time.perf_counter() - t1
                t1 = time.perf_counter()
                p = repack(prefix, rep)
                wall["recluster_s"] += time.perf_counter() - t1
                packs[(digests[g], skeys[c], seed)] = p
            circ_packs.append(p)
        wall["pack_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        for c, p in enumerate(circ_packs):
            tpl = prefix.ir_template if prefix is not None else None
            ir = p.lower_ir(template=tpl)
            if prefix is not None and prefix.ir_template is None:
                prefix.ir_template = ir
            all_irs[c].append(ir)
        wall["lower_s"] += time.perf_counter() - t0
    # --- phase 2: batched timing, class-outer ---------------------------
    # With placement, a class's rows are further subgrouped by grid
    # aspect: aspect reshapes the slot grid (hence every hop column) but
    # wire delays stay pure data, so one placed program per (class,
    # aspect) re-times all of that subgroup's delay rows.
    for c, idx_list in enumerate(classes):
        skey = skeys[c]
        irs = all_irs[c]
        if place:
            by_aspect: dict[float, list[int]] = {}
            for i in idx_list:
                by_aspect.setdefault(archs[i].grid_aspect, []).append(i)
            subgroups = list(by_aspect.values())
        else:
            subgroups = [idx_list]
        for sub_idx in subgroups:
            if place:
                from .anneal import ANNEAL_WALL
                from .circuit_ir import apply_placement
                from .place import placement_for

                rep = archs[sub_idx[0]]
                pkey = rep.placement_key()
                t0 = time.perf_counter()
                a0 = ANNEAL_WALL["s"]
                use_irs = [apply_placement(
                    ir, placement_for(ir, rep, seed, refine=refine))
                    for ir in irs]
                wall["place_s"] += time.perf_counter() - t0
                wall["anneal_s"] += ANNEAL_WALL["s"] - a0
            else:
                pkey = None
                use_irs = irs
            tables = np.stack([archs[i].delay_table() for i in sub_idx])
            if backend == "torch":
                t0 = time.perf_counter()
                # pkey/refine/device last: positions of the pre-placement
                # key elements (suite, skey, seed, buckets, groups) stay
                # stable for callers/tests that probe grouping knobs by
                # index.  refine is part of the key because the program
                # bakes in the placed hop tensors — a program built from
                # analytic placements must never serve annealed rows; the
                # device because a program holds that device's tensors.
                prog_key = (suite_key, skey, seed, max_buckets,
                            max_groups, pkey,
                            refine if place else None, str(dev))
                progs = programs.get(prog_key)
                if progs is None:
                    groups = _envelope_groups(use_irs, max_groups)
                    progs = [(members,
                              build_suite_timing_program(
                                  [use_irs[i] for i in members],
                                  max_buckets=max_buckets, device=dev))
                             for members in groups]
                    programs[prog_key] = progs
                wall["build_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                cps = np.zeros((len(use_irs), len(sub_idx)))
                for members, prog in progs:
                    gcps = prog.run(tables)
                    for row, gi in enumerate(members):
                        cps[gi] = gcps[row]
                wall["timing_s"] += time.perf_counter() - t0
            elif backend == "numpy":
                t0 = time.perf_counter()
                cps = np.zeros((len(use_irs), len(sub_idx)))
                for k in range(len(sub_idx)):
                    comps = delay_components(tables[k])
                    for g, ir in enumerate(use_irs):
                        cps[g, k] = critical_path_numpy(ir, comps)
                wall["timing_s"] += time.perf_counter() - t0
            else:
                raise ValueError(f"unknown sweep backend {backend!r}")
            for g, ir in enumerate(use_irs):
                for k, ai in enumerate(sub_idx):
                    rec = metrics_from_cp(ir, archs[ai], float(cps[g, k]))
                    rec["net"] = flat[g].name
                    rec["suite"] = suites[g]
                    records[g][ai] = rec
    record_timing_wall(wall["timing_s"] + wall["lower_s"] + wall["build_s"],
                       calls=len(flat) * len(archs))
    return SweepResult(
        circuits=[n.name for n in flat], suites=suites,
        archs=[a.name for a in archs], records=records,  # type: ignore
        n_classes=len(classes), wall=wall)


def _geomean(xs):
    xs = [float(x) for x in xs]
    bad = [x for x in xs if not x > 0.0 or not np.isfinite(x)]
    if bad:
        # a non-positive (or NaN/inf) metric ratio is never valid — it
        # means a record upstream is broken; clamping it (the old
        # behaviour) poisoned the whole frontier row by orders of
        # magnitude instead of surfacing the bad record
        raise ValueError(
            f"geomean over metric ratios got non-positive/non-finite "
            f"values {bad[:4]!r} — a sweep record is corrupt")
    return float(np.exp(np.mean(np.log(xs))))


def _circuit_rows(result: SweepResult, circuits) -> list[int]:
    """Record-row indices of ``circuits`` (``None`` = all), with a clear
    error naming any circuit the sweep never evaluated."""
    if circuits is None:
        return list(range(len(result.circuits)))
    idx = []
    for name in circuits:
        try:
            idx.append(result.circuits.index(name))
        except ValueError:
            raise ValueError(
                f"circuit {name!r} not in sweep result (swept: "
                f"{result.circuits!r})") from None
    return idx


def adp_frontier(result: SweepResult, baseline: str | None = None,
                 keys=("area_mwta", "critical_path_ps", "adp"),
                 circuits=None) -> list[dict]:
    """Geomean metric ratios vs the baseline arch, one row per grid point —
    the ADP frontier over the design-space grid (sorted by ADP ratio).

    ``circuits`` restricts the geomean to a named subset — the search
    driver's rung-level frontiers (cheap circuit slice) and the final
    full-suite frontier run through this one code path.  An unknown name
    raises ``ValueError`` instead of surfacing as an opaque KeyError.
    """
    base_name = baseline if baseline is not None else result.archs[0]
    rows_g = _circuit_rows(result, circuits)
    base_all = result.by_arch(base_name)
    base = [base_all[g] for g in rows_g]
    rows = []
    for name in result.archs:
        if name == base_name:
            continue
        recs_all = result.by_arch(name)
        recs = [recs_all[g] for g in rows_g]
        row = {"arch": name}
        for k in keys:
            row[k] = _geomean([r[k] / b[k] for r, b in zip(recs, base)])
        rows.append(row)
    rows.sort(key=lambda r: r.get("adp", 1.0))
    return rows


def oracle_parity(result: SweepResult, nets, archs: Sequence[ArchParams],
                  seed: int = 0, place: bool = False,
                  refine: str | None = "anneal") -> bool:
    """Prove every sweep record's critical path bit-identical to the
    Python oracle (packing under the *actual* arch — structural-class
    pack sharing is part of what this verifies).  With ``place=True``
    the reference is :func:`repro_torch.core.timing.analyze_placed_oracle`
    under the registry-cached placement of each (circuit, placement key)
    — the same placements the sweep consumed (``refine`` must match the
    sweep's), so this also proves the wire-tier gather against the
    per-edge Python walk.  Placements resolve through each grid row's
    *subgroup representative* (the first arch in ``archs`` order sharing
    its placement key), mirroring the sweep's subgrouping — for the
    timing-driven refine mode the representative's delay row is part of
    the placement cache key, so resolving through the row itself would
    anneal a fresh (different) placement and spuriously fail parity."""
    from .timing import analyze_oracle, analyze_placed_oracle

    _, flat = _flatten(nets)
    reps: dict[tuple, ArchParams] = {}
    rep_for = [reps.setdefault(a.placement_key(), a) for a in archs]
    for g, net in enumerate(flat):
        for k, arch in enumerate(archs):
            p = pack(net, arch, seed=seed)
            if place:
                from .place import placement_for

                pl = placement_for(p.lower_ir(), rep_for[k], seed,
                                   refine=refine)
                ro = analyze_placed_oracle(p, pl)
            else:
                ro = analyze_oracle(p)
            if ro["critical_path_ps"] != result.records[g][k][
                    "critical_path_ps"]:
                return False
            if ro["area_mwta"] != result.records[g][k]["area_mwta"]:
                return False
    return True
