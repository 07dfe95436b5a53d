"""Budget-aware Pareto-front successive halving over the full arch grid
(the port of ``repro/core/search.py``).

:func:`repro_torch.core.alm.full_arch_grid` spans ~2000 grid points / ~1200
structural classes; dense-sweeping it means ~1200 greedy re-clusterings
of *every* circuit — the big Koios members dominate and the sweep engine
spends almost all its wall on architectures that were never contenders.
Successive halving inverts that: every grid point is first scored on a
cheap circuit subset (the smallest-by-node slice of the suite), only the
per-rung survivors — the ADP Pareto front plus the top-ADP fill — are
promoted to larger subsets, and only the last few points ever touch the
full suite.

Everything expensive is shared across rungs through the registry caches
(:mod:`repro_torch.core.plan`): packing prefixes (``pack_prefix``), per-class
re-clusterings (``search_packs``) and compiled timing programs
(``search_programs``), so promoting a survivor to a bigger subset never
repeats the work its earlier rungs already did, and
:func:`repro_torch.core.plan.clear_caches` provably drops all of it.

Determinism: the rung schedule, the circuit subsets (sorted by node
count, circuit name breaking ties), survivor selection (``(adp, name)``
tie-breaks) and the bandit threshold are all pure functions of
``(nets, archs, seed, eta, budget)`` — two runs with the same inputs
produce identical survivor sets and identical payloads (modulo walls),
which ``tests/test_torch_search.py`` pins against the reference.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

from . import plan as _planner
from .alm import ArchParams
from .netlist import Netlist
from .sweep import SweepResult, adp_frontier, sweep_suite

#: per-(digest, structural key, seed) re-clusterings shared by every rung
#: that touches the class — registered so ``clear_caches()`` drops them
_PACK_CACHE = _planner.register_cache("search_packs", cap=8192)
#: built batched timing programs (torch backend only; keyed by device)
_PROG_CACHE = _planner.register_cache("search_programs", cap=256)

#: bandit optimism: keep any arch whose rung ADP is within
#: ``_BANDIT_C / sqrt(n_circuits)`` of the rung best — small subsets are
#: noisy estimates of the full-suite geomean, so early rungs keep a wide
#: optimistic band that tightens as subsets grow
_BANDIT_C = 0.25


def net_size(net: Netlist) -> int:
    """Node count used to order circuits cheapest-first."""
    return net.n_luts + net.n_adders


def circuit_schedule(nets, n_rungs: int, min_circuits: int = 3):
    """Nested smallest-first circuit subsets, growing geometrically from
    ``min_circuits`` to the full suite over ``n_rungs`` rungs."""
    ordered = sorted(nets, key=lambda n: (net_size(n), n.name))
    total = len(ordered)
    lo = min(min_circuits, total)
    if n_rungs <= 1:
        return [ordered]
    sizes = []
    for r in range(n_rungs):
        frac = r / (n_rungs - 1)
        sizes.append(max(lo, round(lo * (total / lo) ** frac)))
    sizes[-1] = total
    return [ordered[:s] for s in sizes]


def pareto_front(rows, x: str = "area_mwta",
                 y: str = "critical_path_ps") -> list[dict]:
    """Non-dominated frontier rows (minimize both axes), in ``(adp,
    name)`` order.  Ties on both axes keep the first by name."""
    front = []
    for r in sorted(rows, key=lambda r: (r["adp"], r["arch"])):
        if not any(o[x] <= r[x] and o[y] <= r[y]
                   and (o[x] < r[x] or o[y] < r[y]) for o in rows):
            front.append(r)
    return front


def select_survivors(rows, k: int, allocation: str = "halving",
                     n_circuits: int = 1) -> list[str]:
    """Names of the archs promoted out of a rung.

    ``halving``: the ADP Pareto front, filled to ``k`` with the best
    remaining ADP rows.  ``bandit``: additionally every arch whose rung
    ADP lies within the optimism band ``1 + _BANDIT_C / sqrt(n_circuits)``
    of the rung best (successive-halving's fixed cull can kill a point
    whose small-subset estimate is unluckily bad; the band keeps it alive
    while estimates are noisy), capped at ``2k`` by ADP order.
    """
    if allocation not in ("halving", "bandit"):
        raise ValueError(f"unknown allocation {allocation!r}")
    ordered = sorted(rows, key=lambda r: (r["adp"], r["arch"]))
    names = {r["arch"] for r in pareto_front(rows)}
    if allocation == "bandit" and ordered:
        thresh = ordered[0]["adp"] * (
            1.0 + _BANDIT_C / math.sqrt(max(n_circuits, 1)))
        names |= {r["arch"] for r in ordered if r["adp"] <= thresh}
        cap = max(2 * k, 1)
        if len(names) > cap:
            names = set([r["arch"] for r in ordered
                         if r["arch"] in names][:cap])
    for r in ordered:
        if len(names) >= k:
            break
        names.add(r["arch"])
    return sorted(names)


@dataclass
class SearchResult:
    """Everything a recorded search needs: the rung trajectory, the final
    full-suite frontier, and the budget ledger."""

    archs: list[str]                 # the searched grid, input order
    baseline: str
    rungs: list[dict]                # per-rung records (see payload())
    frontier: list[dict]             # final-rung ADP frontier rows
    pareto: list[dict]               # final-rung Pareto front
    winner: str
    budget: dict
    final: SweepResult | None = None
    walls: dict = field(default_factory=dict)
    verify: dict | None = None       # verify_winners report, when run

    def survivor_trajectory(self) -> list[list[str]]:
        return [r["survivors"] for r in self.rungs]

    def payload(self) -> dict:
        """JSON-able, deterministic record (walls carried separately per
        rung under ``"walls"`` — drop those keys when comparing runs)."""
        return {
            "n_archs": len(self.archs),
            "baseline": self.baseline,
            "winner": self.winner,
            "budget": self.budget,
            "rungs": self.rungs,
            "frontier": self.frontier,
            "pareto": self.pareto,
        }


def _wall_split(sweep_wall: dict, eval_s: float) -> dict:
    """The per-rung pack / lower / place / anneal / time / eval wall
    split.  ``anneal_s`` is the annealing share *inside* ``place_s``
    (refinement runs during the placement phase), billed separately so
    placed-search ledgers show what refinement itself costs per rung."""
    return {
        "pack_s": sweep_wall["pack_s"],
        "prefix_s": sweep_wall["prefix_s"],
        "recluster_s": sweep_wall["recluster_s"],
        "lower_s": sweep_wall["lower_s"],
        "place_s": sweep_wall["place_s"],
        "anneal_s": sweep_wall["anneal_s"],
        "time_s": sweep_wall["build_s"] + sweep_wall["timing_s"],
        "eval_s": eval_s,
    }


def search_archs(nets, archs, seed: int = 0, eta: int = 4,
                 min_survivors: int = 8, min_circuits: int = 3,
                 allocation: str = "halving", budget: int | None = None,
                 baseline: str | None = None, backend: str = "numpy",
                 max_groups: int = 4, place: bool = False,
                 refine: str | None = "anneal",
                 packs=None, programs=None, prefixes=None,
                 device=None) -> SearchResult:
    """Pareto-aware successive-halving search over ``archs``.

    The rung schedule divides the grid by ``eta`` per rung until
    ``min_survivors`` remain, while the circuit subset grows from the
    ``min_circuits`` smallest members to the full suite; the final rung
    is always the full suite.  ``budget`` caps the total number of
    (circuit x arch) evaluations — when a rung would overrun it, its
    circuit subset is trimmed (never below ``min_circuits``); if even the
    trimmed rung does not fit, the search stops early and the last
    completed rung's survivors become final.  The baseline row rides
    along every rung (frontier ratios need it) and is never culled.

    ``backend="numpy"`` (default) re-times each rung as vectorized level
    walks on the host — the right trade for wide rungs where every
    structural class would otherwise build its own program; pass
    ``"torch"`` to time each class as a batched program on ``device``
    (default: the card).

    ``prefixes`` overrides the shared ``pack_prefix`` store the rungs'
    sweeps read packing prefixes from — the store that also hosts
    edited-netlist prefixes (:func:`repro_torch.core.sweep.prefix_for_edit`,
    keyed by ``(pack digest, base digest, seed)``), so a search run over
    a netlist and its structural edits shares every delta-derived
    prefix with the serving layer.

    ``place=True`` runs every rung placed: each rung's sweep subgroups
    its grid rows by ``placement_key`` (structural class x grid aspect),
    anneal-refines one placement per (circuit, key, seed) through the
    shared registry cache (``refine``, default ``"anneal"``), and times
    the wire tiers — so ``_w{n}`` wire-delay grid rows stop tying
    bit-for-bit and the wire axis becomes searchable design space.
    Promotion never re-places: a survivor's placements are cache hits on
    every later rung (only newly-joined circuits anneal), and the per-
    rung ledger bills the annealing share under ``walls["anneal_s"]``.
    """
    archs = list(archs)
    if not archs:
        raise ValueError("search_archs needs a non-empty arch grid")
    names = [a.name for a in archs]
    if len(set(names)) != len(names):
        raise ValueError("arch names must be unique across the grid")
    by_name = dict(zip(names, archs))
    base_name = baseline if baseline is not None else names[0]
    if base_name not in by_name:
        raise ValueError(
            f"baseline {base_name!r} not in the searched grid")
    if packs is None:
        packs = _PACK_CACHE
    if programs is None:
        programs = _PROG_CACHE

    # rung count from the halving schedule: n, n/eta, ... until the
    # survivor floor (the last rung always runs the full suite)
    n_rungs = 1
    n = len(archs)
    while n > min_survivors:
        n = max(math.ceil(n / eta), min_survivors)
        n_rungs += 1
    subsets = circuit_schedule(nets, n_rungs, min_circuits=min_circuits)

    current = archs
    rungs: list[dict] = []
    budget_used = 0
    frontier: list[dict] = []
    front: list[dict] = []
    final_res: SweepResult | None = None
    agg_walls: dict[str, float] = {}
    stopped_early = False
    for r, subset in enumerate(subsets):
        if budget is not None:
            remaining = budget - budget_used
            max_circ = remaining // max(len(current), 1)
            if max_circ < min(min_circuits, len(subset)):
                stopped_early = True
                break
            subset = subset[:max_circ] if max_circ < len(subset) else subset
        res = sweep_suite(subset, current, seed=seed, backend=backend,
                          max_groups=max_groups, place=place,
                          refine=refine, packs=packs, programs=programs,
                          prefixes=prefixes, device=device)
        budget_used += len(subset) * len(current)
        t0 = time.perf_counter()
        subset_names = [nt.name for nt in subset]
        frontier = adp_frontier(res, baseline=base_name,
                                circuits=subset_names)
        front = pareto_front(frontier)
        last = r == len(subsets) - 1
        if last:
            survivors = sorted(r_["arch"] for r_ in frontier)
        else:
            k = max(math.ceil(len(current) / eta), min_survivors)
            survivors = select_survivors(frontier, k, allocation,
                                         n_circuits=len(subset))
        eval_s = time.perf_counter() - t0
        walls = _wall_split(res.wall, eval_s)
        for key, v in walls.items():
            agg_walls[key] = agg_walls.get(key, 0.0) + v
        rungs.append({
            "rung": r,
            "n_archs": len(current),
            "n_classes": res.n_classes,
            "n_circuits": len(subset),
            "circuits": subset_names,
            "survivors": survivors,
            "best": frontier[0]["arch"] if frontier else base_name,
            "walls": walls,
        })
        final_res = res
        if last:
            break
        keep = set(survivors) | {base_name}
        current = [a for a in current if a.name in keep]
    if not rungs:
        raise ValueError(
            f"budget {budget} cannot afford even one "
            f"{min_circuits}-circuit rung over {len(archs)} archs")
    winner = frontier[0]["arch"] if frontier else base_name
    return SearchResult(
        archs=names, baseline=base_name, rungs=rungs, frontier=frontier,
        pareto=front, winner=winner,
        budget={"requested": budget, "used": budget_used,
                "stopped_early": stopped_early},
        final=final_res, walls=agg_walls)


def verify_winners(result: SearchResult, nets, archs, seed: int = 0,
                   n_equiv_circuits: int = 2, winners=None,
                   place: bool = False,
                   refine: str | None = "anneal", device=None) -> dict:
    """Prove the promoted winners honest.

    * **oracle parity**: every (final-rung circuit, winner) record is
      re-derived by a fresh ``pack()`` + Python oracle timing walk and
      must match bit-for-bit — this re-checks the prefix/re-cluster/
      template-lowering pipeline end to end at the exact points the
      search promotes.  For a placed search pass ``place=True`` (and the
      search's ``refine``): the reference becomes
      :func:`repro_torch.core.timing.analyze_placed_oracle` under the same
      registry-cached refined placement the rungs consumed, resolved
      through the winner's placement-key representative in ``archs``
      order (the sweep's subgrouping rule);
    * **equivalence**: each winner's pack of the ``n_equiv_circuits``
      smallest circuits is re-elaborated and proven equivalent to the
      source netlist (symbolic + exhaustive closure,
      :func:`repro_torch.core.equiv.check_pack_equivalence`); ``device``
      is where its lane simulation runs when it takes the fused
      evaluator.
    """
    from .equiv import check_pack_equivalence
    from .packing import pack
    from .timing import analyze_oracle, analyze_placed_oracle

    if result.final is None:
        raise ValueError("search result has no final sweep to verify")
    by_name = {a.name: a for a in archs}
    reps: dict[tuple, ArchParams] = {}
    rep_for = {a.name: reps.setdefault(a.placement_key(), a)
               for a in archs}
    if winners is None:
        winners = [r["arch"] for r in result.pareto]
        if result.winner not in winners:
            winners.append(result.winner)
    ordered = sorted(nets, key=lambda n: (net_size(n), n.name))
    final_names = result.rungs[-1]["circuits"]
    check_nets = [n for n in ordered if n.name in final_names]
    parity = True
    equiv_ok = True
    details = []
    for wname in winners:
        arch = by_name[wname]
        recs = result.final.by_arch(wname)
        rec_by_circ = {r["net"]: r for r in recs}
        for net in check_nets:
            p = pack(net, arch, seed=seed)
            if place:
                from .place import placement_for

                pl = placement_for(p.lower_ir(), rep_for[wname], seed,
                                   refine=refine)
                ro = analyze_placed_oracle(p, pl)
            else:
                ro = analyze_oracle(p)
            rec = rec_by_circ[net.name]
            ok = (ro["critical_path_ps"] == rec["critical_path_ps"]
                  and ro["area_mwta"] == rec["area_mwta"])
            parity = parity and ok
            if not ok:
                details.append({"arch": wname, "net": net.name,
                                "kind": "oracle_mismatch"})
        for net in check_nets[:n_equiv_circuits]:
            rep = check_pack_equivalence(net, arch, seed=seed, device=device)
            equiv_ok = equiv_ok and bool(rep["equivalent"])
            if not rep["equivalent"]:
                details.append({"arch": wname, "net": net.name,
                                "kind": "not_equivalent"})
    return {"winners": winners, "oracle_match": parity,
            "equivalent": equiv_ok, "mismatches": details}
