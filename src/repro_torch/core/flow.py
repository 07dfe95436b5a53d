"""The unified CAD flow pipeline: synth → techmap → pack → equiv → eval
(the port of ``repro/core/flow.py``).

* **synthesis + techmap** happen inside the circuit generators
  (``core.circuits``); the flow consumes finished :class:`Netlist`\\ s.
* **pack + analyze** — :func:`pack_and_analyze` packs under an
  architecture across placement seeds and averages the
  :func:`~repro_torch.core.timing.analyze` metrics (the paper averages
  three seeds); :func:`pack_and_analyze_one` keeps the packed circuit for
  callers that need structural access (stress capacity sweeps).
* **design-space sweeps** — :func:`sweep_architectures` /
  :func:`sweep_frontier` drive :mod:`repro_torch.core.sweep`: pack once
  per structural class, re-time the whole suite across an arch grid
  (:func:`repro_torch.core.alm.arch_grid`) as one batched torch program
  per class on the card, and reduce to geomean ADP-frontier rows;
  :func:`search_design_space` runs the successive-halving search
  (:mod:`repro_torch.core.search`) over the full grid.
* **equivalence gate** — :func:`run_circuit` optionally proves pack
  equivalence per arch through :mod:`repro_torch.core.equiv` (symbolic
  fast path first, lane simulation on the fused evaluator as fallback).
* **evaluation** — :func:`evaluate_netlist` / :func:`evaluate_suite` run
  the width-bucketed fused engine (:mod:`repro_torch.core.eval_torch`),
  whose LUT levels go through the CUDA kernel on the card.
  :func:`evaluate_suite` clusters a suite into a few compatible-envelope
  groups; plans and grouped tensors are content-cached.
* :func:`oracle_check` closes the loop against the pure-Python
  ``eval_netlist`` oracle.

Ratios against a baseline arch (the shape of Figs. 5-7) come from
:func:`ratios_vs_baseline`; :func:`run_suites` maps the whole pipeline
over named suites; :func:`serve` answers many tenants' requests through
the async batched flow server (:mod:`repro_torch.core.serve_flow`).
"""
from __future__ import annotations

import random
from typing import Callable, Sequence

import numpy as np

from ..device import resolve_device
from .alm import ARCHS, ArchParams
from .equiv import check_pack_equivalence
from .eval_torch import (DEFAULT_MAX_BUCKETS, DEFAULT_MAX_GROUPS, FusedPlan,
                         SuiteProgram, eval_netlist_fused,
                         eval_netlists_batched, group_layout,
                         group_plans_by_envelope, netlist_digest,
                         plan_netlist, prepare_suite_program)
from .netlist import Netlist, eval_netlist
from .packing import PackedCircuit, pack
from .timing import analyze

#: the paper averages three placement seeds per figure
DEFAULT_SEEDS = (0, 1, 2)

#: metrics whose per-seed mean makes up a flow record
_METRIC_KEYS = ("alms", "area_mwta", "critical_path_ps", "adp",
                "concurrent_luts", "lbs")


def _arch(arch: str | ArchParams) -> ArchParams:
    return ARCHS[arch] if isinstance(arch, str) else arch


# ---------------------------------------------------------------------------
# pack + analyze
# ---------------------------------------------------------------------------


def pack_and_analyze_one(net: Netlist, arch: str | ArchParams,
                         seed: int = 0) -> tuple[PackedCircuit, dict]:
    """One pack at one seed, returning both the packed circuit and its
    analysis — for flows that need structural access (capacity sweeps)."""
    packed = pack(net, _arch(arch), seed=seed)
    return packed, analyze(packed)


def pack_and_analyze(net: Netlist, arch: str | ArchParams,
                     seeds: Sequence[int] = DEFAULT_SEEDS) -> dict:
    """Average :func:`analyze` metrics over placement seeds."""
    acc: dict[str, float] = {}
    for s in seeds:
        r = analyze(pack(net, _arch(arch), seed=s))
        for k in _METRIC_KEYS:
            acc[k] = acc.get(k, 0.0) + r[k] / len(seeds)
    acc["adders"] = net.n_adders
    acc["luts"] = net.n_luts
    return acc


def run_circuit(net: Netlist, archs: Sequence[str | ArchParams],
                seeds: Sequence[int] = DEFAULT_SEEDS,
                check_equiv: bool = False, n_vectors: int = 64,
                equiv_method: str = "auto", device=None) -> dict[str, dict]:
    """Pack + analyze one circuit under several archs, optionally gated on
    pack equivalence.  Returns ``{arch_name: metrics}``; with
    ``check_equiv`` each record carries ``equivalent`` / ``equiv_method``
    and a non-equivalent pack raises ``AssertionError`` — a figure must
    not silently average a corrupted pack.  ``device`` is where lane
    simulation runs when the gate takes the fused evaluator.
    """
    out: dict[str, dict] = {}
    for arch in archs:
        ap = _arch(arch)
        rec = pack_and_analyze(net, ap, seeds=seeds)
        if check_equiv:
            rep = check_pack_equivalence(net, ap, seed=seeds[0],
                                         n_vectors=n_vectors,
                                         method=equiv_method, device=device)
            if not rep["equivalent"]:
                if equiv_method == "symbolic" and not rep["mismatches"]:
                    # incomplete proof, not a disproof — name it as such
                    raise AssertionError(
                        f"{net.name}@{ap.name}: symbolic proof incomplete "
                        f"({len(rep.get('fallback', []))} unclosed cones); "
                        f"use equiv_method='auto' to simulate the residue")
                raise AssertionError(
                    f"{net.name}@{ap.name}: pack is NOT equivalent "
                    f"({rep['mismatches'][:1]})")
            rec["equivalent"] = True
            rec["equiv_method"] = rep.get("method", "simulate")
        out[ap.name] = rec
    return out


def sweep_architectures(suites_or_nets, archs=None, seed: int = 0,
                        backend: str = "torch", max_buckets: int = 3,
                        max_groups: int = 4,
                        packs: dict | None = None,
                        programs: dict | None = None,
                        prefixes: dict | None = None,
                        grid_axes: dict | None = None,
                        place: bool = False,
                        refine: str | None = "anneal", device=None):
    """Design-space sweep over an architecture grid (see
    :func:`repro_torch.core.sweep.sweep_suite`).  ``archs`` defaults to
    the bypass-width x crossbar-population grid; pass any list of
    :class:`~repro_torch.core.alm.ArchParams` rows (e.g. the canonical
    baseline/DD5/DD6 triple plus ablations), or ``grid_axes`` — keyword
    arguments for :func:`repro_torch.core.alm.arch_grid` (e.g.
    ``{"alms_per_lb": (8, 10), "lb_inputs": (48, 60)}``) — to grow the
    grid along the structural cluster-geometry axes.

    ``max_groups`` (the timing-program envelope-grouping knob) is
    forwarded verbatim, so a flow caller can match a direct
    ``sweep_suite`` configuration and hit a ``programs`` cache warmed
    with a non-default grouping.  ``packs``/``programs``/``prefixes``
    are the caller-owned content-keyed caches of ``sweep_suite``.
    ``place=True`` grid-places every circuit and includes the wire-tier
    delay term (placements registry-cached per placement key, anneal-
    refined by default — ``refine`` forwards to
    :func:`repro_torch.core.sweep.sweep_suite`; see
    :mod:`repro_torch.core.place` and :mod:`repro_torch.core.anneal`).
    ``backend="torch"`` times on ``device`` (default: the card)."""
    from .alm import arch_grid
    from .sweep import sweep_suite

    if archs is None:
        archs = arch_grid(**(grid_axes or {}))
    elif grid_axes is not None:
        raise ValueError("pass either archs or grid_axes, not both")
    return sweep_suite(suites_or_nets, archs, seed=seed, backend=backend,
                       max_buckets=max_buckets, max_groups=max_groups,
                       packs=packs, programs=programs, prefixes=prefixes,
                       place=place, refine=refine, device=device)


def sweep_frontier(result, baseline: str | None = None):
    """Geomean area/cpd/ADP ratio rows vs a baseline grid point."""
    from .sweep import adp_frontier

    return adp_frontier(result, baseline=baseline)


def search_design_space(suites_or_nets, archs=None, seed: int = 0,
                        eta: int = 4, min_survivors: int = 8,
                        allocation: str = "halving",
                        budget: int | None = None,
                        baseline: str | None = None,
                        backend: str = "numpy", verify: bool = False,
                        device=None, **search_kwargs):
    """Pareto-aware successive-halving search over an arch grid (see
    :func:`repro_torch.core.search.search_archs`).  ``archs`` defaults to
    the *full* design-space cross-product
    (:func:`repro_torch.core.alm.full_arch_grid`, ~2000 points) and
    ``baseline`` to the grid's ``b0`` row when present.  ``verify=True``
    additionally proves every Pareto winner oracle-bit-identical and
    equivalence-gated (:func:`repro_torch.core.search.verify_winners`)
    and attaches the report as ``result.verify``.  ``device`` is where
    ``backend="torch"`` times and where verification's lane simulation
    runs (default: the card)."""
    from .alm import full_arch_grid
    from .search import search_archs, verify_winners
    from .sweep import _flatten

    if archs is None:
        archs = full_arch_grid()
    if baseline is None and any(a.name == "b0" for a in archs):
        baseline = "b0"
    _, nets = _flatten(suites_or_nets)
    result = search_archs(nets, archs, seed=seed, eta=eta,
                          min_survivors=min_survivors,
                          allocation=allocation, budget=budget,
                          baseline=baseline, backend=backend,
                          device=device, **search_kwargs)
    if verify:
        result.verify = verify_winners(result, nets, archs, seed=seed,
                                       device=device)
    return result


def ratios_vs_baseline(per_arch: dict[str, dict], baseline: str = "baseline",
                       keys: Sequence[str] = ("area_mwta",
                                              "critical_path_ps", "adp")
                       ) -> dict[str, dict[str, float]]:
    """Per-arch metric ratios against ``per_arch[baseline]`` (Figs. 5-7)."""
    base = per_arch[baseline]
    return {name: {k: rec[k] / base[k] for k in keys}
            for name, rec in per_arch.items() if name != baseline}


def run_suites(suites: dict[str, list[Netlist]],
               archs: Sequence[str | ArchParams],
               seeds: Sequence[int] = DEFAULT_SEEDS,
               check_equiv: bool = False,
               per_circuit: Callable[[str, Netlist, dict], None]
               | None = None, device=None) -> dict[str, list[dict]]:
    """Map :func:`run_circuit` over named suites.

    Returns ``{suite: [{"net": name, "per_arch": {...}}, ...]}``;
    ``per_circuit(suite, net, per_arch)`` is an optional progress hook.
    """
    out: dict[str, list[dict]] = {}
    for suite_name, nets in suites.items():
        rows = []
        for net in nets:
            per_arch = run_circuit(net, archs, seeds=seeds,
                                   check_equiv=check_equiv, device=device)
            rows.append({"net": net.name, "per_arch": per_arch})
            if per_circuit is not None:
                per_circuit(suite_name, net, per_arch)
        out[suite_name] = rows
    return out


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def random_lanes(net: Netlist, n_lane_words: int,
                 seed: int = 0) -> dict[int, np.ndarray]:
    """Random packed test vectors for every PI of ``net``."""
    rng = random.Random(seed)
    return {s: np.array([rng.getrandbits(32) for _ in range(n_lane_words)],
                        dtype=np.uint32) for s in net.pis}


def evaluate_netlist(net: Netlist, pi_lanes: dict[int, np.ndarray],
                     n_lane_words: int, use_kernel: bool = True,
                     max_buckets: int = DEFAULT_MAX_BUCKETS,
                     plan: FusedPlan | None = None,
                     device=None) -> np.ndarray:
    """Single-circuit fused evaluation through the cached bucketed plan;
    returns ``vals[n_signals, n_lane_words]`` uint32.

    Pass a precomputed ``plan`` in timing loops — it skips even the
    content-digest cache lookup.
    """
    if plan is None:
        plan = plan_netlist(net, max_buckets=max_buckets)
    return eval_netlist_fused(net, pi_lanes, n_lane_words,
                              use_kernel=use_kernel, plan=plan,
                              device=device)


def prepare_suite(nets: list[Netlist],
                  max_groups: int = DEFAULT_MAX_GROUPS,
                  max_buckets: int = DEFAULT_MAX_BUCKETS,
                  device=None) -> SuiteProgram:
    """One-time suite preparation (clustering + stacked device tensors);
    reuse the returned program across :func:`evaluate_suite` calls."""
    return prepare_suite_program(nets, max_groups=max_groups,
                                 max_buckets=max_buckets, device=device)


#: padded-row-equivalents charged per evaluation program (one group, or
#: one circuit) in the cost model below — the fixed cost of building the
#: value buffer, uploading it and walking the levels from Python.
#: The reference's value; on the card it picks grouped for the full
#: suite, the faster of the two there (``chip_smoke.py`` phase
#: ``suite_eval`` reads the pick beside both walls).
EVAL_DISPATCH_ROW_COST = 4096


def eval_mode_cost_model(nets: list[Netlist], plans=None, groups=None,
                         max_groups: int = DEFAULT_MAX_GROUPS,
                         max_buckets: int = DEFAULT_MAX_BUCKETS,
                         device=None) -> dict:
    """Device-aware cost model: grouped vs per-circuit eval.

    Grouped evaluation trades program count (one per envelope group
    instead of one per circuit) for padded volume (every member pads to
    the group envelope).  The backend is taken from ``device``: on the
    host (``cpu``) the stacked group rows execute serially, so the model
    charges the full ``rows_per_member * len(group)``; on ``cuda`` one
    launch covers the whole group in parallel and a group costs one
    member's padded rows.  Both sides are charged
    :data:`EVAL_DISPATCH_ROW_COST` rows per program.

    The reference also charged a compile per program not yet run; eager
    torch compiles nothing per shape, so that term is dropped here.  All
    row terms come from the :class:`~repro_torch.core.circuit_ir.CircuitIR`
    profiles — no device tensors are built.
    """
    from .circuit_ir import lower_netlist_ir

    backend = resolve_device(device).type
    if plans is None:
        plans = [plan_netlist(n, max_buckets=max_buckets) for n in nets]
    if groups is None:
        groups = group_plans_by_envelope(plans, max_groups=max_groups)
    parallel = backend == "cuda"
    irs = [lower_netlist_ir(n) for n in nets]
    single_rows = sum(p.padded_lut_rows + p.padded_chain_bits for p in plans)
    grouped_rows = 0
    for g in groups:
        layout = group_layout([irs[i] for i in g], max_buckets=max_buckets)
        grouped_rows += layout["rows_per_member"] * (1 if parallel
                                                     else len(g))
    dispatch = EVAL_DISPATCH_ROW_COST
    cost_grouped = grouped_rows + dispatch * len(groups)
    cost_single = single_rows + dispatch * len(nets)
    return {
        "backend": backend,
        "parallel": parallel,
        "n_programs_grouped": len(groups),
        "n_programs_per_circuit": len(nets),
        "padded_rows_grouped": int(grouped_rows),
        "padded_rows_per_circuit": int(single_rows),
        "dispatch_row_cost": EVAL_DISPATCH_ROW_COST,
        "cost_grouped": int(cost_grouped),
        "cost_per_circuit": int(cost_single),
        "pick": "grouped" if cost_grouped <= cost_single else "per_circuit",
    }


def evaluate_suite(nets: list[Netlist],
                   pi_lanes_list: list[dict[int, np.ndarray]],
                   n_lane_words: int, use_kernel: bool = True,
                   max_groups: int = DEFAULT_MAX_GROUPS,
                   max_buckets: int = DEFAULT_MAX_BUCKETS,
                   program: SuiteProgram | None = None,
                   mode: str = "auto",
                   device=None) -> tuple[list[np.ndarray], dict]:
    """Whole-suite evaluation as <= ``max_groups`` envelope groups — or
    per-circuit fused evaluation, whichever the device-aware cost model
    predicts cheaper (``mode="auto"``; force with ``"grouped"`` /
    ``"per_circuit"``; a prepared ``program`` implies grouped and its
    device).

    Returns ``(per-circuit vals arrays, stats)`` where stats records the
    envelope groups, their bucket shapes, padded-row counts, the chosen
    ``mode`` and (in auto) the ``cost_model`` record — both paths are
    bit-identical, so the choice is purely a throughput matter.
    """
    if program is not None:
        outs, stats = eval_netlists_batched(
            nets, pi_lanes_list, n_lane_words, use_kernel=use_kernel,
            return_stats=True, program=program)
        stats = dict(stats, mode="grouped")
        return outs, stats
    if mode not in ("auto", "grouped", "per_circuit"):
        raise ValueError(f"unknown evaluate_suite mode {mode!r}")
    dev = resolve_device(device)
    # plans are registry-cached; the O(n^2) agglomerative grouping runs
    # at most ONCE and only when a branch actually needs it; each content
    # digest is taken once per call
    digests = [netlist_digest(n) for n in nets]
    plans = [plan_netlist(n, max_buckets=max_buckets, digest=d)
             for n, d in zip(nets, digests)]
    model = None
    chosen = mode
    groups = None
    if mode == "auto":
        groups = group_plans_by_envelope(plans, max_groups=max_groups)
        model = eval_mode_cost_model(nets, plans=plans, groups=groups,
                                     max_buckets=max_buckets, device=dev)
        chosen = model["pick"]
    if chosen == "grouped":
        if groups is None:
            groups = group_plans_by_envelope(plans, max_groups=max_groups)
        program = prepare_suite_program(nets, max_buckets=max_buckets,
                                        plans=plans, groups=groups,
                                        device=dev, digests=digests)
        outs, stats = eval_netlists_batched(
            nets, pi_lanes_list, n_lane_words, use_kernel=use_kernel,
            return_stats=True, program=program)
        stats = dict(stats)
    else:
        outs = [evaluate_netlist(n, ln, n_lane_words, use_kernel=use_kernel,
                                 plan=pl, device=dev)
                for n, ln, pl in zip(nets, pi_lanes_list, plans)]
        stats = {"n_groups": len(nets), "groups": [],
                 "n_programs": len(nets)}
    stats["mode"] = chosen
    if model is not None:
        stats["cost_model"] = model
    return outs, stats


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def serve(requests, **server_kwargs):
    """Serve a list of :class:`~repro_torch.core.serve_flow.FlowRequest`\\ s
    through one async batched
    :class:`~repro_torch.core.serve_flow.FlowServer` (coalescing window,
    request dedup, batched timing/eval programs on ``device``, bounded
    multi-tenant caches) and return
    :class:`~repro_torch.core.serve_flow.FlowResult`\\ s in request order.
    Every record is bit-identical to ``pack_and_analyze(net, arch,
    seeds=(seed,))`` — see :mod:`repro_torch.core.serve_flow`."""
    from .serve_flow import serve_requests

    return serve_requests(requests, **server_kwargs)


def oracle_check(net: Netlist, pi_lanes: dict[int, np.ndarray],
                 vals: np.ndarray, n_lane_words: int,
                 words: Sequence[int] | None = None) -> bool:
    """Prove an evaluated result bit-identical to the Python oracle on
    every primary output, over all lane words or only ``words``."""
    for w in (range(n_lane_words) if words is None else words):
        pi_vals = {s: int(pi_lanes[s][w]) for s in net.pis}
        ref = eval_netlist(net, pi_vals, 32)
        for bus in net.pos.values():
            for s in bus:
                if int(vals[s, w]) != (ref[s] & 0xFFFFFFFF):
                    return False
    return True
