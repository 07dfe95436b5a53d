"""CAD-as-a-service: an async batched flow server over the unified flow
(the port of ``repro/core/serve_flow.py``).

:func:`repro_torch.core.flow.pack_and_analyze` answers one question for one
caller.  This module serves *many concurrent callers* — the shape of a
synthesis service where several tenants stream pack/timing/eval requests
against a shared arch library — by applying the continuous-batching idea
from inference serving to CAD flows:

* **coalescing window** — a :class:`FlowServer` collects requests that
  arrive within ``batch_window_s`` of each other (plus everything queued
  while the previous batch was computing) and processes them as ONE
  batch, highest :attr:`FlowRequest.priority` first;
* **request dedup** — within a batch, requests for the same (netlist
  content digest, arch, seed) collapse into one *job*: two tenants
  submitting the same circuit share one pack, one lowering and one
  timing row, and both futures resolve from the same record;
* **batched programs** — the batch's timing jobs are grouped by arch
  *structural class* (delays never steer the packer, see
  :mod:`repro_torch.core.sweep`), circuits are envelope-clustered with the
  evaluator's shared planner (:func:`repro_torch.core.plan.group_by_envelope`)
  and each group is timed over the class's stacked delay-table rows,
  by the numpy walk or as one batched torch program on the card
  (``timing_backend``); eval jobs run through
  :func:`repro_torch.core.flow.evaluate_suite` on the card, one
  ``lut_eval6_level`` kernel launch per LUT level;
* **bounded multi-tenant caches** — every store is a registry LRU
  (:mod:`repro_torch.core.plan`): packs keyed by *pack digest* (structure
  minus truth tables), timing records by (pack digest, arch, seed),
  eval results by (content digest, lane config), timing programs by
  member digests and device.  One :func:`repro_torch.core.plan.cache_stats`
  call is the whole telemetry surface; a cache under eviction pressure
  recomputes correct results — it only stops amortizing.

Netlist-delta fast path
-----------------------
A request carrying ``base_digest`` (the content digest of a previously
served netlist) is an *incremental* edit.  Because neither packing nor
static timing ever reads LUT truth tables, pack results are keyed by
:meth:`~repro_torch.core.netlist.Netlist.pack_digest`: a truth-table-only edit
— the shape of an incremental-synthesis constant/weight update — hits
the base's pack AND timing record outright and re-runs only functional
eval.

A *structural* edit takes the dirty-set path: the server diffs the
edited netlist against the served base
(:func:`~repro_torch.core.repack.netlist_structural_diff`), patches the base's
ClusterPlan prefix instead of rebuilding it
(:func:`~repro_torch.core.sweep.prefix_for_edit`, hosted in the shared prefix
store under ``(pack digest, base digest, seed)``), replays the base's
recorded greedy decisions over everything *outside* the dirty set
(:func:`~repro_torch.core.repack.repack_delta` — surviving LBs are frozen as
placed obstacles, only dirty members and divergence-reached LBs re-run
real scans), patches only the touched rows of the cached CircuitIR
(:func:`~repro_torch.core.circuit_ir.apply_pack_delta`), and proves the
touched clusters with a scoped symbolic equivalence pass
(:func:`~repro_torch.core.equiv.verify_clusters`; the full-circuit proof runs
only on fallback modes, where the dirty set no longer bounds the
touched region).  Any eligibility failure (shape change, absorbed-LUT
edit, absorption/pairing flip, evicted base state, dirty-set growth
past the divergence bound) falls back to the full path — every mode is
byte-identical to a fresh ``pack()``.  :attr:`FlowResult.delta` carries
the per-cluster attribution (:func:`~repro_torch.core.repack.cluster_delta`:
frozen / moved / re-clustered LB counts) plus the repack-path and
verify summaries.

Determinism contract
--------------------
Every served record is **bit-identical** to the single-request reference
``flow.pack_and_analyze(net, arch, seeds=(seed,))`` — batching, caching,
coalescing and eviction are throughput matters only.  That holds by
construction (``repack`` is byte-identical to ``pack``; the batched
timing program is bit-identical to the oracle) and is gated by
``tests/test_torch_serve_flow.py`` and ``chip_smoke.py``'s ``serve_flow``
phase.

The server is a single-process asyncio design: ``submit()`` is awaited
from any number of client tasks in one event loop; the batch compute
itself is synchronous (host-bound launches), so concurrency buys
*coalescing*, not parallel compute.

Differences from the reference's :class:`FlowServer`
---------------------------------------------------
* ``timing_backend`` is ``"numpy"`` (the default) or ``"torch"``, the
  counterpart of the reference's default, its device program ``"jax"``;
  ``"jax"`` raises ``ValueError``.  The default differs because the
  server's programs are small: on the H100 the numpy walk served more
  requests per second than the batched torch program at every client
  count measured (``chip_smoke.py``'s ``serve_flow`` phase).
* ``use_pallas`` is ``use_kernel`` (the CUDA LUT kernels, or their plain
  torch version when false).
* ``device=`` is added: where the timing programs and the evaluator run
  (default: the card, raising without one).
* No ``pad_timing_shapes``: the port's timing program has no shape
  padding, and eager torch has no compile for padded shapes to share.
* No ``eval_warm``: the port's :func:`repro_torch.core.flow.evaluate_suite`
  has no ``warm`` (eager torch compiles nothing per program).
"""
from __future__ import annotations

import asyncio
import itertools
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from . import flow as _flow
from . import plan as _planner
from .alm import ArchParams
from ..device import resolve_device
from .netlist import Netlist
from .repack import (cluster_delta, netlist_structural_diff, pack_prefix,
                     repack_delta, repack_with_log)
from .sweep import prefix_for_edit
from .timing import record_timing_wall
from .timing_vec import (build_suite_timing_program, critical_path_numpy,
                         delay_components, metrics_from_cp)

#: packs per (pack digest, structural key, seed).  Keyed by *pack*
#: digest, not content digest: a truth-table-only delta hits here with
#: zero bookkeeping — the key itself encodes "packing cannot differ".
_PACKS = _planner.register_cache("serve_packs", cap=256)

#: analyze-shaped records per (pack digest, arch name, seed) — the same
#: pack-digest keying makes tt-only deltas reuse timing verbatim.
_TIMING = _planner.register_cache("serve_timing", cap=2048)

#: per-PO eval lane results per (content digest, n_lane_words,
#: lanes_seed) — content digest here, truth tables obviously matter.
_EVAL = _planner.register_cache("serve_eval", cap=256)

#: suite timing programs per (member pack digests, structural key, seed,
#: max_buckets, device) — a repeated batch shape reuses the program, whose
#: level tables already sit on that device.
_PROGRAMS = _planner.register_cache("serve_programs", cap=64)

#: content digest -> pack digest of every netlist ever served — how a
#: ``base_digest`` (content) resolves to the base pack (pack-keyed).
_DIGESTS = _planner.register_cache("serve_digests", cap=4096)

#: the prefix store shared with :mod:`repro_torch.core.sweep` — delta
#: requests re-cluster from the same ClusterPlan prefixes sweeps warm.
#: Edited-netlist prefixes land in the SAME store under the
#: ``(pack digest, base digest, seed)`` keying of
#: :func:`repro_torch.core.sweep.prefix_for_edit`.
_PREFIXES = _planner.register_cache("pack_prefix", cap=64)

#: greedy decision logs per (pack digest, structural key, seed) — what a
#: later structural edit replays against.  Recorded on every full
#: re-cluster (``repack_with_log``); delta-produced packs do not get a
#: log (an advised replay cannot also record), so a chain of edits
#: re-records at its first full repack.
_REPACK_LOGS = _planner.register_cache("serve_repack_logs", cap=32)

ANALYSES = ("area", "timing", "eval")

_AREA_KEYS = ("alms", "lbs", "area_mwta", "adders", "luts",
              "concurrent_luts")
_TIMING_KEYS = ("arch", "critical_path_ps", "fmax_mhz", "adp")


@dataclass
class FlowRequest:
    """One tenant request: run ``analyses`` of ``net`` under ``arch``.

    ``analyses`` is any subset of ``("area", "timing", "eval")``; area
    and timing ride the same pack+timing job, eval is arch-independent
    and keyed by lane configuration (``n_lane_words`` x ``lanes_seed``,
    or explicit ``pi_lanes``).  ``base_digest`` — the
    :meth:`~repro_torch.core.netlist.Netlist.content_digest` of a previously
    served netlist — opts into the delta fast path.  Higher ``priority``
    drains first when a batch overflows ``max_batch``.
    """

    net: Netlist
    arch: str | ArchParams
    analyses: Sequence[str] = ("area", "timing")
    priority: int = 0
    seed: int = 0
    base_digest: str | None = None
    n_lane_words: int = 4
    lanes_seed: int = 0
    pi_lanes: dict | None = None
    tenant: str = ""

    def __post_init__(self):
        bad = [a for a in self.analyses if a not in ANALYSES]
        if bad:
            raise ValueError(f"unknown analyses {bad!r} "
                             f"(supported: {ANALYSES})")
        if not self.analyses:
            raise ValueError("request with no analyses")


@dataclass
class FlowResult:
    """What a future resolves to: per-analysis records + attribution.

    ``record`` is the full ``timing.analyze``-shaped dict (present when
    area/timing ran); ``analyses`` holds the per-analysis views the
    request asked for (``"eval"`` maps PO name -> ``[bus, lane_words]``
    uint32 lanes).  ``walls`` carries the request's queue/service/total
    latencies plus the shared per-stage walls of its batch; ``batch``
    records how the request was served (batch id, how many requests the
    batch held, how many shared this request's job, cache hits).
    ``delta`` is the delta-path attribution when ``base_digest`` was
    given.  Records may be shared between coalesced requests — treat as
    read-only.
    """

    net: str
    digest: str
    arch: str
    seed: int
    analyses: dict
    record: dict | None
    delta: dict | None
    batch: dict
    walls: dict


@dataclass
class _Pending:
    req: FlowRequest
    future: asyncio.Future
    t_submit: float
    seq: int
    digest: str = ""


@dataclass
class _Job:
    """One deduplicated unit of work: (digest, arch name, seed)."""

    net: Netlist
    arch: ArchParams
    seed: int
    digest: str
    analyses: set = field(default_factory=set)
    entries: list = field(default_factory=list)
    base_digest: str | None = None
    pack_digest: str = ""
    pack: object = None
    ir: object = None
    record: dict | None = None
    delta: dict | None = None
    pack_cached: bool = False
    timing_cached: bool = False
    delta_info: dict | None = None   # repack-path attribution
    verify: dict | None = None       # scoped/full equivalence summary


def _eval_key(req: FlowRequest, digest: str):
    """Dedup key for one eval task; explicit ``pi_lanes`` are keyed by
    object identity (no content claim), generated lanes by config."""
    if req.pi_lanes is not None:
        return (digest, req.n_lane_words, "explicit", id(req.pi_lanes))
    return (digest, req.n_lane_words, "seeded", req.lanes_seed)


class FlowServer:
    """Async batched flow server (see module docstring, which also lists
    how its arguments differ from the reference's).

    ``batch_window_s`` is the coalescing window: after the first request
    of a batch arrives the server sleeps this long (yielding the loop)
    so concurrent submitters can join, then drains up to ``max_batch``
    entries by ``(-priority, arrival)``.  ``memoize=False`` disables
    result-cache *reads* (timing/eval records recompute every time —
    what the latency benchmark measures as the honest coalescing win);
    stores and the pack/program caches stay on, as they are
    correctness-neutral reuse, not result memoization.
    ``timing_backend`` picks the numpy walk (default) or the batched
    torch program.  ``device`` is where the torch timing programs and
    the evaluator run (default: the card).
    """

    def __init__(self, batch_window_s: float = 0.002, max_batch: int = 64,
                 timing_backend: str = "numpy", max_buckets: int = 3,
                 max_groups: int = 4, use_kernel: bool = True,
                 memoize: bool = True, eval_mode: str = "auto",
                 verify_deltas: bool = True, device=None):
        if timing_backend == "jax":
            raise ValueError(
                "the batched timing backend of the port is 'torch' (the "
                "reference's 'jax' program runs on the device in torch "
                "here)")
        if timing_backend not in ("torch", "numpy"):
            raise ValueError(f"unknown timing backend {timing_backend!r}")
        self.device = resolve_device(device)
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        self.timing_backend = timing_backend
        self.max_buckets = max_buckets
        self.max_groups = max_groups
        self.use_kernel = use_kernel
        self.memoize = memoize
        self.eval_mode = eval_mode
        #: prove every structurally-delta-served pack: per-cluster
        #: symbolic proof scoped to the touched LBs on the incremental
        #: path, the full-circuit proof on fallbacks
        self.verify_deltas = verify_deltas
        self.stats = {"n_requests": 0, "n_batches": 0, "n_jobs": 0,
                      "n_coalesced": 0, "n_pack_hits": 0,
                      "n_timing_hits": 0, "n_eval_hits": 0,
                      "n_delta_requests": 0, "n_delta_pack_reuse": 0,
                      "n_delta_incremental": 0, "n_delta_fallback": 0,
                      "n_verify_scoped": 0, "n_verify_full": 0}
        self._pending: list[_Pending] = []
        self._seq = itertools.count()
        self._batch_ids = itertools.count()
        self._loop = None
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None

    # -- client surface ----------------------------------------------------

    def submit_nowait(self, req: FlowRequest) -> asyncio.Future:
        """Enqueue ``req``; returns the request's future immediately.
        Must run inside an event loop (the server's batch task lives on
        it)."""
        loop = asyncio.get_running_loop()
        self._ensure_running(loop)
        entry = _Pending(req=req, future=loop.create_future(),
                         t_submit=time.perf_counter(), seq=next(self._seq),
                         digest=req.net.content_digest())
        self._pending.append(entry)
        self.stats["n_requests"] += 1
        self._wake.set()
        return entry.future

    async def submit(self, req: FlowRequest) -> FlowResult:
        """Enqueue ``req`` and await its result."""
        return await self.submit_nowait(req)

    async def aclose(self) -> None:
        """Stop the batch task; pending (undrained) futures fail."""
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        for entry in self._pending:
            if not entry.future.done():
                entry.future.set_exception(
                    RuntimeError("flow server closed"))
        self._pending.clear()

    def cache_stats(self) -> dict:
        """The shared registry telemetry (all caches, not just serving's:
        the server *is* a tenant of the same bounded layer)."""
        return _planner.cache_stats()

    # -- batch loop --------------------------------------------------------

    def _ensure_running(self, loop) -> None:
        if self._task is not None and not self._task.done() \
                and loop is self._loop:
            return
        self._loop = loop
        self._wake = asyncio.Event()
        self._task = loop.create_task(self._batch_loop())

    def _drain(self) -> list[_Pending]:
        self._pending.sort(key=lambda e: (-e.req.priority, e.seq))
        batch = self._pending[:self.max_batch]
        del self._pending[:self.max_batch]
        return batch

    async def _batch_loop(self) -> None:
        while True:
            await self._wake.wait()
            self._wake.clear()
            # the coalescing window: let concurrent submitters join the
            # batch (0 still yields once, so same-tick submits coalesce)
            await asyncio.sleep(self.batch_window_s)
            while self._pending:
                batch = self._drain()
                try:
                    self._process_batch(batch)
                except BaseException as exc:  # noqa: BLE001 — fail futures
                    for entry in batch:
                        if not entry.future.done():
                            entry.future.set_exception(
                                RuntimeError(
                                    f"flow batch failed: {exc!r}"))

    # -- batch compute (synchronous) ---------------------------------------

    def _process_batch(self, batch: list[_Pending]) -> None:
        t0 = time.perf_counter()
        walls = {"coalesce_s": 0.0, "prefix_s": 0.0, "repack_s": 0.0,
                 "lower_s": 0.0, "verify_s": 0.0, "build_s": 0.0,
                 "timing_s": 0.0, "eval_s": 0.0, "total_s": 0.0}
        batch_id = next(self._batch_ids)

        jobs = self._coalesce(batch, walls)
        pack_jobs = [j for j in jobs.values()
                     if j.analyses & {"area", "timing"}]
        self._pack_stage(pack_jobs, walls)
        self._timing_stage(pack_jobs, walls)
        eval_out = self._eval_stage(batch, jobs, walls)

        t_done = time.perf_counter()
        walls["total_s"] = t_done - t0
        self.stats["n_batches"] += 1
        self.stats["n_jobs"] += len(jobs)
        self.stats["n_coalesced"] += len(batch) - len(jobs)

        for entry in batch:
            req = entry.req
            job = jobs[(entry.digest, _flow._arch(req.arch).name, req.seed)]
            analyses: dict = {}
            if job.record is not None:
                if "area" in req.analyses:
                    analyses["area"] = {k: job.record[k]
                                        for k in _AREA_KEYS}
                if "timing" in req.analyses:
                    analyses["timing"] = {k: job.record[k]
                                          for k in _TIMING_KEYS}
            if "eval" in req.analyses:
                analyses["eval"] = eval_out[_eval_key(req, entry.digest)]
            res = FlowResult(
                net=req.net.name, digest=entry.digest, arch=job.arch.name,
                seed=req.seed, analyses=analyses, record=job.record,
                delta=job.delta,
                batch={"id": batch_id, "n_requests": len(batch),
                       "n_jobs": len(jobs), "n_shared": len(job.entries),
                       "pack_cached": job.pack_cached,
                       "timing_cached": job.timing_cached},
                walls={"queue_s": t0 - entry.t_submit,
                       "service_s": t_done - t0,
                       "total_s": t_done - entry.t_submit,
                       "stages": dict(walls)})
            if not entry.future.done():
                entry.future.set_result(res)

    def _coalesce(self, batch: list[_Pending], walls: dict) -> dict:
        """Collapse the batch into (digest, arch, seed) jobs; union the
        analyses so coalesced requests with different asks share one."""
        t0 = time.perf_counter()
        jobs: dict[tuple, _Job] = {}
        for entry in batch:
            req = entry.req
            arch = _flow._arch(req.arch)
            key = (entry.digest, arch.name, req.seed)
            job = jobs.get(key)
            if job is None:
                job = _Job(net=req.net, arch=arch, seed=req.seed,
                           digest=entry.digest)
                jobs[key] = job
            job.analyses.update(req.analyses)
            job.entries.append(entry)
            if req.base_digest is not None and job.base_digest is None:
                job.base_digest = req.base_digest
        walls["coalesce_s"] += time.perf_counter() - t0
        return jobs

    def _pack_stage(self, pack_jobs: list[_Job], walls: dict) -> None:
        """Resolve each job's pack: pack-digest cache hit (tt-only delta
        or repeat), else the dirty-set structural-delta path when the
        request names a served base, else prefix + full re-cluster.
        Every path is byte-identical to ``pack()``."""
        for job in pack_jobs:
            skey = job.arch.structural_key()
            pd = job.net.pack_digest()
            job.pack_digest = pd
            _DIGESTS.put(job.digest, pd)
            pack = _PACKS.get((pd, skey, job.seed))
            job.pack_cached = pack is not None
            if pack is None and job.base_digest is not None:
                pack = self._delta_pack(job, skey, walls)
            if pack is None:
                prefix = _PREFIXES.get((job.digest, job.seed))
                if prefix is None:
                    t1 = time.perf_counter()
                    prefix = pack_prefix(job.net, seed=job.seed)
                    _PREFIXES.put((job.digest, job.seed), prefix)
                    walls["prefix_s"] += time.perf_counter() - t1
                t1 = time.perf_counter()
                pack, log = repack_with_log(prefix, job.arch)
                walls["repack_s"] += time.perf_counter() - t1
                _PACKS.put((pd, skey, job.seed), pack)
                _REPACK_LOGS.put((pd, skey, job.seed), log)
            elif job.pack_cached:
                self.stats["n_pack_hits"] += 1
            job.pack = pack
            if job.base_digest is not None:
                self._attribute_delta(job, skey)

    def _delta_pack(self, job: _Job, skey, walls: dict):
        """The dirty-set structural-delta path: diff against the served
        base, patch its prefix (``prefix_for_edit`` — hosted in the
        shared store keyed by (pack digest, base digest, seed)), replay
        the base's decision log over the dirty set, patch the cached IR's
        dirty columns, and prove the touched clusters.  Returns the pack
        (byte-identical to a fresh ``pack()``) or ``None`` when any
        eligibility gate fails — the caller then runs the full path, and
        ``job.delta_info`` says why."""
        base_pd = _DIGESTS.get(job.base_digest)
        if base_pd is None:
            return None
        hit = _PREFIXES.get((job.base_digest, job.seed))
        base_prefix = hit
        base_log = _REPACK_LOGS.get((base_pd, skey, job.seed))
        if base_prefix is None or base_log is None:
            job.delta_info = {"mode": "full", "reason": "base_evicted"}
            return None
        diff = netlist_structural_diff(base_prefix.net, job.net)
        if diff is None:
            job.delta_info = {"mode": "full", "reason": "shape"}
            return None
        t1 = time.perf_counter()
        new_prefix, pinfo = prefix_for_edit(base_prefix, job.net,
                                            base_log=base_log,
                                            prefixes=_PREFIXES)
        walls["prefix_s"] += time.perf_counter() - t1
        if new_prefix is None:
            job.delta_info = {"mode": "full",
                              "reason": pinfo.get("reason", "prefix")}
            return None
        t1 = time.perf_counter()
        pack, rinfo = repack_delta(
            new_prefix, base_log, job.arch,
            dirty_atoms=pinfo.get("dirty_atoms", frozenset()))
        walls["repack_s"] += time.perf_counter() - t1
        t1 = time.perf_counter()
        from .circuit_ir import apply_pack_delta

        job.ir = apply_pack_delta(pack, base_prefix.net,
                                  edited_luts=diff["changed_inputs"],
                                  tt_luts=diff["changed_tt"])
        walls["lower_s"] += time.perf_counter() - t1
        job.delta_info = dict(rinfo, prefix_mode=pinfo.get("mode"),
                              prefix_store=pinfo.get("store"))
        self.stats["n_delta_incremental" if rinfo["mode"] == "incremental"
                   else "n_delta_fallback"] += 1
        if self.verify_deltas:
            self._verify_delta(job, pack, diff, rinfo, walls)
            if job.verify is not None and not job.verify["equivalent"]:
                # a failed proof means a packer bug, not a delta bug
                # (every mode is byte-identical by construction) — but
                # never serve an unproven delta: fall back to the full
                # path and surface the failure in the attribution
                job.delta_info = {"mode": "full",
                                  "reason": "verify_failed"}
                return None
        _PACKS.put((job.pack_digest, skey, job.seed), pack)
        return pack

    def _verify_delta(self, job: _Job, pack, diff: dict, rinfo: dict,
                      walls: dict) -> None:
        """Verify-after-repack: on the incremental path a symbolic proof
        scoped to the touched clusters (edited LUTs' LBs + every
        diverged LB); on fallback modes the full-circuit proof — the
        dirty set is no longer a sound touch bound there."""
        from .equiv import reelaborate, symbolic_equivalence_report, \
            verify_clusters

        t1 = time.perf_counter()
        if rinfo["mode"] == "incremental":
            touched = set(rinfo.get("div_lbs", ()))
            for li in set(diff["changed_inputs"]) | set(diff["changed_tt"]):
                site = pack.lut_site.get(li)
                if site is not None:
                    touched.add(int(pack.alm_lb[site]))
            rep = verify_clusters(pack, sorted(touched))
            self.stats["n_verify_scoped"] += 1
        else:
            rep = symbolic_equivalence_report(job.net, reelaborate(pack))
            self.stats["n_verify_full"] += 1
        walls["verify_s"] += time.perf_counter() - t1
        job.verify = {
            "method": rep["method"], "equivalent": rep["equivalent"],
            "lbs": rep.get("lbs"), "proven_luts": rep["proven_luts"],
            "fallback_closures": rep["fallback"]}

    def _attribute_delta(self, job: _Job, skey) -> None:
        self.stats["n_delta_requests"] += 1
        base_pd = _DIGESTS.get(job.base_digest)
        if base_pd is None:
            job.delta = {"mode": "unknown_base",
                         "base_digest": job.base_digest}
            return
        if base_pd == job.pack_digest:
            # tt-only (or no-op) edit: the pack-digest keying already
            # served the base pack and will serve its timing records
            self.stats["n_delta_pack_reuse"] += 1
            job.delta = {"mode": "tt_only", "n_changed": 0,
                         "unchanged_frac": 1.0,
                         "pack_reused": job.pack_cached,
                         "base_digest": job.base_digest}
            return
        base_pack = _PACKS.get((base_pd, skey, job.seed))
        if base_pack is None:
            job.delta = {"mode": "structural_base_evicted",
                         "base_digest": job.base_digest}
            return
        # frozen = same LB signature at the same index, moved = same
        # signature elsewhere, re-clustered = membership changed
        d = cluster_delta(base_pack, job.pack)
        job.delta = dict(d, mode="structural",
                         base_digest=job.base_digest)
        if job.delta_info is not None:
            job.delta["repack"] = job.delta_info
        if job.verify is not None:
            job.delta["verify"] = job.verify

    def _timing_stage(self, pack_jobs: list[_Job], walls: dict) -> None:
        """Batched timing for every job without a (memoized) record:
        grouped by structural class, envelope-clustered, one program per
        group over the class's stacked delay rows."""
        need: list[_Job] = []
        for job in pack_jobs:
            tkey = (job.pack_digest, job.arch.name, job.seed)
            rec = _TIMING.get(tkey) if self.memoize else None
            if rec is not None:
                job.record = rec
                job.timing_cached = True
                self.stats["n_timing_hits"] += 1
            else:
                need.append(job)
        if not need:
            return
        by_class: dict[tuple, list[_Job]] = {}
        for job in need:
            by_class.setdefault(job.arch.structural_key(), []).append(job)
        for skey, class_jobs in by_class.items():
            # distinct IRs (by pack key) and distinct delay rows (by
            # arch name) — two tenants' jobs on the same circuit/arch
            # pair occupy one (row, column) of the batched program
            ir_index: dict[tuple, int] = {}
            irs = []
            arch_index: dict[str, int] = {}
            arch_rows: list[ArchParams] = []
            for job in class_jobs:
                pkey = (job.pack_digest, skey, job.seed)
                if pkey not in ir_index:
                    if job.ir is not None:
                        # the delta path already patched the cached IR's
                        # dirty columns — no re-lowering
                        ir = job.ir
                    else:
                        t1 = time.perf_counter()
                        prefix = _PREFIXES.get((job.digest, job.seed))
                        tpl = (prefix.ir_template if prefix is not None
                               else None)
                        ir = job.pack.lower_ir(template=tpl)
                        if (prefix is not None
                                and prefix.ir_template is None):
                            prefix.ir_template = ir
                        walls["lower_s"] += time.perf_counter() - t1
                    ir_index[pkey] = len(irs)
                    irs.append(ir)
                job.ir = irs[ir_index[pkey]]
                if job.arch.name not in arch_index:
                    arch_index[job.arch.name] = len(arch_rows)
                    arch_rows.append(job.arch)
            tables = np.stack([a.delay_table() for a in arch_rows])
            cps = np.zeros((len(irs), len(arch_rows)))
            if self.timing_backend == "torch":
                t1 = time.perf_counter()
                # members keyed by full (pack digest, skey, seed) — two
                # batches whose IRs differ only in pack seed must not
                # share a program row; a program holds its device's
                # tensors, so the device is part of the key
                prog_key = (tuple(ir_index), self.max_buckets,
                            str(self.device))
                progs = _PROGRAMS.get(prog_key)
                if progs is None:
                    groups = _planner.group_by_envelope(
                        irs, max_groups=self.max_groups)
                    progs = [(members, build_suite_timing_program(
                        [irs[i] for i in members],
                        max_buckets=self.max_buckets, device=self.device))
                        for members in groups]
                    _PROGRAMS.put(prog_key, progs)
                walls["build_s"] += time.perf_counter() - t1
                t1 = time.perf_counter()
                for members, prog in progs:
                    gcps = prog.run(tables)
                    for row, gi in enumerate(members):
                        cps[gi] = gcps[row]
                walls["timing_s"] += time.perf_counter() - t1
            else:
                t1 = time.perf_counter()
                for k, arow in enumerate(arch_rows):
                    comps = delay_components(arow.delay_table())
                    for g, ir in enumerate(irs):
                        cps[g, k] = critical_path_numpy(ir, comps)
                walls["timing_s"] += time.perf_counter() - t1
            for job in class_jobs:
                cp = float(cps[ir_index[(job.pack_digest, skey, job.seed)],
                               arch_index[job.arch.name]])
                job.record = metrics_from_cp(job.ir, job.arch, cp)
                _TIMING.put((job.pack_digest, job.arch.name, job.seed),
                            job.record)
        record_timing_wall(
            walls["timing_s"] + walls["build_s"] + walls["lower_s"],
            calls=len(need))

    def _eval_stage(self, batch: list[_Pending], jobs: dict,
                    walls: dict) -> dict:
        """Deduplicated functional eval: one task per (digest, lane
        config), batched through ``evaluate_suite`` per lane count."""
        tasks: dict[tuple, tuple[Netlist, dict]] = {}
        for entry in batch:
            req = entry.req
            if "eval" not in req.analyses:
                continue
            key = _eval_key(req, entry.digest)
            if key not in tasks:
                lanes = (req.pi_lanes if req.pi_lanes is not None else
                         _flow.random_lanes(req.net, req.n_lane_words,
                                            seed=req.lanes_seed))
                tasks[key] = (req.net, lanes)
        out: dict[tuple, dict] = {}
        to_run: dict[int, list[tuple]] = {}
        for key, (net, lanes) in tasks.items():
            memo = _EVAL.get(key) if (self.memoize
                                      and key[2] == "seeded") else None
            if memo is not None:
                out[key] = memo
                self.stats["n_eval_hits"] += 1
            else:
                to_run.setdefault(key[1], []).append(key)
        t1 = time.perf_counter()
        for n_lane_words, keys in to_run.items():
            nets = [tasks[k][0] for k in keys]
            lanes_list = [tasks[k][1] for k in keys]
            vals_list, _stats = _flow.evaluate_suite(
                nets, lanes_list, n_lane_words, use_kernel=self.use_kernel,
                max_groups=self.max_groups, max_buckets=self.max_buckets,
                mode=self.eval_mode, device=self.device)
            for key, net, vals in zip(keys, nets, vals_list):
                po = {name: vals[np.asarray(bus, dtype=np.int64)]
                      for name, bus in net.pos.items()}
                out[key] = po
                if key[2] == "seeded":
                    _EVAL.put(key, po)
        walls["eval_s"] += time.perf_counter() - t1
        return out


def serve_requests(requests: Sequence[FlowRequest],
                   **server_kwargs) -> list[FlowResult]:
    """Synchronous front-end: run ``requests`` through one
    :class:`FlowServer` on a fresh event loop, submitting all of them
    concurrently (so they coalesce exactly as live tenants would), and
    return results in request order.  ``server_kwargs`` go to
    :class:`FlowServer` (``device=`` among them)."""

    async def _main():
        server = FlowServer(**server_kwargs)
        try:
            return list(await asyncio.gather(
                *(server.submit(r) for r in requests)))
        finally:
            await server.aclose()

    return asyncio.run(_main())
