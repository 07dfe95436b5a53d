"""Shared lowering/planning substrate: cache registry, width-bucket
segmentation and envelope grouping.

Every batched executor in the CAD stack — the fused netlist evaluator
(:mod:`repro_torch.core.eval_torch`), the vectorized static-timing program
(:mod:`repro_torch.core.timing_vec`) and the arch design-space sweep
(:mod:`repro_torch.core.sweep`) — faces the same two planning problems over the
same levelized :class:`~repro_torch.core.circuit_ir.CircuitIR` substrate:

* **width-bucket segmentation** (:func:`segment_levels`): partition a
  level sequence into a few contiguous runs, each padded only to its own
  envelope, minimizing total padded volume by a small DP;
* **envelope grouping** (:func:`group_by_envelope`): cluster many
  circuits into a handful of compatible-envelope groups so a whole suite
  compiles to a few vmapped programs instead of one per circuit.

Both used to live inside ``eval_jax`` and were duplicated (``timing_vec``
imported the DP, ``sweep`` wrapped the grouping behind an adapter shim).
They are jax-free and consume only ``(m, c, b)`` level-width profiles or
objects exposing ``.envelope`` / ``.n_signals`` — which both
:class:`~repro_torch.core.eval_torch.FusedPlan` and
:class:`~repro_torch.core.circuit_ir.CircuitIR` do.

Cache registry
--------------
All content-digest-keyed caches of the lowering/planning stack register
here (:func:`register_cache`) and are cleared together by ONE
:func:`clear_caches`:

* ``netlist_ir`` — functional :class:`CircuitIR` per netlist content
  digest (:func:`repro_torch.core.circuit_ir.lower_netlist_ir`);
* ``eval_plans`` / ``eval_groups`` — the fused evaluator's
  :class:`FusedPlan` and stacked group tensors;
* ``ir_template`` — the sweep engine's per-(circuit digest, seed)
  template IR that sibling structural classes patch
  (:attr:`repro_torch.core.repack.PackPrefix.ir_template`);
* ``placement`` — grid placements per (circuit digest, arch placement
  key, seed) (:func:`repro_torch.core.place.placement_for`) — shared by every
  wire-delay row of a structural class x grid aspect.

Invalidation rule: every key starts with a netlist *content digest*
(:meth:`~repro_torch.core.netlist.Netlist.content_digest`), so structural edits
miss naturally; :func:`clear_caches` exists for tests and for reclaiming
memory, and — unlike the old per-module ``clear_plan_caches()`` — it also
drops the sweep's IR templates, so a cleared registry provably forces
re-lowering (no stale template survives).
"""
from __future__ import annotations


# ---------------------------------------------------------------------------
# cache registry
# ---------------------------------------------------------------------------


class Cache:
    """Bounded LRU mapping with hit/miss/eviction telemetry.

    Eviction is a perf tradeoff, never a correctness one: every consumer
    rebuilds on a miss (re-lowering / re-planning), so a sweep over more
    distinct circuits than a cache's cap still computes correct results —
    it just stops amortizing.  The functional-IR and template caches are
    sized (256) well above the benchmark suites; raise the caps
    (:func:`set_cache_cap`) if a workload legitimately holds more
    circuits warm at once.

    Multi-tenant serving (:mod:`repro.core.serve_flow`) shares these
    caches across requests, so two properties matter beyond the old FIFO
    dict:

    * **LRU order** — a ``get`` hit (or ``[]`` access) refreshes the
      entry, so the steady-state working set of a request mix survives
      one-off circuits streaming through;
    * **counters** — ``hits`` / ``misses`` / ``evictions`` accumulate per
      cache and surface through :func:`cache_stats`; the flow server's
      telemetry and the warm-path cost model both read them.
      ``__contains__`` is a *probe* and deliberately does not count (or
      refresh) — cost models may ask "would this hit?" without skewing
      the stats they are about to report.
    """

    def __init__(self, name: str, cap: int):
        self.name = name
        self.cap = cap
        self._d: dict = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _touch(self, key) -> None:
        # dicts preserve insertion order; re-inserting moves to the end,
        # which is all LRU needs (the first key is the eviction victim)
        self._d[key] = self._d.pop(key)

    def get(self, key, default=None):
        if key in self._d:
            self.hits += 1
            self._touch(key)
            return self._d[key]
        self.misses += 1
        return default

    def put(self, key, value) -> None:
        if key in self._d:
            self._d.pop(key)
        elif len(self._d) >= self.cap:
            self._d.pop(next(iter(self._d)))
            self.evictions += 1
        self._d[key] = value

    def pop(self, key, default=None):
        return self._d.pop(key, default)

    def clear(self) -> None:
        """Drop all entries.  Lifetime counters survive — a clear is an
        invalidation event, not a telemetry reset
        (:func:`reset_cache_stats` does that)."""
        self._d.clear()

    def resize(self, cap: int) -> None:
        """Change the capacity, evicting LRU entries if shrinking."""
        if cap < 1:
            raise ValueError(f"cache {self.name!r}: cap must be >= 1")
        self.cap = cap
        while len(self._d) > cap:
            self._d.pop(next(iter(self._d)))
            self.evictions += 1

    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {"size": len(self._d), "cap": self.cap, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "hit_rate": (self.hits / lookups) if lookups else 0.0}

    def reset_stats(self) -> None:
        self.hits = self.misses = self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    # dict-compatible views/operators so call sites that historically
    # took a plain dict (e.g. sweep_suite's caller-provided ``prefixes``)
    # accept a registry cache interchangeably
    def __getitem__(self, key):
        if key not in self._d:
            self.misses += 1
            raise KeyError(key)
        self.hits += 1
        self._touch(key)
        return self._d[key]

    def __setitem__(self, key, value) -> None:
        self.put(key, value)

    def __iter__(self):
        return iter(self._d)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def items(self):
        return self._d.items()


_REGISTRY: dict[str, Cache] = {}


def register_cache(name: str, cap: int = 64) -> Cache:
    """Create (or fetch) the registry cache ``name``.  Idempotent — module
    reloads and repeated imports share one instance per name."""
    cache = _REGISTRY.get(name)
    if cache is None:
        cache = Cache(name, cap)
        _REGISTRY[name] = cache
    return cache


def clear_caches() -> None:
    """Drop every registered lowering/planning cache at once — functional
    IRs, eval plans, grouped tensors and sweep IR templates.  The single
    invalidation point the per-module ``clear_plan_caches()`` used to
    only partially cover.  Counters survive (a clear is an invalidation,
    not a telemetry reset — see :func:`reset_cache_stats`)."""
    for cache in _REGISTRY.values():
        cache.clear()


def reset_cache_stats() -> None:
    """Zero every registered cache's hit/miss/eviction counters (e.g. at
    flow-server start, so telemetry windows are comparable)."""
    for cache in _REGISTRY.values():
        cache.reset_stats()


def set_cache_cap(name: str, cap: int) -> Cache:
    """Resize the registered cache ``name`` (evicting LRU entries when
    shrinking) — the knob a multi-tenant deployment tunes per cache."""
    cache = _REGISTRY.get(name)
    if cache is None:
        raise KeyError(f"no registered cache named {name!r} "
                       f"(registered: {sorted(_REGISTRY)})")
    cache.resize(cap)
    return cache


def cache_stats() -> dict[str, dict]:
    """Per-cache telemetry: ``{name: {size, cap, hits, misses,
    evictions, hit_rate}}`` — the single surface the flow server's stats
    endpoint, the warm-path cost model diagnostics and the cache tests
    all read.  ``hit_rate`` is derived (``hits / (hits + misses)``; 0.0
    before the first lookup)."""
    return {name: c.stats() for name, c in _REGISTRY.items()}


# ---------------------------------------------------------------------------
# width-bucket segmentation
# ---------------------------------------------------------------------------


def segment_levels(m, c, b, max_buckets: int) -> list[tuple[int, int]]:
    """Partition levels into <= ``max_buckets`` contiguous segments.

    ``m/c/b[t]`` are level ``t``'s LUT-row count, chain count and widest
    chain.  Minimizes the padded row volume ``sum_seg len(seg) * (M_seg +
    C_seg * B_seg)`` by dynamic programming; L is tens at most, so the
    O(K L^2) cost is negligible next to levelization.
    """
    L = len(m)
    if L <= 1:
        return [(0, L)] if L else [(0, 0)]
    K = min(max_buckets, L)

    def seg_cost(i, j):  # cost of segment [i, j)
        mm = max(m[i:j])
        cc = max(c[i:j])
        bb = max(b[i:j])
        return (j - i) * (mm + cc * bb)

    INF = float("inf")
    # dp[k][j]: min cost of first j levels using exactly k segments
    dp = [[INF] * (L + 1) for _ in range(K + 1)]
    back = [[0] * (L + 1) for _ in range(K + 1)]
    dp[0][0] = 0
    for k in range(1, K + 1):
        for j in range(k, L + 1):
            for i in range(k - 1, j):
                if dp[k - 1][i] == INF:
                    continue
                cost = dp[k - 1][i] + seg_cost(i, j)
                if cost < dp[k][j]:
                    dp[k][j] = cost
                    back[k][j] = i
    best_k = min(range(1, K + 1), key=lambda k: dp[k][L])
    bounds = []
    j = L
    for k in range(best_k, 0, -1):
        i = back[k][j]
        bounds.append((i, j))
        j = i
    return bounds[::-1]


def bucket_envelopes(m, c, b, bounds) -> list[tuple[int, int, int]]:
    """Per-bucket ``(M, C, B)`` envelopes of a segmented profile."""
    return [(max(m[i:j], default=0), max(c[i:j], default=0),
             max(b[i:j], default=0)) for i, j in bounds]


def combined_profile(profiles, n_levels: int):
    """Merge member ``(m, c, b)`` profiles into a group profile of
    ``n_levels`` levels (per-level max; members shorter than the group
    contribute zeros)."""
    L = max(n_levels, 1)

    def col(t, sel):
        return max((p[sel][t] if t < len(p[sel]) else 0 for p in profiles),
                   default=0)

    m = [col(t, 0) for t in range(L)]
    c = [col(t, 1) for t in range(L)]
    b = [col(t, 2) for t in range(L)]
    return m, c, b


def padded_rows(bounds, envelopes) -> int:
    """Padded row volume of one segmented profile: ``sum_seg len(seg) *
    (M + C * B)`` — the unit every planning cost model works in."""
    return sum(max(j - i, 1) * (M + C * B)
               for (i, j), (M, C, B) in zip(bounds, envelopes))


# ---------------------------------------------------------------------------
# envelope grouping
# ---------------------------------------------------------------------------


def group_by_envelope(items, max_groups: int = 4,
                      signal_weight: float = 1.0) -> list[list[int]]:
    """Cluster ``items`` into <= ``max_groups`` compatible-envelope groups.

    ``items`` need only expose ``.envelope`` — an ``(L, M, C, B)`` tuple —
    and ``.n_signals``; both :class:`~repro_torch.core.eval_torch.FusedPlan` and
    :class:`~repro_torch.core.circuit_ir.CircuitIR` do, so the evaluator and
    the timing sweep share this single implementation.

    Agglomerative: start one group per item, repeatedly merge the pair
    whose combined layout costs least.  Each resulting group compiles to
    exactly one vmapped jit program.

    The merge cost has two terms, both in "rows of N lane words":

    * the padded *plan* volume ``n * L * (M + C * B)`` of the combined
      worst-case envelope (the index tensors every scan step reads);
    * the padded *value-buffer* volume ``n * max(n_signals)`` weighted by
      ``signal_weight`` — every member's value buffer is padded to the
      group's largest circuit, so co-locating one giant circuit with
      small ones used to make the small members pay the giant's buffer
      rows on every call even when the envelopes merged cheaply.
    """
    groups = [[i] for i in range(len(items))]
    envs = [list(p.envelope) for p in items]
    nsig = [p.n_signals for p in items]

    def vol(env, n):
        L, M, C, B = env
        return n * L * (M + C * B)

    def cost_of(env, ns, n):
        return vol(env, n) + signal_weight * n * ns

    def merged(e1, e2):
        return [max(a, b) for a, b in zip(e1, e2)]

    while len(groups) > max(max_groups, 1):
        best = None
        for i in range(len(groups)):
            for j in range(i + 1, len(groups)):
                me = merged(envs[i], envs[j])
                mns = max(nsig[i], nsig[j])
                ni, nj = len(groups[i]), len(groups[j])
                cost = (cost_of(me, mns, ni + nj)
                        - cost_of(envs[i], nsig[i], ni)
                        - cost_of(envs[j], nsig[j], nj))
                if best is None or cost < best[0]:
                    best = (cost, i, j, me, mns)
        _, i, j, me, mns = best
        groups[i] = groups[i] + groups[j]
        envs[i] = me
        nsig[i] = mns
        del groups[j], envs[j], nsig[j]
    return groups
