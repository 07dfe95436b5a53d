"""Batched simulated-annealing placement refinement over the analytic seed
(the port of ``repro/core/anneal.py``: its canonical numpy chain, copied).

The analytic placer (:mod:`repro_torch.core.place`) is legalization-limited:
the damped Laplacian relaxation finds a good *relative* ordering, but the
stable-sort snap into grid columns scrambles local structure — on the
benchmark suites the legalized wirelength sits well above what the slot
assignment could achieve.  This module closes that gap with a
fully-vectorized simulated annealer:

* **Bulk move proposal.**  Every temperature step proposes ``moves``
  independent moves at once: a random LB and a random target slot inside
  a cooling-range window around its current position (VPR-style range
  limiting — wide exploratory hops at high T, local shuffles near the
  end).  An occupied target is a *swap*, an empty one a *relocate*.
* **Vectorized HPWL deltas.**  Each move's wirelength delta is computed
  independently from the LB-level adjacency CSR (built once from the
  IR's fanin CSR) with flattened gather/scatter arithmetic —
  ``np.repeat`` ragged gathers of every proposed LB's incident edges,
  partner-corrected neighbour coordinates, one ``np.add.at`` reduction
  per batch.  No Python loop touches an edge.
* **Bulk conflict-free acceptance.**  Metropolis-accepted moves are
  applied together when they touch disjoint resources (the moved LB,
  the swap partner, both slots): a scatter-``min`` claim table keeps,
  per resource, only the first accepted claimer, and a move commits iff
  it won every resource it touches.  Interactions *through shared nets*
  between two committed moves are deliberately tolerated (classic
  parallel-annealing approximation) because the true cost is recomputed
  exactly — one O(E) gather — after every bulk apply.
* **Exact best-snapshot.**  The returned placement is the best exact
  cost ever observed, *including the analytic seed itself*, so
  refinement can never return something worse than its seed — the
  ``wirelength(refined) <= wirelength(seed)`` gate holds by
  construction, not by luck.

Timing-driven weighting
-----------------------
``mode="anneal_timing"`` weights every routed edge by its timing
criticality so near-critical nets pull harder than bulk nets.  The
weights derive from the vectorized static-timing substrate
(:mod:`repro_torch.core.timing_vec`): a forward arrival pass at **zero wire
delay** (the class-canonical timing — placement must not depend on the
wire tiers it is about to decide, or the place-once-per-key cache
contract dies), then a levelized backward required-time pass over the
fanin CSR gives per-edge slack; ``crit = clip(1 - slack / cp, 0, 1)``
and ``w = 1 + timing_weight * crit**crit_exp`` (VPR's criticality
exponent).  Chain carry ripple is absorbed into the sum bits' node
delays, so chain-operand criticality is a documented mild
underestimate.  Weights are cached in the :mod:`repro_torch.core.plan`
registry (``"criticality"``) keyed by (netlist digest, structural key,
non-wire delay signature) — the delay row matters (fan-in moves the
Z-pin mux delay), the wire tiers never do.

Backends
--------
``backend="numpy"`` (canonical, bit-deterministic) runs one chain, and
is the only backend here so far.  The reference also runs a
``chains``-wide ensemble of independently seeded chains as one vmapped
``lax.scan`` program (``backend="jax"``) and keeps the candidate with the
lowest exact wirelength, seed included; its batched torch counterpart is
not ported yet (``ROADMAP.md``, Queue 1 item 3), and ``backend="jax"``
raises ``NotImplementedError``.

Determinism: every random stream is a ``blake2b`` of
``("anneal", digest, placement_key, seed[, chain])`` — same inputs, same
refined placement, bit for bit (the contract
:func:`repro_torch.core.place.placement_for` caches under).
"""
from __future__ import annotations

import hashlib

import numpy as np

from . import plan as _planner
from .alm import DELAY_FIELDS, ArchParams
from .circuit_ir import CircuitIR

#: instrumentation: refinement solves / criticality solves vs cache hits
ANNEAL_COUNTS = {"anneal": 0, "crit_solve": 0, "crit_hit": 0}
#: wall seconds spent inside refinement — the sweep/search ledgers read
#: the delta around their placement phase to attribute annealing cost
ANNEAL_WALL = {"s": 0.0, "calls": 0}

#: criticality weight vectors per (digest, structural key, delay sig)
_CRIT_CACHE = _planner.register_cache("criticality", cap=256)

#: delay-table fields that must NOT steer placement weighting (the
#: placement cache key promises one placement per wire-delay family)
_WIRE_FIELDS = ("t_wire_hop1", "t_wire_hop2", "t_wire_long")

_DEF_T_FINAL = 0.05
_DEF_TIMING_WEIGHT = 4.0
_DEF_CRIT_EXP = 2.0

REFINE_MODES = ("anneal", "anneal_timing")


def read_anneal_wall() -> dict:
    return dict(ANNEAL_WALL)


def _record_wall(seconds: float) -> None:
    ANNEAL_WALL["s"] += seconds
    ANNEAL_WALL["calls"] += 1


def _rng(digest: str, placement_key: tuple, seed: int, chain: int = 0):
    """Deterministic move stream, distinct from the analytic scatter's
    stream (tagged) and per chain."""
    h = hashlib.blake2b(
        repr(("anneal", digest, placement_key, seed, chain)).encode(),
        digest_size=8)
    return np.random.default_rng(int.from_bytes(h.digest(), "big"))


def delay_signature(arch: ArchParams) -> tuple:
    """The delay-table row minus the wire-tier fields — the only delay
    inputs criticality weighting is allowed to read."""
    return tuple(float(getattr(arch, f)) for f in DELAY_FIELDS
                 if f not in _WIRE_FIELDS)


# ---------------------------------------------------------------------------
# criticality weights (timing-driven mode)
# ---------------------------------------------------------------------------


def edge_criticality(ir: CircuitIR, arch: ArchParams) -> np.ndarray:
    """Per-fanin-CSR-edge timing criticality in ``[0, 1]`` at zero wire
    delay.

    Forward: oracle-order arrival times (:func:`timing_vec.
    arrival_times_numpy`) with the wire-tier components zeroed.
    Backward: required times by a levelized scatter-min over the CSR —
    for an edge ``u -> v``, the required arrival at ``u`` through that
    edge is ``required[v] - node_delay[v] - edge_delay(u, v)`` where
    ``node_delay[v] = arrival[v] - max_in_t[v]`` (which absorbs chain
    carry ripple for sum bits — chain-operand criticality is therefore a
    mild underestimate).  ``crit = clip(1 - slack / cp, 0, 1)``.
    """
    from .timing_vec import arrival_times_numpy, delay_components

    idx = {f: i for i, f in enumerate(DELAY_FIELDS)}
    table = arch.delay_table()
    for f in _WIRE_FIELDS:
        table[idx[f]] = 0.0
    comps = delay_components(table)
    arr = arrival_times_numpy(ir, comps)
    cp = float(arr[ir.po_sig].max()) if ir.po_sig.size else 0.0
    cp = max(cp, 1.0)

    E = ir.fanin_sig.size
    if not E:
        return np.zeros(0, dtype=np.float64)
    dst = np.repeat(np.arange(ir.n_signals, dtype=np.int32),
                    np.diff(ir.fanin_ptr))
    ec = comps["edge"][ir.fanin_cls]              # [E, 3] route/pin/path
    d_e = ec[:, 0] + ec[:, 1] + ec[:, 2]
    in_t = arr[ir.fanin_sig] + d_e
    tin = np.full(ir.n_signals, -np.inf)
    np.maximum.at(tin, dst, in_t)
    node_delay = np.where(np.isfinite(tin), arr - tin, 0.0)
    node_delay = np.maximum(node_delay, 0.0)

    req = np.full(ir.n_signals, np.inf)
    req[ir.po_sig] = cp
    dst_level = ir.sig_level[dst]
    for lv in range(int(dst_level.max(initial=0)), 0, -1):
        m = dst_level == lv
        if not m.any():
            continue
        cand = req[dst[m]] - node_delay[dst[m]] - d_e[m]
        np.minimum.at(req, ir.fanin_sig[m], cand)

    slack = (req[dst] - node_delay[dst] - d_e) - arr[ir.fanin_sig]
    crit = 1.0 - slack / cp
    return np.clip(np.where(np.isfinite(slack), crit, 0.0), 0.0, 1.0)


def criticality_weights(ir: CircuitIR, arch: ArchParams, *,
                        timing_weight: float = _DEF_TIMING_WEIGHT,
                        crit_exp: float = _DEF_CRIT_EXP,
                        cache: bool = True) -> np.ndarray:
    """Registry-cached per-*routed*-edge annealing weights ``1 +
    timing_weight * crit**crit_exp`` (aligned with
    :func:`repro_torch.core.place._routed_edges` order)."""
    key = (ir.net_digest, arch.structural_key(), delay_signature(arch),
           float(timing_weight), float(crit_exp))
    if cache:
        hit = _CRIT_CACHE.get(key)
        if hit is not None:
            ANNEAL_COUNTS["crit_hit"] += 1
            return hit
    ANNEAL_COUNTS["crit_solve"] += 1
    crit = edge_criticality(ir, arch)
    dst = np.repeat(np.arange(ir.n_signals, dtype=np.int32),
                    np.diff(ir.fanin_ptr))
    src_lb = ir.sig_lb[ir.fanin_sig]
    dst_lb = ir.sig_lb[dst]
    m = (src_lb >= 0) & (dst_lb >= 0) & (src_lb != dst_lb)
    w = 1.0 + timing_weight * crit[m] ** crit_exp
    if cache:
        _CRIT_CACHE.put(key, w)
    return w


# ---------------------------------------------------------------------------
# shared geometry
# ---------------------------------------------------------------------------


def _adjacency(L: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray):
    """Undirected LB adjacency CSR (both directions of every routed
    edge; parallel edges kept — their weights simply add per move)."""
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    ww = np.concatenate([w, w])
    order = np.argsort(a, kind="stable")
    a, b, ww = a[order], b[order], ww[order]
    ptr = np.zeros(L + 1, dtype=np.int64)
    np.add.at(ptr, a + 1, 1)
    ptr = np.cumsum(ptr)
    return ptr, b.astype(np.int32), ww.astype(np.float64)


def _schedules(W: int, H: int, t0: float, t_final: float, steps: int):
    """Geometric temperature and range-window schedules, precomputed so
    every chain backend runs the identical annealing plan."""
    span0 = max(W, H, 2)
    temps = np.empty(steps)
    wins = np.empty(steps, dtype=np.int64)
    for k in range(steps):
        frac = k / max(steps - 1, 1)
        temps[k] = t0 * (t_final / t0) ** frac
        wins[k] = max(1, int(round(span0 ** (1.0 - frac))))
    return temps, wins


def _default_steps(L: int) -> int:
    return 96


def _default_moves(L: int) -> int:
    return int(max(32, min(2 * L, 2048)))


# ---------------------------------------------------------------------------
# numpy chain (canonical)
# ---------------------------------------------------------------------------


def _incident_delta(ptr, nbr, wts, px, py, ent, nx, ny,
                    partner, pnx, pny) -> np.ndarray:
    """Per-move incident-cost delta of moving ``ent`` from its current
    slot to ``(nx, ny)`` while ``partner`` (or -1) simultaneously moves
    to ``(pnx, pny)`` — one ragged gather over every proposed LB's
    adjacency, one scatter-add back to moves."""
    P = ent.size
    deg = (ptr[ent + 1] - ptr[ent]).astype(np.int64)
    total = int(deg.sum())
    out = np.zeros(P, dtype=np.float64)
    if not total:
        return out
    mid = np.repeat(np.arange(P), deg)
    offs = np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(deg) - deg, deg)
    fl = ptr[ent][mid] + offs
    n = nbr[fl]
    w = wts[fl]
    is_p = n == partner[mid]
    cnx = np.where(is_p, pnx[mid], px[n])
    cny = np.where(is_p, pny[mid], py[n])
    old = np.abs(px[ent][mid] - px[n]) + np.abs(py[ent][mid] - py[n])
    new = np.abs(nx[mid] - cnx) + np.abs(ny[mid] - cny)
    np.add.at(out, mid, w * (new - old))
    return out


def _probe_t0(ptr, nbr, wts, x, y, occ, W, H, rng, n: int = 256) -> float:
    """Initial temperature from a probe batch: ~60 % of median-magnitude
    uphill moves accepted at step 0."""
    L = x.size
    a = rng.integers(0, L, n).astype(np.int32)
    tx = rng.integers(0, W, n).astype(np.int32)
    ty = rng.integers(0, H, n).astype(np.int32)
    b = occ[tx * H + ty]
    sx, sy = x[a], y[a]
    d_a = _incident_delta(ptr, nbr, wts, x, y, a, tx, ty, b, sx, sy)
    bb = np.where(b >= 0, b, 0).astype(np.int32)
    d_b = _incident_delta(ptr, nbr, wts, x, y, bb, sx, sy, a, tx, ty)
    d = d_a + np.where(b >= 0, d_b, 0.0)
    d = d[b != a]
    mag = float(np.abs(d).mean()) if d.size else 1.0
    return max(1.0, 2.0 * mag)


def _anneal_chain_numpy(ptr, nbr, wts, edge_src, edge_dst, edge_w,
                        x0, y0, W, H, rng, steps, moves, t_final):
    """One annealing chain.  Returns ``(best_cost, best_x, best_y)`` —
    the exact-cost best snapshot, seeded with the input placement."""
    L = x0.size
    x, y = x0.astype(np.int64).copy(), y0.astype(np.int64).copy()
    occ = np.full(W * H, -1, dtype=np.int32)
    occ[x * H + y] = np.arange(L, dtype=np.int32)

    def cost_of(px, py):
        return float((edge_w * (np.abs(px[edge_src] - px[edge_dst])
                                + np.abs(py[edge_src] - py[edge_dst])
                                )).sum())

    cost = cost_of(x, y)
    best_cost, best_x, best_y = cost, x.copy(), y.copy()
    t0 = _probe_t0(ptr, nbr, wts, x, y, occ, W, H, rng)
    temps, wins = _schedules(W, H, t0, t_final, steps)
    idx = np.arange(moves)
    for k in range(steps):
        T, win = float(temps[k]), int(wins[k])
        a = rng.integers(0, L, moves).astype(np.int32)
        dx = rng.integers(-win, win + 1, moves)
        dy = rng.integers(-win, win + 1, moves)
        u = rng.random(moves)
        tx = np.clip(x[a] + dx, 0, W - 1).astype(np.int64)
        ty = np.clip(y[a] + dy, 0, H - 1).astype(np.int64)
        tslot = tx * H + ty
        b = occ[tslot]
        self_move = b == a
        sx, sy = x[a], y[a]
        sslot = sx * H + sy
        d_a = _incident_delta(ptr, nbr, wts, x, y, a, tx, ty, b, sx, sy)
        bb = np.where(b >= 0, b, 0).astype(np.int32)
        d_b = _incident_delta(ptr, nbr, wts, x, y, bb, sx, sy, a, tx, ty)
        delta = d_a + np.where(b >= 0, d_b, 0.0)
        accept = ~self_move & (
            (delta <= 0.0)
            | (u < np.exp(-np.maximum(delta, 0.0) / max(T, 1e-9))))
        if not accept.any():
            continue
        # conflict-free commit: first accepted claimer per resource wins
        res = np.stack([a.astype(np.int64), np.where(b >= 0, b, -1),
                        L + sslot, L + tslot], axis=1)
        claim = np.full(L + W * H, moves, dtype=np.int64)
        acc = np.flatnonzero(accept)
        r = res[acc]
        valid = r >= 0
        np.minimum.at(claim, r[valid],
                      np.repeat(acc, valid.sum(axis=1)))
        ok = accept.copy()
        for c in range(4):
            col = res[:, c]
            v = col >= 0
            ok &= ~v | (claim[np.clip(col, 0, None)] == idx)
        kept = np.flatnonzero(ok)
        if not kept.size:
            continue
        ka, kb = a[kept], b[kept]
        x[ka], y[ka] = tx[kept], ty[kept]
        occ[tslot[kept]] = ka
        hasb = kb >= 0
        occ[sslot[kept]] = np.where(hasb, kb, -1).astype(np.int32)
        x[kb[hasb]] = sx[kept][hasb]
        y[kb[hasb]] = sy[kept][hasb]
        cost = cost_of(x, y)
        if cost < best_cost:
            best_cost, best_x, best_y = cost, x.copy(), y.copy()
    return best_cost, best_x, best_y


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def refine_placement(ir: CircuitIR, arch: ArchParams, seed_pl, *,
                     seed: int = 0, mode: str = "anneal",
                     backend: str = "numpy",
                     steps: int | None = None, moves: int | None = None,
                     t_final: float = _DEF_T_FINAL,
                     timing_weight: float = _DEF_TIMING_WEIGHT,
                     crit_exp: float = _DEF_CRIT_EXP):
    """Anneal-refine the analytic seed placement ``seed_pl`` of ``ir``.

    Returns a :class:`repro_torch.core.place.GridPlacement` on the same grid
    that is (a) legal (one LB per slot — moves only permute/relocate
    within the grid), (b) bit-deterministic per ``(digest,
    placement_key, seed, mode)``, and (c) never worse than the seed
    under the annealing objective — for ``mode="anneal"`` (uniform
    weights) that objective *is* the wirelength
    :meth:`~repro_torch.core.place.GridPlacement.wirelength` reports, so
    ``wirelength(refined) <= wirelength(seed)`` always holds.
    ``mode="anneal_timing"`` weights edges by slack-derived criticality
    (near-critical nets contract harder); the guarantee then applies to
    the weighted cost and the *best-weighted* snapshot is returned.
    The reference's multi-chain ensemble (``backend="jax"``) is not
    ported yet and raises ``NotImplementedError``.
    """
    import time

    from .place import GridPlacement, _routed_edges

    if mode not in REFINE_MODES:
        raise ValueError(
            f"unknown refine mode {mode!r} (choose from {REFINE_MODES})")
    t_start = time.perf_counter()
    L = seed_pl.n_lbs
    src, dst = _routed_edges(ir)
    if L <= 1 or not src.size:
        _record_wall(time.perf_counter() - t_start)
        return seed_pl
    if mode == "anneal_timing":
        edge_w = criticality_weights(ir, arch, timing_weight=timing_weight,
                                     crit_exp=crit_exp)
    else:
        edge_w = np.ones(src.size, dtype=np.float64)
    ANNEAL_COUNTS["anneal"] += 1
    W, H = seed_pl.grid_w, seed_pl.grid_h
    ptr, nbr, wts = _adjacency(L, src, dst, edge_w)
    steps = _default_steps(L) if steps is None else int(steps)
    moves = _default_moves(L) if moves is None else int(moves)
    pkey = seed_pl.placement_key
    x0 = seed_pl.lb_x.astype(np.int64)
    y0 = seed_pl.lb_y.astype(np.int64)

    if backend == "jax":
        raise NotImplementedError(
            "the multi-chain annealer (backend='jax' in the reference) is "
            "not ported yet (ROADMAP.md, Queue 1 item 3); use "
            "backend='numpy'")
    if backend != "numpy":
        raise ValueError(f"unknown anneal backend {backend!r}")
    rng = _rng(seed_pl.net_digest, pkey, seed)
    _, best_x, best_y = _anneal_chain_numpy(
        ptr, nbr, wts, src, dst, edge_w, x0, y0, W, H, rng,
        steps, moves, t_final)
    out = GridPlacement(W, H, best_x.astype(np.int32),
                        best_y.astype(np.int32), seed_pl.seed,
                        seed_pl.net_digest, pkey, refine=mode)
    _record_wall(time.perf_counter() - t_start)
    return out
