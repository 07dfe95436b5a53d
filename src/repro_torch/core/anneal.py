"""Batched simulated-annealing placement refinement over the analytic seed
(the port of ``repro/core/anneal.py``: its canonical numpy chain copied,
its jax multi-chain ensemble in torch).

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
``backend="numpy"`` (canonical, bit-deterministic) runs one chain;
``backend="torch"`` runs a :data:`CHAINS`-wide ensemble of independently
seeded chains as one batched program on ``device`` (the port of the
reference's vmapped ``lax.scan``, ``backend="jax"`` there: chains are a
batch axis, steps a Python loop over pre-generated move streams, dense
degree-padded adjacency, a scatter-min claim table, in-loop best
tracking) and keeps the candidate with the lowest *exact*
(numpy-recomputed) wirelength, seed included — so legality and the
never-worse guarantee are backend-independent even though the chains
explore different trajectories.  Each chain is the canonical numpy
chain seeded with ``_rng(..., chain=ch)``: :func:`_ensemble_chains` runs
either form chain by chain, the numpy one being the plain version the
batch is held to.  The chain count is the module constant
:data:`CHAINS` (4, the reference's default), not the reference's
``chains`` argument: no caller, there or here, passes another count.

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
from ..device import resolve_device

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
#: chains of the torch ensemble (the reference's ``chains=4`` default)
CHAINS = 4

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
# torch multi-chain ensemble
# ---------------------------------------------------------------------------


def _streams(p: dict, digest, pkey, seed, t_final, chains):
    """Every chain's move stream, drawn on the host exactly as the
    canonical chain draws it (the chain index in the generator's seed;
    the probe batch, then per step the LBs, the two offsets and the
    uniforms), so each chain of the batch *is* a numpy chain.  Arrays are
    step-major, ``[steps, chains, moves]`` and temperatures ``[steps,
    chains]``, so one step's slice is contiguous."""
    x0, y0, W, H = p["x0"], p["y0"], p["W"], p["H"]
    steps, moves, L = p["steps"], p["moves"], x0.size
    occ0 = np.full(W * H, -1, dtype=np.int32)
    occ0[x0 * H + y0] = np.arange(L, dtype=np.int32)
    A = np.empty((steps, chains, moves), dtype=np.int64)
    DX = np.empty((steps, chains, moves), dtype=np.int64)
    DY = np.empty((steps, chains, moves), dtype=np.int64)
    U = np.empty((steps, chains, moves), dtype=np.float64)
    temps = np.empty((steps, chains))
    for ch in range(chains):
        rng = _rng(digest, pkey, seed, chain=ch)
        t0 = _probe_t0(p["ptr"], p["nbr"], p["wts"], x0, y0, occ0, W, H,
                       rng)
        temps[:, ch], wins = _schedules(W, H, t0, t_final, steps)
        for k in range(steps):
            win = int(wins[k])
            A[k, ch] = rng.integers(0, L, moves)
            DX[k, ch] = rng.integers(-win, win + 1, moves)
            DY[k, ch] = rng.integers(-win, win + 1, moves)
            U[k, ch] = rng.random(moves)
    return occ0, A, DX, DY, U, temps


def _anneal_chains_torch(p: dict, digest, pkey, seed, t_final, chains,
                         device):
    """``chains`` independently seeded annealing trajectories of problem
    ``p`` (:func:`_problem`) as one batched program on ``device``: chains
    are the leading axis of every state tensor, steps a Python loop.
    Coordinates and slots are int64, costs and temperatures float64,
    adjacency degree-padded dense (pad neighbour 0 with weight 0).
    Returns per-chain ``(cost, x, y)`` best snapshots as numpy."""
    import torch

    ptr, x0, y0, W, H = p["ptr"], p["x0"], p["y0"], p["W"], p["H"]
    L, WH, C, M = x0.size, W * H, chains, p["moves"]
    deg = np.diff(ptr).astype(np.int64)
    D = max(int(deg.max(initial=0)), 1)
    rows = np.repeat(np.arange(L), deg)
    cols = np.arange(rows.size) - np.repeat(ptr[:-1], deg)
    nbr_pad = np.zeros((L, D), dtype=np.int64)
    w_pad = np.zeros((L, D), dtype=np.float64)
    nbr_pad[rows, cols] = p["nbr"]
    w_pad[rows, cols] = p["wts"]
    occ0, A, DX, DY, U, temps = _streams(p, digest, pkey, seed, t_final, C)

    def to(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    A, DX, DY, U, temps = to(A), to(DX), to(DY), to(U), to(temps)
    nbr_t, w_t = to(nbr_pad), to(w_pad)
    src = to(p["edge_src"].astype(np.int64))
    dst = to(p["edge_dst"].astype(np.int64))
    ew = to(p["edge_w"].astype(np.float64))
    # one dummy column past the end of x / y (LB L) and occ (slot WH):
    # commits of moves that do not commit are redirected there
    x = to(np.append(x0, 0)).repeat(C, 1)
    y = to(np.append(y0, 0)).repeat(C, 1)
    occ = to(np.append(occ0.astype(np.int64), 0)).repeat(C, 1)
    ids = torch.arange(M, device=device).expand(C, M)
    ids4 = ids[..., None].expand(C, M, 4).reshape(C, -1)
    dummy = L + WH

    def cost_of():
        return (ew * ((x[:, src] - x[:, dst]).abs()
                      + (y[:, src] - y[:, dst]).abs())).sum(1)

    def incident(ent, nx, ny, partner, pnx, pny):
        n = nbr_t[ent]                                    # [C, M, D]
        w = w_t[ent]
        xn = x.gather(1, n.view(C, -1)).view(C, M, -1)
        yn = y.gather(1, n.view(C, -1)).view(C, M, -1)
        is_p = n == partner[..., None]
        cnx = torch.where(is_p, pnx[..., None], xn)
        cny = torch.where(is_p, pny[..., None], yn)
        old = (x.gather(1, ent)[..., None] - xn).abs() \
            + (y.gather(1, ent)[..., None] - yn).abs()
        new = (nx[..., None] - cnx).abs() + (ny[..., None] - cny).abs()
        return (w * (new - old)).sum(2)

    cost = cost_of()
    best_cost, best_x, best_y = cost, x.clone(), y.clone()
    for k in range(p["steps"]):
        a = A[k]
        sx, sy = x.gather(1, a), y.gather(1, a)
        tx = (sx + DX[k]).clamp_(0, W - 1)
        ty = (sy + DY[k]).clamp_(0, H - 1)
        tslot, sslot = tx * H + ty, sx * H + sy
        b = occ.gather(1, tslot)
        hasb = b >= 0
        bb = torch.where(hasb, b, 0)
        delta = incident(a, tx, ty, b, sx, sy) \
            + torch.where(hasb, incident(bb, sx, sy, a, tx, ty), 0.0)
        T = temps[k].clamp_min(1e-9)[:, None]
        accept = (b != a) & ((delta <= 0.0) | (
            U[k] < torch.exp(-delta.clamp_min(0.0) / T)))
        # conflict-free commit: first accepted claimer per resource wins
        res = torch.stack([a, torch.where(hasb, b, dummy), L + sslot,
                           L + tslot], dim=2)                 # [C, M, 4]
        claim = torch.full((C, dummy + 1), M, dtype=torch.int64,
                           device=device)
        claim.scatter_reduce_(
            1, torch.where(accept[..., None], res, dummy).view(C, -1),
            ids4, reduce="amin", include_self=True)
        won = claim.gather(1, res.view(C, -1)).view(C, M, 4) \
            == ids[..., None]
        kept = accept & (won.all(2) | (~hasb & won[..., 0] & won[..., 2]
                                       & won[..., 3]))
        # Dummy-row redirection, as in the reference: the kept moves touch
        # disjoint LBs and slots, so every duplicate index of these
        # scatters is the dummy column, and the order in which CUDA
        # applies duplicate writes cannot change a result.
        ia = torch.where(kept, a, L)
        ib = torch.where(kept & hasb, bb, L)
        x.scatter_(1, ia, tx).scatter_(1, ib, sx)
        y.scatter_(1, ia, ty).scatter_(1, ib, sy)
        occ.scatter_(1, torch.where(kept, tslot, WH), a) \
            .scatter_(1, torch.where(kept, sslot, WH),
                      torch.where(hasb, b, -1))
        cost = cost_of()
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_x = torch.where(better[:, None], x, best_x)
        best_y = torch.where(better[:, None], y, best_y)
    return (best_cost.cpu().numpy(), best_x[:, :L].cpu().numpy(),
            best_y[:, :L].cpu().numpy())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _problem(ir: CircuitIR, arch: ArchParams, seed_pl, mode: str,
             steps, moves, timing_weight: float, crit_exp: float):
    """The annealing inputs of ``seed_pl``: routed edges and their
    weights, the adjacency CSR, the grid, the seed coordinates and the
    schedule's size; ``None`` when there is nothing to anneal (<= 1 LB
    or no routed edge)."""
    from .place import _routed_edges

    if mode not in REFINE_MODES:
        raise ValueError(
            f"unknown refine mode {mode!r} (choose from {REFINE_MODES})")
    L = seed_pl.n_lbs
    src, dst = _routed_edges(ir)
    if L <= 1 or not src.size:
        return None
    if mode == "anneal_timing":
        edge_w = criticality_weights(ir, arch, timing_weight=timing_weight,
                                     crit_exp=crit_exp)
    else:
        edge_w = np.ones(src.size, dtype=np.float64)
    ptr, nbr, wts = _adjacency(L, src, dst, edge_w)
    return {"ptr": ptr, "nbr": nbr, "wts": wts, "edge_src": src,
            "edge_dst": dst, "edge_w": edge_w,
            "x0": seed_pl.lb_x.astype(np.int64),
            "y0": seed_pl.lb_y.astype(np.int64),
            "W": seed_pl.grid_w, "H": seed_pl.grid_h,
            "steps": _default_steps(L) if steps is None else int(steps),
            "moves": _default_moves(L) if moves is None else int(moves)}


def _wirecost(p: dict, x, y) -> float:
    """Exact numpy annealing cost of coordinates ``(x, y)``."""
    src, dst = p["edge_src"], p["edge_dst"]
    return float((p["edge_w"] * (np.abs(x[src] - x[dst])
                                 + np.abs(y[src] - y[dst]))).sum())


def _chains(p: dict, digest: str, pkey: tuple, seed: int, t_final: float,
            chains: int, backend: str, device):
    if backend == "torch":
        return _anneal_chains_torch(p, digest, pkey, seed, t_final, chains,
                                    device)
    runs = [_anneal_chain_numpy(
        p["ptr"], p["nbr"], p["wts"], p["edge_src"], p["edge_dst"],
        p["edge_w"], p["x0"], p["y0"], p["W"], p["H"],
        _rng(digest, pkey, seed, chain=ch), p["steps"], p["moves"],
        t_final) for ch in range(chains)]
    return (np.array([r[0] for r in runs], dtype=np.float64),
            np.stack([r[1] for r in runs]), np.stack([r[2] for r in runs]))


def _check_backend(backend: str, device):
    """The device the backend runs on (``None`` for numpy)."""
    if backend == "jax":
        raise ValueError(
            "the multi-chain anneal backend of the port is 'torch' (the "
            "reference's 'jax' ensemble runs on the device in torch here)")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown anneal backend {backend!r}")
    return resolve_device(device) if backend == "torch" else None


def _ensemble_chains(ir: CircuitIR, arch: ArchParams, seed_pl, *,
                     seed: int = 0, mode: str = "anneal",
                     backend: str = "torch", steps: int | None = None,
                     moves: int | None = None, device=None):
    """Every chain's best snapshot, ``(cost [CHAINS], x [CHAINS, L],
    y [CHAINS, L])``, before the ensemble's final pick: the batched
    program (``backend="torch"``, on ``device``) or the canonical numpy
    chain run once per chain with ``_rng(..., chain=ch)``
    (``backend="numpy"``), the plain version the batch is held to.
    ``None`` when there is nothing to anneal."""
    dev = _check_backend(backend, device)
    p = _problem(ir, arch, seed_pl, mode, steps, moves, _DEF_TIMING_WEIGHT,
                 _DEF_CRIT_EXP)
    if p is None:
        return None
    return _chains(p, seed_pl.net_digest, seed_pl.placement_key, seed,
                   _DEF_T_FINAL, CHAINS, backend, dev)


def refine_placement(ir: CircuitIR, arch: ArchParams, seed_pl, *,
                     seed: int = 0, mode: str = "anneal",
                     backend: str = "numpy",
                     steps: int | None = None, moves: int | None = None,
                     t_final: float = _DEF_T_FINAL,
                     timing_weight: float = _DEF_TIMING_WEIGHT,
                     crit_exp: float = _DEF_CRIT_EXP, device=None):
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
    ``backend="torch"`` runs a :data:`CHAINS`-wide ensemble on ``device``
    (default: the card) and keeps the best of ``[seed] + chains`` by the
    exact numpy cost; the reference's name for it, ``"jax"``, raises
    ``ValueError``.
    """
    import time

    from .place import GridPlacement

    dev = _check_backend(backend, device)
    t_start = time.perf_counter()
    p = _problem(ir, arch, seed_pl, mode, steps, moves, timing_weight,
                 crit_exp)
    if p is None:
        _record_wall(time.perf_counter() - t_start)
        return seed_pl
    ANNEAL_COUNTS["anneal"] += 1
    digest, pkey = seed_pl.net_digest, seed_pl.placement_key
    bc, bx, by = _chains(p, digest, pkey, seed, t_final,
                         CHAINS if backend == "torch" else 1,
                         backend, dev)
    # exact numpy re-score with the seed in the candidate pool; a numpy
    # chain's best snapshot already starts at the seed and moves only on
    # a strictly lower cost, so for the one canonical chain this pick is
    # that chain's best
    cands = [(_wirecost(p, p["x0"], p["y0"]), p["x0"], p["y0"])]
    cands += [(_wirecost(p, bx[ch], by[ch]), bx[ch], by[ch])
              for ch in range(bc.shape[0])]
    _, best_x, best_y = min(cands, key=lambda t: t[0])
    out = GridPlacement(p["W"], p["H"], best_x.astype(np.int32),
                        best_y.astype(np.int32), seed_pl.seed,
                        digest, pkey, refine=mode)
    _record_wall(time.perf_counter() - t_start)
    return out
