"""Batched analytic grid placement over packed :class:`CircuitIR` (the
port of ``repro/core/place.py``: its canonical numpy placer copied, its
jax ensemble in torch).

The pack stage assigns ALMs to logic blocks but says nothing about
*where* those LBs sit on the fabric, so every inter-LB edge used to time
as if routing were free.  This module places each packed circuit's LBs
onto a ``grid_w x grid_h`` grid of slots and feeds the resulting
Manhattan hop distances back into the IR's wire-tier columns
(:func:`repro_torch.core.circuit_ir.apply_placement`), where the tiered-fabric
delay model (tile-local / 1-hop / 2-hop / long wires, same hierarchy as
the apicula fabric notes in SNIPPETS.md) prices them.

Algorithm — classic two-phase analytic placement, fully vectorized:

1. **Quadratic relaxation.**  Build the LB-level connectivity matrix
   ``A`` from the IR's fanin CSR (:func:`lb_connectivity`), scatter LBs
   at deterministic random coordinates in the unit square, then run a
   fixed number of damped Laplacian-smoothing sweeps
   ``pos <- (A @ pos + alpha * pos) / (deg + alpha)`` — each LB moves to
   the weighted centroid of its neighbours, the discrete minimizer step
   of the quadratic wirelength model.  After every sweep the coordinates
   are min-max rescaled back to the unit square: the rescale is the
   overlap-spreading force that stops the classic quadratic collapse to
   a point.
2. **Deterministic legalization.**  Sort LBs by relaxed x into
   ``grid_w`` columns of ``grid_h`` slots, then by relaxed y within each
   column (stable sorts, index tie-break), yielding one legal slot per
   LB — capacity 1, no overlap, reproducible bit-for-bit from
   ``(netlist digest, structural key, seed)``.

The relaxation is plain array arithmetic, so it runs either as numpy
(the canonical, bit-deterministic default) or as a torch program on the
card (``backend="torch"``, the reference's ``"jax"``) batched over an
ensemble of starting scatters with the best final wirelength kept — the
batched axis the sweep engine uses when placing circuits x archs.  The
reference's ensemble relaxes in float32 (jax's default; it never enters
64-bit mode); the port's relaxes in float64, the canonical numpy
precision, so each member lands within rounding of ``_smooth_numpy`` on
the same start.  The ensemble's width is the module constant
:data:`ENSEMBLES` and the refining annealer's chain count
:data:`repro_torch.core.anneal.CHAINS` (both 4, the reference's
defaults), not the reference's ``ensembles`` / ``anneal_chains``
arguments: no caller, there or here, passes other counts.
Legalization is always numpy: downstream bit-identity
gates compare vectorized timing against the placed oracle *on whatever
placement was produced*, so the backend choice never touches the timing
contract.

Refinement: ``place_ir(refine="anneal")`` hands the analytic result to
the batched simulated annealer in :mod:`repro_torch.core.anneal` (uniform
weights; ``refine="anneal_timing"`` adds slack-derived criticality
weights).  The refined placement lives on the same grid, stays legal,
and is never worse than its seed under the refinement objective — see
the anneal module docstring for the guarantees.

Caching: placements register in the :mod:`repro_torch.core.plan` registry
(``"placement"``) keyed ``(netlist digest, arch placement key, seed)``,
extended with the refine mode when refinement is requested (and, for
the timing-driven mode, the arch's non-wire delay signature — the only
refine mode whose result reads the delay row).
:meth:`~repro_torch.core.alm.ArchParams.placement_key` is the *structural* key
plus grid aspect — wire-tier delays and channel width are deliberately
absent, so one placement serves every delay row of a structural class
(place once, re-time many; the reuse the warm-sweep gate measures) and
:func:`repro_torch.core.plan.clear_caches` drops placements along with every
other lowering cache.  Tuning knobs (backend, anneal steps / moves,
device) are deliberately *not* part of the key: like the
analytic ``backend``, they pick an algorithm for producing a placement
that satisfies the same contract, and the first call wins.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from . import plan as _planner
from .alm import ArchParams
from .circuit_ir import CircuitIR, apply_placement
from ..device import resolve_device

# instrumentation: how many placements were solved analytically vs served
# from the registry cache (tests assert reuse across structural classes)
PLACE_COUNTS = {"analytic": 0, "cache_hit": 0}

_PLACE_CACHE = _planner.register_cache("placement", cap=256)

_SMOOTH_ITERS = 32
#: starting scatters relaxed by the torch ensemble (the reference's
#: ``ensembles=4`` default)
ENSEMBLES = 4
_ALPHA = 0.5  # damping: weight of a LB's own position vs its neighbours


def grid_shape(n_lbs: int, aspect: float = 1.0) -> tuple[int, int]:
    """Smallest ``(grid_w, grid_h)`` grid of LB slots holding ``n_lbs``
    at the requested width/height aspect ratio (``aspect = W/H``).

    Degenerate inputs clamp explicitly rather than by rounding
    accident: ``w`` never exceeds ``n_lbs`` (an extreme aspect on a tiny
    circuit would otherwise mint empty columns wider than the design —
    e.g. 1 LB at aspect 16 rounds to a 4-wide grid), so a 1-LB circuit
    always lands on a 1x1 grid and ``w * h >= n_lbs`` always holds with
    every column except possibly the last one full."""
    if n_lbs <= 0:
        return (0, 0)
    if not aspect > 0:
        raise ValueError(f"grid aspect must be positive, got {aspect!r}")
    w = max(1, int(round(np.sqrt(n_lbs * aspect))))
    w = min(w, n_lbs)
    h = -(-n_lbs // w)  # ceil
    return (w, h)


@dataclass(frozen=True)
class GridPlacement:
    """One legal placement of a pack's LBs onto the fabric grid."""

    grid_w: int
    grid_h: int
    lb_x: np.ndarray  # [n_lbs] int32 column of each LB
    lb_y: np.ndarray  # [n_lbs] int32 row of each LB
    seed: int
    net_digest: str
    placement_key: tuple  # arch structural key + grid aspect
    refine: str | None = None  # annealer mode that refined this, if any

    @property
    def n_lbs(self) -> int:
        return int(self.lb_x.shape[0])

    def wirelength(self, ir: CircuitIR) -> int:
        """Total Manhattan wirelength of ``ir``'s inter-LB edges under
        this placement (the quantity the relaxation minimizes)."""
        src, dst = _routed_edges(ir)
        if not src.size:
            return 0
        d = (np.abs(self.lb_x[src] - self.lb_x[dst])
             + np.abs(self.lb_y[src] - self.lb_y[dst]))
        return int(d.sum())


def _routed_edges(ir: CircuitIR) -> tuple[np.ndarray, np.ndarray]:
    """``(src_lb, dst_lb)`` per fanin-CSR edge whose endpoints sit in two
    *different* LBs — the only edges that touch the routing fabric."""
    dst_sig = np.repeat(np.arange(ir.n_signals, dtype=np.int32),
                        np.diff(ir.fanin_ptr))
    src_lb = ir.sig_lb[ir.fanin_sig]
    dst_lb = ir.sig_lb[dst_sig]
    m = (src_lb >= 0) & (dst_lb >= 0) & (src_lb != dst_lb)
    return src_lb[m], dst_lb[m]


def lb_connectivity(ir: CircuitIR) -> np.ndarray:
    """Symmetric ``[n_lbs, n_lbs]`` float64 edge-count matrix between
    LBs, accumulated from the fanin CSR (intra-LB edges excluded)."""
    L = ir.n_lbs
    A = np.zeros((L, L), dtype=np.float64)
    src, dst = _routed_edges(ir)
    np.add.at(A, (src, dst), 1.0)
    return A + A.T


def _seed_rng(digest: str, placement_key: tuple, seed: int):
    """Deterministic per-(circuit, arch class, seed) generator.  Python's
    ``hash`` is process-salted, so derive the seed from a stable blake2b
    of the cache key instead."""
    h = hashlib.blake2b(repr((digest, placement_key, seed)).encode(),
                        digest_size=8)
    return np.random.default_rng(int.from_bytes(h.digest(), "big"))


def _smooth_numpy(A: np.ndarray, pos: np.ndarray,
                  iters: int = _SMOOTH_ITERS) -> np.ndarray:
    deg = A.sum(axis=1, keepdims=True)
    for _ in range(iters):
        pos = (A @ pos + _ALPHA * pos) / (deg + _ALPHA)
        lo = pos.min(axis=0, keepdims=True)
        span = pos.max(axis=0, keepdims=True) - lo
        pos = (pos - lo) / np.where(span > 0, span, 1.0)
    return pos


def _smooth_torch(A: np.ndarray, pos0: np.ndarray, device,
                  iters: int = _SMOOTH_ITERS) -> np.ndarray:
    """Ensemble-batched relaxation on ``device``: ``pos0`` is ``[E, L,
    2]``, every member smoothed at once in float64 (``A @ p`` broadcast
    over the ensemble axis).  Returns numpy ``[E, L, 2]``."""
    import torch

    At = torch.from_numpy(A).to(device)
    deg = At.sum(dim=1, keepdim=True)
    p = torch.from_numpy(np.ascontiguousarray(pos0, dtype=np.float64)) \
        .to(device)
    for _ in range(iters):
        p = (At @ p + _ALPHA * p) / (deg + _ALPHA)
        lo = p.amin(dim=1, keepdim=True)
        span = p.amax(dim=1, keepdim=True) - lo
        p = (p - lo) / torch.where(span > 0, span, 1.0)
    return p.cpu().numpy()


def _legalize(pos: np.ndarray, grid_w: int, grid_h: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """Snap relaxed coordinates to distinct grid slots: stable-sort by x
    into ``grid_w`` columns of ``grid_h``, then by y within a column."""
    L = pos.shape[0]
    if grid_w * grid_h < L:
        raise ValueError(
            f"grid {grid_w}x{grid_h} cannot hold {L} LBs")
    lb_x = np.empty(L, dtype=np.int32)
    lb_y = np.empty(L, dtype=np.int32)
    by_x = np.argsort(pos[:, 0], kind="stable")
    for c in range(grid_w):
        col = by_x[c * grid_h:(c + 1) * grid_h]
        order = col[np.argsort(pos[col, 1], kind="stable")]
        lb_x[order] = c
        lb_y[order] = np.arange(order.size, dtype=np.int32)
    return lb_x, lb_y


def place_ir(ir: CircuitIR, arch: ArchParams, seed: int = 0, *,
             backend: str = "numpy", refine: str | None = None,
             anneal_steps: int | None = None,
             anneal_moves: int | None = None,
             device=None) -> GridPlacement:
    """Solve one analytic placement of ``ir``'s LBs on ``arch``'s grid.

    ``backend="numpy"`` (canonical) relaxes a single deterministic
    scatter; ``backend="torch"`` relaxes an :data:`ENSEMBLES`-wide batch
    of scatters in one program on ``device`` (default: the card) and keeps
    the legalized candidate with the lowest total wirelength
    (first-index tie-break, so the choice is still deterministic for a
    fixed backend).  The reference's name for it, ``"jax"``, raises
    ``ValueError``.

    ``refine="anneal"`` (or ``"anneal_timing"``) hands the analytic
    result to :func:`repro_torch.core.anneal.refine_placement`; the
    backend choice carries over (torch refinement runs a
    :data:`repro_torch.core.anneal.CHAINS`-wide multi-chain ensemble).
    ``anneal_steps`` / ``anneal_moves`` bound the annealing schedule
    (None = size-scaled defaults).
    """
    if backend == "jax":
        raise ValueError(
            "the ensemble placement backend of the port is 'torch' (the "
            "reference's 'jax' ensemble runs on the device in torch here)")
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown placement backend {backend!r}")
    dev = resolve_device(device) if backend == "torch" else None
    if ir.arch_name is None:
        raise ValueError(f"{ir.name}: cannot place a functional IR")
    if ir.structural_key is not None \
            and ir.structural_key != arch.structural_key():
        raise ValueError(
            f"{ir.name}: IR was lowered for structural class "
            f"{ir.structural_key} but placement was requested for "
            f"{arch.structural_key()} — re-pack for this arch first")
    pkey = arch.placement_key()
    L = ir.n_lbs
    grid_w, grid_h = grid_shape(L, arch.grid_aspect)
    if L == 0:
        z = np.zeros(0, dtype=np.int32)
        return GridPlacement(grid_w, grid_h, z, z, seed,
                             ir.net_digest, pkey)

    PLACE_COUNTS["analytic"] += 1
    A = lb_connectivity(ir)
    rng = _seed_rng(ir.net_digest, pkey, seed)
    if backend == "torch":
        relaxed = _smooth_torch(A, rng.random((ENSEMBLES, L, 2)), dev)
        best = None
        for e in range(relaxed.shape[0]):
            lb_x, lb_y = _legalize(relaxed[e], grid_w, grid_h)
            cand = GridPlacement(grid_w, grid_h, lb_x, lb_y, seed,
                                 ir.net_digest, pkey)
            wl = cand.wirelength(ir)
            if best is None or wl < best[0]:
                best = (wl, cand)
        base = best[1]
    else:
        pos = _smooth_numpy(A, rng.random((L, 2)))
        lb_x, lb_y = _legalize(pos, grid_w, grid_h)
        base = GridPlacement(grid_w, grid_h, lb_x, lb_y, seed,
                             ir.net_digest, pkey)
    if refine is None:
        return base
    from .anneal import refine_placement
    return refine_placement(ir, arch, base, seed=seed, mode=refine,
                            backend=backend, steps=anneal_steps,
                            moves=anneal_moves, device=dev)


def placement_for(ir: CircuitIR, arch: ArchParams, seed: int = 0, *,
                  cache: bool = True, backend: str = "numpy",
                  refine: str | None = None,
                  **refine_kw) -> GridPlacement:
    """Registry-cached :func:`place_ir`.  The key deliberately omits
    wire-tier delays and channel width (they don't steer the placer), so
    all delay rows of a structural class x grid aspect share one
    placement — the reuse that makes placed arch-grid sweeps cheap.

    With ``refine`` set the key grows the refine mode; the timing-driven
    mode additionally keys on the arch's *non-wire* delay signature
    (criticality reads the delay row, but never the wire tiers — so the
    one-placement-per-wire-family reuse survives refinement)."""
    key = (ir.net_digest, arch.placement_key(), seed)
    if refine is not None:
        key = key + (refine,)
        if refine == "anneal_timing":
            from .anneal import delay_signature
            key = key + (delay_signature(arch),)
    if cache:
        hit = _PLACE_CACHE.get(key)
        if hit is not None:
            PLACE_COUNTS["cache_hit"] += 1
            return hit
    pl = place_ir(ir, arch, seed, backend=backend, refine=refine,
                  **refine_kw)
    if cache:
        _PLACE_CACHE.put(key, pl)
    return pl


def place_and_apply(ir: CircuitIR, arch: ArchParams, seed: int = 0, *,
                    cache: bool = True, backend: str = "numpy",
                    refine: str | None = None, **refine_kw) -> CircuitIR:
    """Place ``ir`` and return the placed IR (wire-tier columns filled)."""
    return apply_placement(
        ir, placement_for(ir, arch, seed, cache=cache, backend=backend,
                          refine=refine, **refine_kw))


# ---------------------------------------------------------------------------
# placement-derived channel congestion (Fig-8's routed replacement)
# ---------------------------------------------------------------------------


def _rect_demand(x0, x1, y0, y1, w, nx: int, ny: int) -> np.ndarray:
    """Weighted sum of axis-aligned rectangles ``[x0..x1] x [y0..y1]``
    (inclusive) over an ``[nx, ny]`` grid — 2-D difference array +
    double cumsum; ``w`` is each rectangle's per-cell contribution."""
    d = np.zeros((nx + 1, ny + 1), dtype=np.float64)
    np.add.at(d, (x0, y0), w)
    np.add.at(d, (x1 + 1, y0), -w)
    np.add.at(d, (x0, y1 + 1), -w)
    np.add.at(d, (x1 + 1, y1 + 1), w)
    return np.cumsum(np.cumsum(d, axis=0), axis=1)[:nx, :ny]


def channel_congestion(ir: CircuitIR, channel_width: int | None = None,
                       arch: ArchParams | None = None) -> dict:
    """Per-channel-segment routing demand of a *placed* IR.

    Each signal with consumers outside its producing LB claims its
    bounding box over the producing and consuming slots, RUDY-style
    (Spindler & Johannes): the net's horizontal track demand ``x1 - x0``
    is spread uniformly over its box's rows, loading every vertical
    channel *segment* ``(v, y)`` — the edge between tiles ``(v, y)`` and
    ``(v+1, y)`` — with ``1 / (y1 - y0 + 1)`` expected tracks for
    ``x0 <= v < x1``, ``y0 <= y <= y1`` (and symmetrically for the
    horizontal segments).  A one-track-per-segment count would bill a
    multi-fanout net for its whole box area; the RUDY weight bills it
    exactly its HPWL.  Demand is accumulated for all nets at once with
    2-D difference arrays.  ``utilization`` divides peak segment demand
    by the arch's per-edge ``channel_width`` (400-track default kept so
    recorded fig8 numbers stay reproducible).
    """
    if not ir.placed:
        raise ValueError(f"{ir.name}: channel congestion needs a placed IR")
    if channel_width is None:
        channel_width = arch.channel_width if arch is not None else 400
    W, H = ir.grid_w, ir.grid_h
    dst_sig = np.repeat(np.arange(ir.n_signals, dtype=np.int32),
                        np.diff(ir.fanin_ptr))
    src = ir.fanin_sig
    m = (ir.sig_lb[src] >= 0) & (ir.sig_lb[dst_sig] >= 0) \
        & (ir.sig_lb[src] != ir.sig_lb[dst_sig])
    src, dst_sig = src[m], dst_sig[m]

    x0 = ir.sig_x.astype(np.int64).copy()
    x1 = ir.sig_x.astype(np.int64).copy()
    y0 = ir.sig_y.astype(np.int64).copy()
    y1 = ir.sig_y.astype(np.int64).copy()
    np.minimum.at(x0, src, ir.sig_x[dst_sig])
    np.maximum.at(x1, src, ir.sig_x[dst_sig])
    np.minimum.at(y0, src, ir.sig_y[dst_sig])
    np.maximum.at(y1, src, ir.sig_y[dst_sig])
    nets = np.unique(src)

    # vertical segment (v, y) is loaded iff x0 <= v < x1 and y0 <= y <= y1
    # (a zero-width box crosses no vertical boundary), and symmetrically
    vm = nets[x1[nets] > x0[nets]] if nets.size else nets
    if vm.size and W > 1:
        vertical = _rect_demand(x0[vm], x1[vm] - 1, y0[vm], y1[vm],
                                1.0 / (y1[vm] - y0[vm] + 1), W - 1, H)
    else:
        vertical = np.zeros((max(W - 1, 0), H), dtype=np.float64)
    hm = nets[y1[nets] > y0[nets]] if nets.size else nets
    if hm.size and H > 1:
        horizontal = _rect_demand(x0[hm], x1[hm], y0[hm], y1[hm] - 1,
                                  1.0 / (x1[hm] - x0[hm] + 1), W, H - 1)
    else:
        horizontal = np.zeros((W, max(H - 1, 0)), dtype=np.float64)

    peak = max(float(vertical.max()) if vertical.size else 0.0,
               float(horizontal.max()) if horizontal.size else 0.0)
    return {
        "grid": (W, H),
        "nets": int(nets.size),
        "vertical": vertical,
        "horizontal": horizontal,
        "peak_demand": peak,
        "channel_width": int(channel_width),
        "utilization": peak / channel_width if channel_width else 0.0,
    }
