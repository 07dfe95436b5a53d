"""Vectorized static timing over the unified columnar CircuitIR.

The Python oracle (:func:`repro_torch.core.timing.analyze_oracle`) walks dicts
signal-by-signal; this module executes the same levelized longest-path
recurrence as array programs over :class:`~repro_torch.core.circuit_ir.CircuitIR`
(the same lowering the fused evaluator and the equivalence lanes read):

* **numpy backend** — one gather/max per level, ragged (unpadded) level
  tables, zero compile cost.  This is what ``timing.analyze`` uses for
  one-off pack-and-analyze calls (every figure driver).
* **torch backend** — levels are bucketed into contiguous width segments
  (the evaluator's padded-volume DP), and the whole suite is batched on
  the device: circuits stacked on one axis (sink-padded tensors), delay
  rows (architectures) on another.  One :class:`SuiteTimingProgram`
  re-times a whole benchmark suite across an N-point arch grid — the
  engine behind :mod:`repro_torch.core.sweep`.

The reference's batched program is one jit: ``lax.scan`` over each
bucket's levels, the carry ripple a nested ``lax.scan`` over bits, and a
nested ``vmap`` over members and delay rows.  Here both axes are
explicit: the arrival buffer is ``[G * (n_sig + 1), K]`` float64
(member ``g``'s signals in row block ``g``, every member's signal
columns offset by its block at build time, as the evaluator lays out its
value buffer), the levels are a Python loop per bucket, and the ripple a
loop over the bucket's bit positions on ``[G * C1, K]`` rows.  Each
level gathers with ``index_select`` and scatters with ``index_copy_`` in
eager torch ops, never ``torch.compile``d, so the arithmetic is the
reference's, operation for operation.  Eager torch compiles nothing per
shape, so the reference's jit cache and its compile/reuse counts have no
counterpart; :func:`read_compile_counts` keeps the programs-built count.
For the same reason the reference's ``pad_shapes`` option (quantizing
every padded dimension to a power of two so that nearby batches share a
jit-cache entry) is not carried over: here it would only enlarge the
tensors.

Value identity
--------------
Both backends are **bit-identical** to the oracle (not merely close): all
arithmetic is float64, additions compose in exactly the oracle's
association order — ``(((arrival + route) + wire) + pin) + path`` per
edge, ``((t_in + lut_delay) + t_alm_out) + t_out_mux_extra`` per node —
and ``max`` is exact in any order.  Padding exploits the model invariant
that delays are non-negative: padded slots gather signal 0 (CONST0,
arrival 0.0) through the all-zero null edge class and wire tier 0,
reproducing the oracle's ``default=0.0`` reductions exactly.

The *wire* term is the placement-derived inter-LB hop delay: each edge
carries a wire tier (0..3, see ``TIER_*`` in :mod:`repro_torch.core.circuit_ir`)
gathered from a per-arch 4-entry component table.  Unplaced IRs carry
tier 0 everywhere and tier 0's delay is identically 0.0, so — because
``x + 0.0 == x`` exactly for every finite ``x >= 0`` — the placed path
at zero wire-tier delay reproduces the placement-free timing bit for
bit (the Fig-5/Table-III pins stay regression gates).

Delay tables are data, not structure: an edge stores a *class* (0..26,
see :mod:`repro_torch.core.circuit_ir`), the per-arch component table is built
here by :func:`delay_components` from ``ArchParams.delay_table()`` rows.
Batching across architectures is therefore just a leading axis on the
component tables — no retrace, no repack.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .alm import ArchParams, DELAY_FIELDS
from .circuit_ir import (N_EDGE_CLASSES, N_NODE_CLASSES, NDC_ABSORBED,
                         NDC_LUT4, NDC_LUT5, NDC_LUT6, CircuitIR)
from .plan import bucket_envelopes, combined_profile, segment_levels

_IDX = {f: i for i, f in enumerate(DELAY_FIELDS)}

#: how many batched programs were built — the serving benchmark records
#: the delta around a batch stream
_COMPILE_COUNTS = {"programs": 0}


def read_compile_counts() -> dict:
    """Snapshot of the program-build counter."""
    return dict(_COMPILE_COUNTS)


def delay_components(tables: np.ndarray) -> dict[str, np.ndarray]:
    """Expand delay-table rows ``[..., len(DELAY_FIELDS)]`` into the three
    component tables the executors gather from (leading axes preserved):

    * ``edge [..., 27, 3]`` — (route, pin, path) components per edge class;
    * ``wire [..., 4]``     — inter-LB delay per wire tier (null/tile-local,
      1-hop, 2-hop, long); tier 0 is identically 0.0 so unplaced edges
      (and padding) add nothing;
    * ``lut  [..., 4, 3]``  — (lut_delay, t_alm_out, t_out_mux_extra) per
      node delay class (all-zero for absorbed LUTs);
    * ``chain [..., 3]``    — (t_sum_out, t_out_mux_extra, t_carry).
    """
    t = np.asarray(tables, dtype=np.float64)
    lead = t.shape[:-1]
    z = np.zeros(lead, dtype=np.float64)

    def g(name):
        return t[..., _IDX[name]]

    route = np.stack([z, g("t_route_local"), g("t_route_global")], axis=-1)
    pin = np.stack([z, g("t_lbin_to_ah"), g("t_lbin_to_z")], axis=-1)
    path = np.stack([z, g("t_ah_to_adder"), g("t_z_to_adder")], axis=-1)
    edge = np.zeros(lead + (N_EDGE_CLASSES, 3), dtype=np.float64)
    for c in range(N_EDGE_CLASSES):
        edge[..., c, 0] = route[..., c // 9]
        edge[..., c, 1] = pin[..., (c // 3) % 3]
        edge[..., c, 2] = path[..., c % 3]

    lut = np.zeros(lead + (N_NODE_CLASSES, 3), dtype=np.float64)
    for ndc, d in ((NDC_LUT4, g("t_lut4")), (NDC_LUT5, g("t_lut5")),
                   (NDC_LUT6, g("t_lut6"))):
        lut[..., ndc, 0] = d
        lut[..., ndc, 1] = g("t_alm_out")
        lut[..., ndc, 2] = g("t_out_mux_extra")
    assert NDC_ABSORBED == 0  # row 0 stays all-zero: absorption adds nothing

    chain = np.stack([g("t_sum_out"), g("t_out_mux_extra"), g("t_carry")],
                     axis=-1)
    wire = np.stack([z, g("t_wire_hop1"), g("t_wire_hop2"),
                     g("t_wire_long")], axis=-1)
    return {"edge": edge, "wire": wire, "lut": lut, "chain": chain}


# ---------------------------------------------------------------------------
# numpy backend (per-circuit, compile-free)
# ---------------------------------------------------------------------------


def arrival_times_numpy(ir: CircuitIR, comps: dict[str, np.ndarray]
                        ) -> np.ndarray:
    """Arrival time per signal, float64, oracle-identical."""
    edge, wire, lutc = comps["edge"], comps["wire"], comps["lut"]
    t_sum, t_extra, t_carry = (float(comps["chain"][0]),
                               float(comps["chain"][1]),
                               float(comps["chain"][2]))
    arr = np.zeros(ir.n_signals, dtype=np.float64)
    for ll, cl in zip(ir.lut_levels, ir.chain_levels):
        if ll.out.shape[0]:
            ec = edge[ll.cls]                          # [M, 6, 3]
            t = (((arr[ll.ins] + ec[..., 0]) + wire[ll.hop])
                 + ec[..., 1]) + ec[..., 2]
            tin = t.max(axis=1)
            nc = lutc[ll.ndc]                          # [M, 3]
            arr[ll.out] = ((tin + nc[:, 0]) + nc[:, 1]) + nc[:, 2]
        C = cl.cout.shape[0]
        if C:
            ea, eb = edge[cl.a_cls], edge[cl.b_cls]
            a_t = (((arr[cl.a_sig] + ea[..., 0]) + wire[cl.a_hop])
                   + ea[..., 1]) + ea[..., 2]
            b_t = (((arr[cl.b_sig] + eb[..., 0]) + wire[cl.b_hop])
                   + eb[..., 1]) + eb[..., 2]
            ecin = edge[cl.cin_cls]
            c = (((arr[cl.cin_sig] + ecin[:, 0]) + wire[cl.cin_hop])
                 + ecin[:, 1]) + ecin[:, 2]
            B = cl.a_sig.shape[1]
            carries = np.zeros((C, B), dtype=np.float64)
            for bi in range(B):
                th = np.maximum(np.maximum(a_t[:, bi], b_t[:, bi]), c)
                valid = cl.sums[:, bi] >= 0
                if valid.any():
                    arr[cl.sums[valid, bi]] = (th[valid] + t_sum) + t_extra
                c = th + t_carry
                carries[:, bi] = c
            has = cl.cout >= 0
            if has.any():
                cy = carries[np.flatnonzero(has), cl.last[has]]
                arr[cl.cout[has]] = (cy + t_sum) + t_extra
    return arr


def critical_path_numpy(ir: CircuitIR, comps: dict[str, np.ndarray]) -> float:
    arr = arrival_times_numpy(ir, comps)
    cp = float(arr[ir.po_sig].max()) if ir.po_sig.size else 0.0
    return max(cp, 1.0)


def metrics_from_cp(ir: CircuitIR, arch: ArchParams, cp: float) -> dict:
    """The :func:`repro_torch.core.timing.analyze` record for one (IR, arch, cp).

    ``n_alms``/``n_lbs``/``concurrent_luts`` come from the IR (structure);
    area comes from the arch row — within a structural class only the
    area constant and the delays differ, which is why one IR serves every
    grid row of its class."""
    area = ir.n_alms * arch.alm_area_mwta
    return {
        "arch": arch.name,
        "critical_path_ps": cp,
        "fmax_mhz": 1e6 / cp,
        "alms": ir.n_alms,
        "lbs": ir.n_lbs,
        "area_mwta": area,
        "adp": area * cp,
        "adders": ir.n_adders,
        "luts": ir.n_luts,
        "concurrent_luts": ir.concurrent_luts,
    }


def analyze_ir(ir: CircuitIR, arch: ArchParams, backend: str = "numpy",
               device=None) -> dict:
    """Vectorized :func:`repro_torch.core.timing.analyze` over a lowered
    pack; ``backend="torch"`` runs the batched program on ``device``."""
    if backend == "numpy":
        comps = delay_components(arch.delay_table())
        cp = critical_path_numpy(ir, comps)
    elif backend == "torch":
        prog = build_suite_timing_program([ir], device=device)
        cp = float(prog.run(arch.delay_table()[None, :])[0, 0])
    else:
        raise ValueError(f"unknown timing backend {backend!r}")
    return metrics_from_cp(ir, arch, cp)


# ---------------------------------------------------------------------------
# torch backend (suite x arch-grid batched program)
# ---------------------------------------------------------------------------


def _alloc_bucket(l: int, M1: int, C1: int, B1: int, sink: int):
    """One bucket's all-pad (null) 17-tuple: every gather reads signal 0
    (CONST0, arrival 0.0) through edge class 0 / wire tier 0, every
    scatter lands on ``sink`` — a no-op level row."""
    return (np.zeros((l, M1, 6), dtype=np.int32),       # l_ins
            np.zeros((l, M1, 6), dtype=np.int32),       # l_cls
            np.zeros((l, M1), dtype=np.int32),          # l_ndc
            np.full((l, M1), sink, dtype=np.int32),     # l_out
            np.zeros((l, C1, B1), dtype=np.int32),      # a_sig
            np.zeros((l, C1, B1), dtype=np.int32),      # a_cls
            np.zeros((l, C1, B1), dtype=np.int32),      # b_sig
            np.zeros((l, C1, B1), dtype=np.int32),      # b_cls
            np.zeros((l, C1), dtype=np.int32),          # cin_sig
            np.zeros((l, C1), dtype=np.int32),          # cin_cls
            np.full((l, C1, B1), sink, dtype=np.int32),  # sums
            np.full((l, C1), sink, dtype=np.int32),     # cout
            np.zeros((l, C1), dtype=np.int32),          # last
            np.zeros((l, M1, 6), dtype=np.int32),       # l_hop
            np.zeros((l, C1, B1), dtype=np.int32),      # a_hop
            np.zeros((l, C1, B1), dtype=np.int32),      # b_hop
            np.zeros((l, C1), dtype=np.int32))          # cin_hop


def _pad_levels(ir: CircuitIR, bounds, shapes, sink: int):
    """Pad one member's ragged level tables to the bucketed group envelope
    (``shapes[bi] = (l, M1, C1, B1)``);
    returns per-bucket 17-tuples of [l, ...] arrays (the scan xs).  The
    wire-tier (hop) arrays ride at indices 13..16 so the flag probes on
    indices 3/10/11 stay valid; padded slots keep tier 0 (zero delay)."""
    out = []
    for (i, j), (l, M1, C1, B1) in zip(bounds, shapes):
        (l_ins, l_cls, l_ndc, l_out, a_sig, a_cls, b_sig, b_cls,
         cin_sig, cin_cls, sums, cout, last,
         l_hop, a_hop, b_hop, cin_hop) = _alloc_bucket(l, M1, C1, B1, sink)
        for t in range(i, min(j, ir.n_levels)):
            r = t - i
            ll, cl = ir.lut_levels[t], ir.chain_levels[t]
            m = ll.out.shape[0]
            if m:
                l_ins[r, :m] = ll.ins
                l_cls[r, :m] = ll.cls
                l_hop[r, :m] = ll.hop
                l_ndc[r, :m] = ll.ndc
                l_out[r, :m] = ll.out
            c = cl.cout.shape[0]
            if c:
                bb = cl.a_sig.shape[1]
                a_sig[r, :c, :bb] = cl.a_sig
                a_cls[r, :c, :bb] = cl.a_cls
                a_hop[r, :c, :bb] = cl.a_hop
                b_sig[r, :c, :bb] = cl.b_sig
                b_cls[r, :c, :bb] = cl.b_cls
                b_hop[r, :c, :bb] = cl.b_hop
                cin_sig[r, :c] = cl.cin_sig
                cin_cls[r, :c] = cl.cin_cls
                cin_hop[r, :c] = cl.cin_hop
                s = cl.sums.copy()
                s[s < 0] = sink
                sums[r, :c, :bb] = s
                co = cl.cout.copy()
                co[co < 0] = sink
                cout[r, :c] = co
                last[r, :c] = cl.last
        out.append((l_ins, l_cls, l_ndc, l_out, a_sig, a_cls, b_sig, b_cls,
                    cin_sig, cin_cls, sums, cout, last,
                    l_hop, a_hop, b_hop, cin_hop))
    return out


@dataclass(frozen=True)
class _Bucket:
    """One bucket's level tables on the device, laid out for the walk:
    level-major (row ``r`` is level ``r`` of the bucket), each level's
    members flattened into one row axis, signal ids offset by their
    member's row block ``g * (n_sig + 1)``, chain columns bit-major — so
    every gather of a level is one ``index_select`` over the whole
    group, and bit ``j`` of every chain is one contiguous slice."""

    lut_in: torch.Tensor   # [l, G*M1*6] pin signals
    lut_cls: torch.Tensor  # [l, G*M1*6] edge class per pin
    lut_hop: torch.Tensor  # [l, G*M1*6] wire tier per pin
    lut_ndc: torch.Tensor  # [l, G*M1] node delay class
    lut_out: torch.Tensor  # [l, G*M1] output signals (pads: member sink)
    ch_in: torch.Tensor    # [l, 2*B1*G*C1 + G*C1]: a bits, b bits, cin
    ch_cls: torch.Tensor   # edge classes, ch_in's layout
    ch_hop: torch.Tensor   # wire tiers, ch_in's layout
    sums: torch.Tensor     # [l, B1*G*C1] sum signals (pads: member sink)
    cout: torch.Tensor     # [l, G*C1] carry-out signals (pads: sink)
    last: torch.Tensor     # [l, G*C1] row of each chain's last bit in
    #                        the bit-major [B1*G*C1] carry rows


_WALK_FIELDS = tuple(f.name for f in fields(_Bucket))


def _walk_arrays(stacked, n_rows: int) -> dict[str, np.ndarray]:
    """The walk layout (:class:`_Bucket`) of one bucket's stacked 17-tuple
    (``[G, l, ...]`` arrays with member-local signal ids), as int64 numpy
    arrays; ``n_rows = n_sig + 1`` is one member's row block."""
    (l_ins, l_cls, l_ndc, l_out, a_sig, a_cls, b_sig, b_cls,
     cin_sig, cin_cls, sums, cout, last,
     l_hop, a_hop, b_hop, cin_hop) = stacked
    G, l, C1, _ = a_sig.shape
    block = np.arange(G, dtype=np.int64) * n_rows

    def sig(x):    # member-local -> buffer rows
        return x.astype(np.int64) + block.reshape((G,) + (1,) * (x.ndim - 1))

    def rows(x):   # [G, l, ...] -> [l, G * ...]
        return np.swapaxes(x, 0, 1).astype(np.int64).reshape(l, -1)

    def bits(x):   # [G, l, C1, B1] -> [l, B1 * G * C1], bit-major
        return x.transpose(1, 3, 0, 2).astype(np.int64).reshape(l, -1)

    chain = np.arange(G * C1, dtype=np.int64).reshape(G, 1, C1)
    return {
        "lut_in": rows(sig(l_ins)), "lut_cls": rows(l_cls),
        "lut_hop": rows(l_hop), "lut_ndc": rows(l_ndc),
        "lut_out": rows(sig(l_out)),
        "ch_in": np.concatenate([bits(sig(a_sig)), bits(sig(b_sig)),
                                 rows(sig(cin_sig))], axis=1),
        "ch_cls": np.concatenate([bits(a_cls), bits(b_cls), rows(cin_cls)],
                                 axis=1),
        "ch_hop": np.concatenate([bits(a_hop), bits(b_hop), rows(cin_hop)],
                                 axis=1),
        "sums": bits(sig(sums)), "cout": rows(sig(cout)),
        "last": rows(last.astype(np.int64) * (G * C1) + chain),
    }


def _to_device(arrays: list[np.ndarray], device: torch.device
               ) -> list[torch.Tensor]:
    """Many arrays of one dtype in one host-to-device transfer; returns
    views of the device buffer in the arrays' shapes."""
    buf = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
    buf = buf.to(device)
    out, o = [], 0
    for a in arrays:
        out.append(buf[o:o + a.size].view(a.shape))
        o += a.size
    return out


@dataclass
class SuiteTimingProgram:
    """One batched timing program: G stacked circuits x K delay rows.

    ``run(delay_tables[K, len(DELAY_FIELDS)])`` returns critical paths
    ``[G, K]`` (float64 numpy), bit-identical to the oracle per (circuit,
    arch).  The level tables stay on ``device``; a run uploads only the
    four small delay-component tables, so re-running with new delay rows
    of any K is pure data motion.
    """

    n_sig: int
    n_members: int
    flags: tuple[tuple[bool, bool], ...]
    bucket_shapes: tuple[tuple[int, int, int, int], ...]
    device: torch.device
    _tensors: tuple = field(repr=False)   # one _Bucket per bucket
    _po: torch.Tensor = field(repr=False)  # [G, P] buffer rows

    def run(self, delay_tables: np.ndarray) -> np.ndarray:
        """Critical paths ``[G, K]`` for delay rows ``[K, |DELAY_FIELDS|]``."""
        comps = delay_components(np.asarray(delay_tables, dtype=np.float64))
        K = comps["wire"].shape[0]
        # component tables class-major, so a gather row is one arch row
        edge, wire, lutc, chainc = _to_device(
            [np.ascontiguousarray(np.moveaxis(comps[k], 0, -1))
             for k in ("edge", "wire", "lut", "chain")], self.device)
        t_sum, t_extra, t_carry = chainc[0], chainc[1], chainc[2]
        G, P = self._po.shape
        arr = torch.zeros(G * (self.n_sig + 1), K, dtype=torch.float64,
                          device=self.device)

        def arrival(sig, cls, hop):
            # (((arrival + route) + wire) + pin) + path, the oracle's order
            ec = edge.index_select(0, cls)
            return (((arr.index_select(0, sig) + ec[:, 0])
                     + wire.index_select(0, hop)) + ec[:, 1]) + ec[:, 2]

        for (hl, hc), (l, _, _, B1), bk in zip(self.flags, self.bucket_shapes,
                                               self._tensors):
            n = bk.sums.shape[1]          # B1 * G * C1 chain bits
            gc = bk.cout.shape[1]         # G * C1 chains
            for r in range(l):
                if hl:
                    t = arrival(bk.lut_in[r], bk.lut_cls[r], bk.lut_hop[r])
                    tin = t.view(-1, 6, K).amax(dim=1)
                    nc = lutc.index_select(0, bk.lut_ndc[r])
                    arr.index_copy_(0, bk.lut_out[r],
                                    ((tin + nc[:, 0]) + nc[:, 1]) + nc[:, 2])
                if hc:
                    t = arrival(bk.ch_in[r], bk.ch_cls[r], bk.ch_hop[r])
                    ab = torch.maximum(t[:n], t[n:2 * n]).view(B1, gc, K)
                    c = t[2 * n:]
                    ths = torch.empty_like(ab)
                    cys = torch.empty_like(ab)
                    # th = max(max(a, b), c), then c = th + t_carry: one
                    # add per bit, as the oracle ripples
                    for j in range(B1):
                        c = torch.add(torch.maximum(ab[j], c, out=ths[j]),
                                      t_carry, out=cys[j])
                    arr.index_copy_(0, bk.sums[r],
                                    ((ths + t_sum) + t_extra).view(n, K))
                    cy_last = cys.view(n, K).index_select(0, bk.last[r])
                    arr.index_copy_(0, bk.cout[r],
                                    (cy_last + t_sum) + t_extra)
        cps = arr.index_select(0, self._po.view(-1)).view(G, P, K)
        return cps.amax(dim=1).clamp_min(1.0).cpu().numpy()


def build_suite_timing_program(irs: Sequence[CircuitIR],
                               max_buckets: int = 3,
                               device=None) -> SuiteTimingProgram:
    """Stack many circuits' CircuitIRs into one width-bucketed timing
    program on ``device`` (default: the card).

    Levels are aligned to the longest member, the combined width profile
    is segmented by the evaluator's padded-volume DP, and every member is
    padded to the bucket envelopes with null rows (sink-scattering,
    zero-gathering).  One program serves the whole suite.  Padding is
    value-neutral by the model invariant documented in the module
    docstring: pad slots gather CONST0 through the all-zero null edge
    class and scatter only to their member's sink."""
    dev = resolve_device(device)
    if not irs:
        raise ValueError("empty IR list")
    L = max(ir.n_levels for ir in irs)
    m, c, b = combined_profile([ir.level_profile() for ir in irs], L)
    L = max(L, 1)
    bounds = segment_levels(m, c, b, max_buckets)
    envelopes = bucket_envelopes(m, c, b, bounds)
    n_sig = max(ir.n_signals for ir in irs)
    G = len(irs)
    P = max(max((ir.po_sig.size for ir in irs), default=1), 1)
    shapes = [(max(j - i, 1), max(M, 1), max(C, 1), max(B, 1))
              for (i, j), (M, C, B) in zip(bounds, envelopes)]
    sink = n_sig
    members = [_pad_levels(ir, bounds, shapes, sink) for ir in irs]
    po = np.zeros((G, P), dtype=np.int64)          # pad -> CONST0 (arr 0.0)
    for g, ir in enumerate(irs):
        po[g, :ir.po_sig.size] = ir.po_sig
    po += np.arange(G, dtype=np.int64)[:, None] * (n_sig + 1)
    flags = tuple(
        (any(mb[bi][3].min() < sink for mb in members),     # any real lut out
         any(mb[bi][11].min() < sink or (mb[bi][10] < sink).any()
             for mb in members))                            # any real chain
        for bi in range(len(bounds)))
    walks = [_walk_arrays(tuple(np.stack([mb[bi][ai] for mb in members])
                                for ai in range(17)), n_sig + 1)
             for bi in range(len(bounds))]
    on_dev = _to_device([w[k] for w in walks for k in _WALK_FIELDS] + [po],
                        dev)
    nf = len(_WALK_FIELDS)
    buckets = tuple(_Bucket(*on_dev[bi * nf:(bi + 1) * nf])
                    for bi in range(len(bounds)))
    _COMPILE_COUNTS["programs"] += 1
    return SuiteTimingProgram(
        n_sig=n_sig, n_members=G, flags=flags, bucket_shapes=tuple(shapes),
        device=dev, _tensors=buckets, _po=on_dev[-1])
