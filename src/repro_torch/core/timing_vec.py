"""Vectorized static timing over the unified columnar CircuitIR.

The Python oracle (:func:`repro_torch.core.timing.analyze_oracle`) walks dicts
signal-by-signal; this module executes the same levelized longest-path
recurrence as array programs over :class:`~repro_torch.core.circuit_ir.CircuitIR`
(the same lowering the fused evaluator and the equivalence lanes read):

* **numpy backend** — one gather/max per level, ragged (unpadded) level
  tables, zero compile cost.  This is what ``timing.analyze`` uses for
  one-off pack-and-analyze calls (every figure driver).
* **batched suite program** — the reference's jit/vmap program that
  re-times a whole suite across an arch grid is not part of this port
  yet; only the numpy backend is here.

Value identity
--------------
The numpy backend is **bit-identical** to the oracle (not merely close): all
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

import numpy as np

from .alm import ArchParams, DELAY_FIELDS
from .circuit_ir import (N_EDGE_CLASSES, N_NODE_CLASSES, NDC_ABSORBED,
                         NDC_LUT4, NDC_LUT5, NDC_LUT6, CircuitIR)

_IDX = {f: i for i, f in enumerate(DELAY_FIELDS)}

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


def analyze_ir(ir: CircuitIR, arch: ArchParams, backend: str = "numpy") -> dict:
    """Vectorized :func:`repro_torch.core.timing.analyze` over a lowered pack."""
    if backend == "numpy":
        comps = delay_components(arch.delay_table())
        cp = critical_path_numpy(ir, comps)
    else:
        raise ValueError(f"unknown timing backend {backend!r}")
    return metrics_from_cp(ir, arch, cp)
