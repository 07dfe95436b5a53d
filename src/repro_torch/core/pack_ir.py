"""Columnar pack IR — compatibility facade over the unified CircuitIR.

Historically this module owned the packed lowering (per-signal columns,
fanin CSR with 27 edge delay classes, per-ALM mode columns, levelized
node tables).  The unified IR merged that substrate with the evaluator's level
tensors into :mod:`repro_torch.core.circuit_ir`: one **functional lowering**
per netlist content digest (levelization + truth-table words + CSR
topology, shared by eval, timing and equivalence) plus one vectorized
**placement patch** per (digest, structural class).  ``PackIR`` is now
an alias of :class:`~repro_torch.core.circuit_ir.CircuitIR`; the names below
re-export so existing imports (timing, sweeps, tests) keep working.

See ``repro_torch/core/circuit_ir.py`` for the column layout, the edge/node
delay-class encoding and the cache-registry invalidation rules.
"""
from __future__ import annotations

from .circuit_ir import (  # noqa: F401 — re-exported public surface
    CircuitIR, ChainLevelRows, LutLevelRows,
    K_CONST, K_PI, K_LUT, K_LUT_ABS, K_SUM, K_COUT,
    ROUTE_NULL, ROUTE_LOCAL, ROUTE_GLOBAL,
    PIN_NULL, PIN_AH, PIN_Z,
    PATH_NULL, PATH_AH, PATH_Z,
    N_EDGE_CLASSES,
    NDC_ABSORBED, NDC_LUT4, NDC_LUT5, NDC_LUT6, N_NODE_CLASSES,
    edge_class, lower_pack_ir, lower_pack_ir_incremental,
)

#: the packed lowering's result type — one dataclass serves eval, timing
#: and equivalence now; kept under the old name for its many importers
PackIR = CircuitIR
