"""Compressor-tree reduction (Wallace / Dadda / Proposed-Wallace).

Rows are exploded into a bit-matrix (one list of signals per column).  Each
reduction stage inserts full-adder (3:2) and half-adder (2:2) compressors as
*boolean logic* (XOR3 / MAJ3 / XOR2 / AND2 LUT nodes) — exactly the paper's
strategy of emitting the compressor's boolean equations and letting logic
synthesis pack them into LUTs (§IV, *Compressor Tree Synthesis*).  The final
two rows are summed on a single ripple carry chain.

Structural hashing in the netlist gives compressor CSE for free: two FAs over
the same three signals are built once.
"""
from __future__ import annotations

from .netlist import (CONST0, Netlist, TT_AND2, TT_MAJ3, TT_XOR2, TT_XOR3)
from .synth import Row, add_rows


def _full_adder(net: Netlist, a: int, b: int, c: int) -> tuple[int, int]:
    s = net.add_lut((a, b, c), TT_XOR3)
    cy = net.add_lut((a, b, c), TT_MAJ3)
    return s, cy


def _half_adder(net: Netlist, a: int, b: int) -> tuple[int, int]:
    s = net.add_lut((a, b), TT_XOR2)
    cy = net.add_lut((a, b), TT_AND2)
    return s, cy


def _dadda_targets(max_height: int) -> list[int]:
    ds = [2]
    while ds[-1] < max_height:
        ds.append(int(ds[-1] * 3 / 2))
    return ds


def rows_to_columns(rows: list[Row], width_cap: int | None):
    if not rows:
        return [], 0
    lo = min(r.start for r in rows)
    hi = max(r.end for r in rows)
    if width_cap is not None:
        hi = min(hi, width_cap)
    ncols = hi - lo
    cols: list[list[int]] = [[] for _ in range(ncols)]
    for r in rows:
        for j, s in enumerate(r.bits):
            p = r.shift + j
            if s != CONST0 and lo <= p < hi:
                cols[p - lo].append(s)
    return cols, lo


def columns_to_rows(cols: list[list[int]], lo: int) -> list[Row]:
    """Split height-<=2 columns back into (up to) two rows."""
    height = max((len(c) for c in cols), default=0)
    assert height <= 2, f"columns not fully compressed (h={height})"
    rows = []
    for lane in range(2):
        bits = [c[lane] if len(c) > lane else CONST0 for c in cols]
        r = Row(lo, tuple(bits)).trimmed()
        if not r.is_zero():
            rows.append(r)
    return rows


def compress_columns(net: Netlist, cols: list[list[int]], algo: str):
    """Run reduction stages until every column has height <= 2."""
    n_stages = 0
    while max((len(c) for c in cols), default=0) > 2:
        n_stages += 1
        if algo == "dadda":
            targets = _dadda_targets(max(len(c) for c in cols))
            # largest target strictly below current max height
            cur = max(len(c) for c in cols)
            tgt = max(t for t in targets if t < cur)
            cols = _dadda_stage(net, cols, tgt)
        elif algo == "wallace":
            cols = _wallace_stage(net, cols, use_ha=True)
        elif algo == "pw":
            cols = _wallace_stage(net, cols, use_ha=False)
        else:
            raise ValueError(algo)
        if n_stages > 64:
            raise RuntimeError("compressor tree failed to converge")
    return cols


def _wallace_stage(net: Netlist, cols, use_ha: bool):
    ncols = len(cols)
    out: list[list[int]] = [[] for _ in range(ncols + 1)]
    for p, col in enumerate(cols):
        i = 0
        h = len(col)
        while h - i >= 3:
            s, cy = _full_adder(net, col[i], col[i + 1], col[i + 2])
            out[p].append(s)
            out[p + 1].append(cy)
            i += 3
        if use_ha and h - i == 2:
            s, cy = _half_adder(net, col[i], col[i + 1])
            out[p].append(s)
            out[p + 1].append(cy)
            i += 2
        while i < h:
            out[p].append(col[i])
            i += 1
    while out and not out[-1]:
        out.pop()
    return out


def _dadda_stage(net: Netlist, cols, target: int):
    """Reduce so that no column exceeds ``target`` after carries."""
    ncols = len(cols)
    out: list[list[int]] = [[] for _ in range(ncols + 1)]
    for p in range(ncols):
        col = list(cols[p]) + out[p]
        out[p] = []
        i = 0
        # minimum compressors so len - 2*fa - ha + carries_in_future <= target;
        # classic Dadda: compress only while the column is too tall.
        while len(col) - i > target:
            excess = len(col) - i - target
            if excess >= 2:
                s, cy = _full_adder(net, col[i], col[i + 1], col[i + 2])
                out[p].append(s)
                out[p + 1].append(cy)
                i += 3
            else:
                s, cy = _half_adder(net, col[i], col[i + 1])
                out[p].append(s)
                out[p + 1].append(cy)
                i += 2
        out[p].extend(col[i:])
    while out and not out[-1]:
        out.pop()
    return out


def reduce_compressor(net: Netlist, rows: list[Row], algo: str,
                      width_cap: int | None = None) -> Row:
    cols, lo = rows_to_columns(rows, width_cap)
    if not cols:
        return Row(0, ())
    cols = compress_columns(net, cols, algo)
    final = columns_to_rows(cols, lo)
    if not final:
        return Row(0, ())
    if len(final) == 1:
        return final[0]
    return add_rows(net, final[0], final[1], width_cap=width_cap, share=True)
