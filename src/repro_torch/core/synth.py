"""Multiplier / reduction synthesis (the paper's §IV CAD enhancements).

Everything is built around *rows*: a row is a bit-vector of signals with a
left shift, representing ``value = sum(bits[j] << (shift + j))``.  Unrolled
(constant-coefficient) multiplication produces one row per set "selector bit"
of the constant; variable multiplication produces one AND-gated row per
multiplier bit.  Reduction of the rows to a single bus is delegated to:

* ``cascade``      — sequential accumulation on carry chains (Fig. 1 left),
* ``binary``       — improved binary adder tree with the strength-heuristic DP
                     (Algorithm 1) and duplicate-chain sharing,
* ``wallace`` / ``dadda`` / ``pw`` — compressor trees (Fig. 1), LUT compressors
                     + one final carry chain,
* ``vtr_baseline`` — unoptimized adjacent-pair binary tree, no zero-row skip,
                     no chain sharing (models stock VTR/Parmys behaviour).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .netlist import CONST0, Netlist, TT_AND2

ALGOS = ("vtr_baseline", "cascade", "binary", "wallace", "dadda", "pw")


@dataclass(frozen=True)
class Row:
    shift: int
    bits: tuple[int, ...]

    @property
    def start(self) -> int:
        return self.shift

    @property
    def end(self) -> int:  # one past the last bit position
        return self.shift + len(self.bits)

    def bit_at(self, pos: int) -> int:
        j = pos - self.shift
        if 0 <= j < len(self.bits):
            return self.bits[j]
        return CONST0

    def is_zero(self) -> bool:
        return all(b == CONST0 for b in self.bits)

    def trimmed(self) -> "Row":
        bits = list(self.bits)
        shift = self.shift
        while bits and bits[-1] == CONST0:
            bits.pop()
        while bits and bits[0] == CONST0:
            bits.pop(0)
            shift += 1
        if not bits:
            return Row(0, ())
        return Row(shift, tuple(bits))


# ---------------------------------------------------------------------------
# row addition on a carry chain
# ---------------------------------------------------------------------------


def chain_key_for(ra: Row, rb: Row, width_cap: int | None = None):
    """The structural key of the carry chain that would add ``ra + rb``.

    Key is *relative*: positions are taken from the chain start, so two
    row-pairs that are shifted copies of each other produce identical keys —
    this is what lets shifted duplicate chains be shared.
    """
    p0 = max(ra.start, rb.start)
    p1 = max(ra.end, rb.end)
    if width_cap is not None:
        p1 = min(p1, width_cap)
    a = tuple(ra.bit_at(p) for p in range(p0, p1))
    b = tuple(rb.bit_at(p) for p in range(p0, p1))
    return a, b


def add_rows(net: Netlist, ra: Row, rb: Row, width_cap: int | None = None,
             share: bool = True) -> Row:
    """Emit a carry chain computing ``ra + rb`` and return the result row.

    Bits below the overlap pass through untouched (no adders burned on
    them).  With ``share=True`` identical chains are reused via the netlist's
    structural chain cache.
    """
    ra, rb = ra.trimmed(), rb.trimmed()
    if ra.is_zero() and rb.is_zero():
        return Row(0, ())
    if ra.is_zero():
        return rb
    if rb.is_zero():
        return ra
    if ra.start > rb.start:
        ra, rb = rb, ra
    p0 = max(ra.start, rb.start)
    p1 = max(ra.end, rb.end)
    capped = width_cap is not None and p1 > width_cap
    if width_cap is not None:
        p1 = min(p1, width_cap)
    if p1 <= p0:  # no overlap at all: concatenation
        lo = ra
        bits = list(lo.bits) + [CONST0] * (rb.start - lo.end) + list(rb.bits)
        return Row(lo.shift, tuple(bits)).trimmed()
    a = [ra.bit_at(p) for p in range(p0, p1)]
    b = [rb.bit_at(p) for p in range(p0, p1)]
    if share:
        sums, cout = net.add_chain(a, b, want_cout=not capped)
    else:
        sums, cout = _add_chain_fresh(net, a, b, want_cout=not capped)
    low = [ra.bit_at(p) for p in range(ra.start, p0)]
    bits = low + list(sums)
    if cout is not None:
        bits.append(cout)
    return Row(ra.start, tuple(bits)).trimmed()


def add_rows_naive(net: Netlist, ra: Row, rb: Row,
                   width_cap: int | None = None) -> Row:
    """Stock-VTR row addition: a fresh full-width ripple chain.

    No low-bit passthrough, no constant propagation, no chain sharing — each
    add instantiates adders across the union of both rows' spans, exactly the
    redundant behaviour the paper measures against (§IV: baseline VTR uses
    2.85x more full adders on a ``01010101`` constant).
    """
    p0 = min(ra.start, rb.start)
    p1 = max(ra.end, rb.end)
    if width_cap is not None:
        p1 = min(p1, width_cap)
    capped = width_cap is not None and max(ra.end, rb.end) + 1 > width_cap
    if p1 <= p0:
        return Row(0, ())
    a = [ra.bit_at(p) for p in range(p0, p1)]
    b = [rb.bit_at(p) for p in range(p0, p1)]
    sums, cout = _add_chain_fresh(net, a, b, want_cout=not capped)
    bits = list(sums)
    if cout is not None:
        bits.append(cout)
    return Row(p0, tuple(bits))


def _add_chain_fresh(net: Netlist, a, b, want_cout: bool):
    """A chain that bypasses structural hashing (models stock VTR)."""
    sums = [net.new_sig() for _ in a]
    cout = net.new_sig() if want_cout else None
    from .netlist import Chain

    ci = len(net.chains)
    net.chains.append(Chain(a=list(a), b=list(b), sums=sums, cin=CONST0, cout=cout))
    for bi, s in enumerate(sums):
        net.driver[s] = ("chain", ci, bi)
    if cout is not None:
        net.driver[cout] = ("cout", ci)
    return sums, cout


# ---------------------------------------------------------------------------
# partial-product generation
# ---------------------------------------------------------------------------


def const_mult_rows(net: Netlist, x_bus: Sequence[int], const: int, n_const_bits: int,
                    signed: bool = False, out_width: int | None = None,
                    skip_zero: bool = True) -> list[Row]:
    """Rows of an unrolled multiplication ``x * const``.

    Each set bit *i* of ``const`` (the "selector bit", §IV) contributes the
    multiplicand shifted by *i*.  With ``signed=True`` the multiplicand rows
    are sign-extended to ``out_width`` (arithmetic is mod 2**out_width).
    """
    m = len(x_bus)
    W = out_width if out_width is not None else m + n_const_bits
    const &= (1 << n_const_bits) - 1
    if not skip_zero and const == 0:
        # even stock VTR's frontend (Yosys) folds an all-zero multiplier
        return []
    n_sel_bits = n_const_bits
    if signed:
        # sign-extend the constant to the output width: x*c (mod 2^W) is then
        # a plain sum of selector rows even for negative constants.
        if (const >> (n_const_bits - 1)) & 1:
            const |= ((1 << W) - 1) ^ ((1 << n_const_bits) - 1)
        n_sel_bits = W
    rows: list[Row] = []
    for i in range(n_sel_bits):
        sel = (const >> i) & 1
        if skip_zero and not sel:
            continue
        if not sel:
            rows.append(Row(i, tuple([CONST0] * m)))
            continue
        bits = list(x_bus)
        if signed:
            # sign-extend up to W
            while i + len(bits) < W:
                bits.append(x_bus[-1])
        bits = bits[: max(0, W - i)]
        if bits:
            rows.append(Row(i, tuple(bits)))
    return rows


def var_mult_rows(net: Netlist, x_bus: Sequence[int], y_bus: Sequence[int],
                  signed: bool = False, out_width: int | None = None) -> list[Row]:
    """Rows of a variable multiplication: row i = AND(x, y_i) << i.

    With ``signed=True`` both operands are two's complement.  The most
    significant multiplier bit has weight ``-2^(n-1)``, so its row is negated
    Baugh-Wooley style: emit the bitwise complement of the full-width row plus
    a ``+1`` correction row (``-V = ~V + 1`` mod ``2^W``).
    """
    from .netlist import CONST1, tt_from_fn

    TT_NAND2 = tt_from_fn(lambda a, b: 1 - (a & b), 2)
    m, n = len(x_bus), len(y_bus)
    W = out_width if out_width is not None else m + n
    rows: list[Row] = []
    for i in range(n):
        neg = signed and i == n - 1
        tt = TT_NAND2 if neg else TT_AND2
        bits = [net.add_lut((xb, y_bus[i]), tt) for xb in x_bus]
        if signed:
            # sign-extend with (possibly complemented) x sign AND y_i
            while i + len(bits) < W:
                bits.append(bits[m - 1])
        bits = bits[: max(0, W - i)]
        if not bits:
            continue
        if neg:
            # complement covers [i, W); positions [0, i) complement to 1s,
            # then the +1 correction completes the two's complement negation.
            full = [CONST1] * i + bits
            rows.append(Row(0, tuple(full)))
            rows.append(Row(0, (CONST1,)))
        else:
            rows.append(Row(i, tuple(bits)))
    return rows


# ---------------------------------------------------------------------------
# top-level synthesis entry points
# ---------------------------------------------------------------------------


def reduce_rows(net: Netlist, rows: list[Row], algo: str,
                width_cap: int | None = None) -> Row:
    from . import adder_tree, compressor

    if algo == "vtr_baseline":
        # stock VTR: no zero-row pruning, adjacent pairing, fresh full chains
        if not rows:
            return Row(0, ())
        if len(rows) == 1:
            return rows[0]
        return adder_tree.reduce_binary(net, rows, width_cap=width_cap,
                                        use_dp=False, share=False)
    rows = [r.trimmed() for r in rows if not r.trimmed().is_zero()]
    if not rows:
        return Row(0, ())
    if len(rows) == 1:
        return rows[0]
    if algo == "cascade":
        acc = rows[0]
        for r in rows[1:]:
            acc = add_rows(net, acc, r, width_cap=width_cap, share=True)
        return acc
    if algo == "binary":
        return adder_tree.reduce_binary(net, rows, width_cap=width_cap,
                                        use_dp=True, share=True)
    if algo in ("wallace", "dadda", "pw"):
        return compressor.reduce_compressor(net, rows, algo=algo,
                                            width_cap=width_cap)
    raise ValueError(f"unknown reduction algo {algo!r}")


def synth_const_mult(net: Netlist, x_bus: Sequence[int], const: int,
                     n_const_bits: int, algo: str = "wallace",
                     signed: bool = False, out_width: int | None = None) -> list[int]:
    W = out_width if out_width is not None else len(x_bus) + n_const_bits
    skip = algo != "vtr_baseline"
    rows = const_mult_rows(net, x_bus, const, n_const_bits, signed=signed,
                           out_width=W, skip_zero=skip)
    res = reduce_rows(net, rows, algo, width_cap=W)
    return row_to_bus(res, W)


def synth_var_mult(net: Netlist, x_bus: Sequence[int], y_bus: Sequence[int],
                   algo: str = "wallace", signed: bool = False,
                   out_width: int | None = None) -> list[int]:
    W = out_width if out_width is not None else len(x_bus) + len(y_bus)
    rows = var_mult_rows(net, x_bus, y_bus, signed=signed, out_width=W)
    res = reduce_rows(net, rows, algo, width_cap=W)
    return row_to_bus(res, W)


def synth_dot_const(net: Netlist, x_buses: Sequence[Sequence[int]],
                    weights: Sequence[int], n_const_bits: int,
                    algo: str = "wallace", signed: bool = False,
                    out_width: int | None = None,
                    style: str = "per_mult") -> list[int]:
    """Dot product with compile-time constant weights (unrolled DNN MAC).

    ``style="per_mult"`` (paper/Kratos-faithful): each multiplier is reduced
    with ``algo`` (compressor tree / improved adder tree), and the resulting
    products are summed on an explicit binary adder-chain tree — this is why
    Kratos circuits are adder-dominated (Table III: 61.4 %).

    ``style="fused"`` merges *all* partial-product rows of the dot product
    into a single reduction — a beyond-paper variant that trades adder chains
    for LUT compressors.
    """
    assert len(x_buses) == len(weights)
    m = max((len(b) for b in x_buses), default=1)
    import math

    acc_bits = m + n_const_bits + max(1, math.ceil(math.log2(max(1, len(weights)))))
    W = out_width if out_width is not None else acc_bits
    skip = algo != "vtr_baseline"
    if style == "fused":
        rows: list[Row] = []
        for bus, w in zip(x_buses, weights):
            rows.extend(const_mult_rows(net, bus, w, n_const_bits,
                                        signed=signed, out_width=W,
                                        skip_zero=skip))
        res = reduce_rows(net, rows, algo, width_cap=W)
        return row_to_bus(res, W)
    # per-multiplier reduction, then an explicit adder-chain tree
    prods: list[Row] = []
    for bus, w in zip(x_buses, weights):
        rows = const_mult_rows(net, bus, w, n_const_bits, signed=signed,
                               out_width=W, skip_zero=skip)
        if not rows:
            continue
        prods.append(reduce_rows(net, rows, algo, width_cap=W))
    tree_algo = "vtr_baseline" if algo == "vtr_baseline" else (
        "cascade" if algo == "cascade" else "binary")
    res = reduce_rows(net, prods, tree_algo, width_cap=W)
    return row_to_bus(res, W)


def row_to_bus(row: Row, width: int) -> list[int]:
    return [row.bit_at(p) for p in range(width)]
