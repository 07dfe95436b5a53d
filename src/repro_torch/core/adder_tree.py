"""Binary adder-tree reduction with the strength-heuristic DP (Algorithm 1).

At each reduction stage, ``n`` rows are paired into ``floor(n/2)`` carry
chains (an odd row passes through).  The paper's *strength* heuristic scores a
stage pairing by ``H = I / O`` where

* ``I`` — input signals **counted by position** (a signal feeding two chains
  counts twice), and
* ``O`` — output signals of **unique** chains (a chain identical to one that
  already exists — in this stage or anywhere in the netlist — contributes no
  new outputs).

Maximizing ``H`` rewards pairings that expose shifted-duplicate chains, which
the structural chain cache then builds only once (§IV, Fig. 4).

For ``n <= DP_LIMIT`` we run the exact memoized DP of Algorithm 1; above that
(dot-product reductions with dozens of rows) a duplicate-aware greedy pairing
is used — the paper only exercises the DP inside a single multiplier, where
``n`` is the operand width.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

from .netlist import Netlist
from .synth import Row, add_rows, add_rows_naive, chain_key_for

DP_LIMIT = 12


def reduce_binary(net: Netlist, rows: list[Row], width_cap: int | None = None,
                  use_dp: bool = True, share: bool = True) -> Row:
    if share:
        rows = [r for r in rows if not r.is_zero()]
    while len(rows) > 1:
        if not use_dp:
            pairs = [(i, i + 1) for i in range(0, len(rows) - 1, 2)]
            passthrough = [len(rows) - 1] if len(rows) % 2 else []
        elif len(rows) <= DP_LIMIT:
            pairs, passthrough = _best_placement(net, rows, width_cap)
        else:
            pairs, passthrough = _greedy_placement(rows)
        if share:
            nxt = [add_rows(net, rows[i], rows[j], width_cap=width_cap, share=True)
                   for i, j in pairs]
        else:
            nxt = [add_rows_naive(net, rows[i], rows[j], width_cap=width_cap)
                   for i, j in pairs]
        nxt.extend(rows[k] for k in passthrough)
        if share:
            nxt = [r for r in nxt if not r.is_zero()]
        rows = nxt
        if not rows:
            return Row(0, ())
    return rows[0]


# ---------------------------------------------------------------------------
# Algorithm 1 — exact memoized DP over row subsets
# ---------------------------------------------------------------------------


def _best_placement(net: Netlist, rows: list[Row], width_cap):
    """Return (pairs, passthrough) maximizing the stage strength H = I/O."""
    n = len(rows)
    keys = {}

    def pair_key(i: int, j: int):
        if (i, j) not in keys:
            keys[(i, j)] = chain_key_for(rows[i], rows[j], width_cap)
        return keys[(i, j)]

    existing = net._chain_cache

    memo: dict[int, tuple[float, int, int, tuple]] = {}

    def best(mask: int):
        """Best solution for the row subset ``mask``.

        Returns ``(H, I, O, pairs)`` where pairs is a tuple of (i, j).
        """
        cnt = bin(mask).count("1")
        if cnt < 2:
            return (0.0, 0, 0, ())
        if mask in memo:
            return memo[mask]
        idxs = [i for i in range(n) if (mask >> i) & 1]
        best_sol = None
        if cnt % 2 == 0:
            for ai in range(len(idxs)):
                for bi in range(ai + 1, len(idxs)):
                    i, j = idxs[ai], idxs[bi]
                    rest = mask & ~(1 << i) & ~(1 << j)
                    _, I_s, O_s, pairs_s = best(rest)
                    key = pair_key(i, j)
                    a, b = key
                    I_p = sum(1 for s in a + b if s != 0)
                    I_tot = I_s + I_p
                    seen = {pair_key(x, y) for x, y in pairs_s}
                    O_p = 0
                    if key not in seen and (a, b, 0) not in existing:
                        O_p = len(a) + 1  # sums + cout
                    O_tot = O_s + O_p
                    H = I_tot / max(O_tot, 1)
                    if best_sol is None or H > best_sol[0]:
                        best_sol = (H, I_tot, O_tot, pairs_s + ((i, j),))
        else:
            for drop in idxs:
                rest = mask & ~(1 << drop)
                H, I_s, O_s, pairs_s = best(rest)
                if best_sol is None or H > best_sol[0]:
                    best_sol = (H, I_s, O_s, pairs_s)
        memo[mask] = best_sol
        return best_sol

    full = (1 << n) - 1
    _, _, _, pairs = best(full)
    used = set()
    for i, j in pairs:
        used.add(i)
        used.add(j)
    passthrough = [k for k in range(n) if k not in used]
    return list(pairs), passthrough


# ---------------------------------------------------------------------------
# duplicate-aware greedy pairing for large row counts
# ---------------------------------------------------------------------------


def _greedy_placement(rows: list[Row]):
    """Pair rows so that shifted duplicates land in the same chain.

    Rows with identical bit patterns are grouped; within a group rows are
    sorted by shift and paired consecutively, which yields runs of equal
    shift-deltas (→ identical chain keys).  Leftovers are paired by
    proximity of their bit positions to minimize chain length.
    """
    n = len(rows)
    groups: dict[tuple[int, ...], list[int]] = {}
    for idx, r in enumerate(rows):
        groups.setdefault(r.bits, []).append(idx)
    pairs: list[tuple[int, int]] = []
    leftovers: list[int] = []
    for bits, idxs in groups.items():
        idxs.sort(key=lambda i: rows[i].shift)
        k = 0
        while k + 1 < len(idxs):
            pairs.append((idxs[k], idxs[k + 1]))
            k += 2
        if k < len(idxs):
            leftovers.append(idxs[k])
    leftovers.sort(key=lambda i: rows[i].shift)
    k = 0
    while k + 1 < len(leftovers):
        pairs.append((leftovers[k], leftovers[k + 1]))
        k += 2
    passthrough = leftovers[k:]
    return pairs, passthrough


def count_stage_strength(net: Netlist, rows: list[Row], pairs, width_cap=None):
    """Diagnostic: the H value of a given stage pairing (used in tests)."""
    I_tot = 0
    O_tot = 0
    seen = set()
    for i, j in pairs:
        a, b = chain_key_for(rows[i], rows[j], width_cap)
        I_tot += sum(1 for s in a + b if s != 0)
        key = (a, b)
        if key not in seen and (a, b, 0) not in net._chain_cache:
            seen.add(key)
            O_tot += len(a) + 1
    return I_tot / max(O_tot, 1)
