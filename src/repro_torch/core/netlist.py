"""Netlist intermediate representation for the Double-Duty CAD stack.

The IR models exactly the primitives that matter for the paper's experiments:

* **k-LUT nodes** — arbitrary boolean functions of up to ``MAX_LUT_K`` inputs,
  stored as truth-table integers (bit ``i`` of ``tt`` is the output for input
  assignment ``i``, where input ``j`` contributes bit ``j`` of ``i``).
* **carry chains** — runs of 1-bit full adders with a ripple carry, the
  hard-adder resource of a Stratix-like ALM (2 FA bits per ALM).
* **primary inputs / outputs** — grouped into named buses.

Signals are dense integer ids.  Signal 0 is constant-0 and signal 1 is
constant-1.  Structural hashing deduplicates identical LUTs and identical
carry chains — the mechanism behind the paper's "duplicate adder chain"
optimization (§IV, *Unrolled Multiplication*).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

CONST0 = 0
CONST1 = 1

MAX_LUT_K = 6

# ---------------------------------------------------------------------------
# truth-table helpers
# ---------------------------------------------------------------------------


def tt_const(value: bool, k: int = 0) -> int:
    mask = (1 << (1 << k)) - 1
    return mask if value else 0


def tt_var(j: int, k: int) -> int:
    """Truth table (over k inputs) of input variable ``j``."""
    out = 0
    for m in range(1 << k):
        if (m >> j) & 1:
            out |= 1 << m
    return out


def tt_eval(tt: int, assignment: int) -> int:
    return (tt >> assignment) & 1


def tt_words64(tt: int, k: int) -> tuple[int, int]:
    """Replicate a ``k``-input table into a 64-entry mask, split into
    (lo, hi) uint32 words — the evaluator's per-row LUT payload.  The
    replication makes every pin beyond ``k`` a don't-care, so padded pin
    slots may hold any signal (the lowering pads with CONST0)."""
    full = 0
    for r in range(1 << (6 - k)):
        full |= tt << (r * (1 << k))
    full &= (1 << 64) - 1
    return full & 0xFFFFFFFF, full >> 32


def tt_from_fn(fn, k: int) -> int:
    out = 0
    for m in range(1 << k):
        bits = [(m >> j) & 1 for j in range(k)]
        if fn(*bits):
            out |= 1 << m
    return out


# common tables (indexed little-endian: input0 is bit0 of the assignment)
TT_BUF = 0b10                                 # 1 input
TT_NOT = 0b01
TT_AND2 = tt_from_fn(lambda a, b: a & b, 2)
TT_XOR2 = tt_from_fn(lambda a, b: a ^ b, 2)
TT_OR2 = tt_from_fn(lambda a, b: a | b, 2)
TT_XOR3 = tt_from_fn(lambda a, b, c: a ^ b ^ c, 3)
TT_MAJ3 = tt_from_fn(lambda a, b, c: (a & b) | (c & (a | b)), 3)
TT_MUX = tt_from_fn(lambda s, a, b: b if s else a, 3)  # s ? b : a


def tt_compose(outer_tt: int, outer_inputs: Sequence[int], pin: int,
               inner_tt: int, inner_inputs: Sequence[int]):
    """Substitute ``inner`` into pin ``pin`` of ``outer``.

    Returns ``(new_inputs, new_tt)`` over the merged support.  Used by the
    ABC-lite technology mapper to collapse single-fanout logic.
    """
    merged: list[int] = [s for i, s in enumerate(outer_inputs) if i != pin]
    for s in inner_inputs:
        if s not in merged:
            merged.append(s)
    k = len(merged)
    if k > MAX_LUT_K:
        raise ValueError("composition exceeds MAX_LUT_K")
    pos = {s: j for j, s in enumerate(merged)}
    new_tt = 0
    for m in range(1 << k):
        inner_asgn = 0
        for j, s in enumerate(inner_inputs):
            if (m >> pos[s]) & 1:
                inner_asgn |= 1 << j
        inner_val = tt_eval(inner_tt, inner_asgn)
        outer_asgn = 0
        oj = 0
        for i, s in enumerate(outer_inputs):
            if i == pin:
                bit = inner_val
            else:
                bit = (m >> pos[s]) & 1
            if bit:
                outer_asgn |= 1 << i
        if tt_eval(outer_tt, outer_asgn):
            new_tt |= 1 << m
    return tuple(merged), new_tt


def tt_reduce(inputs: Sequence[int], tt: int):
    """Drop constant / duplicate / don't-care inputs.

    Returns a canonicalized ``(inputs, tt)`` pair (possibly 0 inputs →
    constant).  Keeps the mapper honest about LUT sizes.
    """
    inputs = list(inputs)
    # substitute constants
    changed = True
    while changed:
        changed = False
        k = len(inputs)
        for j, s in enumerate(inputs):
            if s in (CONST0, CONST1):
                bit = 1 if s == CONST1 else 0
                new_tt = 0
                nk = k - 1
                for m in range(1 << nk):
                    full = _insert_bit(m, j, bit)
                    if tt_eval(tt, full):
                        new_tt |= 1 << m
                tt = new_tt
                inputs.pop(j)
                changed = True
                break
        if changed:
            continue
        k = len(inputs)
        # duplicate inputs
        seen: dict[int, int] = {}
        for j, s in enumerate(inputs):
            if s in seen:
                jj = seen[s]
                new_tt = 0
                nk = k - 1
                for m in range(1 << nk):
                    full = _insert_bit(m, j, (m >> (jj if jj < j else jj - 1)) & 1)
                    if tt_eval(tt, full):
                        new_tt |= 1 << m
                tt = new_tt
                inputs.pop(j)
                changed = True
                break
            seen[s] = j
        if changed:
            continue
        # don't-care inputs
        k = len(inputs)
        for j in range(k):
            lo = 0
            hi = 0
            nk = k - 1
            care = False
            for m in range(1 << nk):
                b0 = tt_eval(tt, _insert_bit(m, j, 0))
                b1 = tt_eval(tt, _insert_bit(m, j, 1))
                if b0 != b1:
                    care = True
                    break
                if b0:
                    lo |= 1 << m
            if not care:
                tt = lo
                inputs.pop(j)
                changed = True
                break
    return tuple(inputs), tt


def _insert_bit(m: int, j: int, bit: int) -> int:
    low = m & ((1 << j) - 1)
    high = m >> j
    return low | (bit << j) | (high << (j + 1))


# ---------------------------------------------------------------------------
# netlist
# ---------------------------------------------------------------------------


@dataclass
class Chain:
    """A ripple-carry chain of 1-bit full adders.

    Bit ``i`` computes ``sums[i] = a[i] ^ b[i] ^ c_i`` with
    ``c_{i+1} = MAJ(a[i], b[i], c_i)`` and ``c_0 = cin``.
    """

    a: list[int]
    b: list[int]
    sums: list[int]
    cin: int = CONST0
    cout: int | None = None

    def n_adders(self) -> int:
        return len(self.sums)


class Netlist:
    def __init__(self, name: str = "") -> None:
        self.name = name
        self.n_signals = 2  # const0, const1
        self.pis: list[int] = []
        self.pi_buses: dict[str, list[int]] = {}
        self.pos: dict[str, list[int]] = {}
        self.lut_inputs: list[tuple[int, ...]] = []
        self.lut_tt: list[int] = []
        self.lut_out: list[int] = []
        self.chains: list[Chain] = []
        # structural hashing
        self._lut_cache: dict[tuple, int] = {}
        self._chain_cache: dict[tuple, int] = {}
        # signal -> driver: ("pi",idx) ("lut",idx) ("chain",ci,bi) ("cout",ci)
        self.driver: dict[int, tuple] = {}

    # -- construction -------------------------------------------------------
    def new_sig(self) -> int:
        s = self.n_signals
        self.n_signals += 1
        return s

    def add_pi_bus(self, name: str, width: int) -> list[int]:
        bus = []
        for i in range(width):
            s = self.new_sig()
            self.pis.append(s)
            self.driver[s] = ("pi", len(self.pis) - 1)
            bus.append(s)
        self.pi_buses[name] = bus
        return bus

    def set_po_bus(self, name: str, bus: Sequence[int]) -> None:
        self.pos[name] = list(bus)

    def add_lut(self, inputs: Sequence[int], tt: int) -> int:
        inputs, tt = tt_reduce(inputs, tt)
        if len(inputs) == 0:
            return CONST1 if tt & 1 else CONST0
        if len(inputs) == 1 and tt == TT_BUF:
            return inputs[0]
        if len(inputs) > MAX_LUT_K:
            raise ValueError(f"LUT with {len(inputs)} inputs > {MAX_LUT_K}")
        key = (inputs, tt)
        hit = self._lut_cache.get(key)
        if hit is not None:
            return self.lut_out[hit]
        out = self.new_sig()
        idx = len(self.lut_out)
        self.lut_inputs.append(inputs)
        self.lut_tt.append(tt)
        self.lut_out.append(out)
        self._lut_cache[key] = idx
        self.driver[out] = ("lut", idx)
        return out

    def add_chain(self, a: Sequence[int], b: Sequence[int], cin: int = CONST0,
                  want_cout: bool = False) -> tuple[list[int], int | None]:
        """Add (or reuse) a full-adder chain summing two aligned bit vectors.

        ``a`` and ``b`` must have equal length; pad with CONST0 first.
        Returns ``(sum_bits, cout_signal_or_None)``.  Chains are structurally
        hashed: an identical (a, b, cin) chain is emitted once and fanned out,
        implementing the paper's duplicate-adder-chain optimization.
        """
        a = list(a)
        b = list(b)
        assert len(a) == len(b) and len(a) > 0
        key = (tuple(a), tuple(b), cin)
        hit = self._chain_cache.get(key)
        if hit is not None:
            ch = self.chains[hit]
            if want_cout and ch.cout is None:
                ch.cout = self.new_sig()
                self.driver[ch.cout] = ("cout", hit)
            return list(ch.sums), ch.cout
        sums = [self.new_sig() for _ in a]
        ci = len(self.chains)
        cout = None
        if want_cout:
            cout = self.new_sig()
        ch = Chain(a=a, b=b, sums=sums, cin=cin, cout=cout)
        self.chains.append(ch)
        self._chain_cache[key] = ci
        for bi, s in enumerate(sums):
            self.driver[s] = ("chain", ci, bi)
        if cout is not None:
            self.driver[cout] = ("cout", ci)
        return sums, cout

    def content_digest(self) -> str:
        """Digest of the netlist's *structure* (signals, LUTs, chains,
        POs — not the name).  This is the cache key every caller-owned
        pack/plan/program cache must use: keys derived from a circuit's
        position in a list silently serve wrong entries when the same
        cache is passed with a different list (see
        :func:`repro_torch.core.sweep.sweep_suite`).  Deliberately uncached:
        callers may mutate netlist attributes directly, so a stale
        digest would defeat the content keying this exists for."""
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        h.update(repr((self.n_signals, tuple(self.pis),
                       tuple(self.lut_inputs), tuple(self.lut_tt),
                       tuple(self.lut_out),
                       tuple((tuple(c.a), tuple(c.b), tuple(c.sums),
                              c.cin, c.cout) for c in self.chains),
                       tuple(sorted((k, tuple(v))
                                    for k, v in self.pos.items()))
                       )).encode())
        return h.hexdigest()

    def pack_digest(self) -> str:
        """Digest of the *pack-and-timing-relevant* structure — everything
        :meth:`content_digest` covers **except the LUT truth tables**.
        Neither the packer (absorption / chain slotting / pairing /
        clustering read only connectivity) nor static timing (delays are
        per-edge-class, never per-function) ever reads ``lut_tt``, so two
        netlists with equal pack digests produce byte-identical
        ``pack()`` results and identical timing/area records under every
        (arch, seed).  This is the key behind the flow server's
        netlist-delta fast path (:mod:`repro.core.serve_flow`): a
        truth-table-only edit — the shape of an incremental-synthesis
        weight/constant update — reuses the base request's pack and
        timing outright and re-runs only functional evaluation."""
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        h.update(repr((self.n_signals, tuple(self.pis),
                       tuple(self.lut_inputs),
                       tuple(self.lut_out),
                       tuple((tuple(c.a), tuple(c.b), tuple(c.sums),
                              c.cin, c.cout) for c in self.chains),
                       tuple(sorted((k, tuple(v))
                                    for k, v in self.pos.items()))
                       )).encode())
        return h.hexdigest()

    def lower_ir(self):
        """The functional columnar :class:`~repro_torch.core.circuit_ir.CircuitIR`
        of this netlist (levelized node rows with truth-table words, signal
        kind/level columns, fanin CSR topology — no placement columns).
        Content-cached in the shared registry: this is the single
        levelization that the fused evaluator, the equivalence lanes and
        every packed lowering of this circuit consume."""
        from .circuit_ir import lower_netlist_ir

        return lower_netlist_ir(self)

    # -- stats --------------------------------------------------------------
    @property
    def n_luts(self) -> int:
        return len(self.lut_out)

    @property
    def n_adders(self) -> int:
        return sum(c.n_adders() for c in self.chains)

    def lut_size_histogram(self) -> dict[int, int]:
        hist: dict[int, int] = {}
        for ins in self.lut_inputs:
            hist[len(ins)] = hist.get(len(ins), 0) + 1
        return hist

    def stats(self) -> dict:
        return {
            "name": self.name,
            "pis": len(self.pis),
            "pos": sum(len(v) for v in self.pos.values()),
            "luts": self.n_luts,
            "adders": self.n_adders,
            "chains": len(self.chains),
            "lut_hist": self.lut_size_histogram(),
        }

    # -- topology ------------------------------------------------------------
    def node_list(self) -> list[tuple]:
        """All nodes: ("lut", i) and ("chain", i)."""
        return [("lut", i) for i in range(self.n_luts)] + [
            ("chain", i) for i in range(len(self.chains))
        ]

    def node_inputs(self, node: tuple) -> list[int]:
        kind, idx = node
        if kind == "lut":
            return list(self.lut_inputs[idx])
        ch = self.chains[idx]
        ins = list(ch.a) + list(ch.b)
        if ch.cin not in (CONST0, CONST1):
            ins.append(ch.cin)
        return ins

    def node_outputs(self, node: tuple) -> list[int]:
        kind, idx = node
        if kind == "lut":
            return [self.lut_out[idx]]
        ch = self.chains[idx]
        outs = list(ch.sums)
        if ch.cout is not None:
            outs.append(ch.cout)
        return outs

    def topo_order(self) -> list[tuple]:
        """Kahn topological order over LUT/chain nodes."""
        nodes = self.node_list()
        produced_by: dict[int, tuple] = {}
        for nd in nodes:
            for s in self.node_outputs(nd):
                produced_by[s] = nd
        indeg: dict[tuple, int] = {nd: 0 for nd in nodes}
        consumers: dict[tuple, list[tuple]] = {nd: [] for nd in nodes}
        for nd in nodes:
            deps = set()
            for s in self.node_inputs(nd):
                p = produced_by.get(s)
                if p is not None and p != nd:
                    deps.add(p)
            indeg[nd] = len(deps)
            for p in deps:
                consumers[p].append(nd)
        from collections import deque

        q = deque([nd for nd in nodes if indeg[nd] == 0])
        order = []
        while q:
            nd = q.popleft()
            order.append(nd)
            for c in consumers[nd]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    q.append(c)
        if len(order) != len(nodes):
            raise RuntimeError("combinational cycle in netlist")
        return order

    def sweep(self) -> "Netlist":
        """Dead-code elimination: keep only logic reachable from the POs."""
        live: set[int] = set()
        for bus in self.pos.values():
            live.update(bus)
        produced_by: dict[int, tuple] = {}
        for nd in self.node_list():
            for s in self.node_outputs(nd):
                produced_by[s] = nd
        stack = list(live)
        live_nodes: set[tuple] = set()
        seen_sigs = set(stack)
        while stack:
            s = stack.pop()
            nd = produced_by.get(s)
            if nd is None or nd in live_nodes:
                continue
            live_nodes.add(nd)
            for t in self.node_inputs(nd):
                if t not in seen_sigs:
                    seen_sigs.add(t)
                    stack.append(t)
        out = Netlist(self.name)
        out.n_signals = self.n_signals
        out.pis = list(self.pis)
        out.pi_buses = dict(self.pi_buses)
        for s in self.pis:
            out.driver[s] = self.driver[s]
        for i in range(self.n_luts):
            if ("lut", i) in live_nodes:
                idx = len(out.lut_out)
                out.lut_inputs.append(self.lut_inputs[i])
                out.lut_tt.append(self.lut_tt[i])
                out.lut_out.append(self.lut_out[i])
                out.driver[self.lut_out[i]] = ("lut", idx)
                out._lut_cache[(self.lut_inputs[i], self.lut_tt[i])] = idx
        for i, ch in enumerate(self.chains):
            if ("chain", i) in live_nodes:
                ci = len(out.chains)
                out.chains.append(ch)
                out._chain_cache[(tuple(ch.a), tuple(ch.b), ch.cin)] = ci
                for bi, s in enumerate(ch.sums):
                    out.driver[s] = ("chain", ci, bi)
                if ch.cout is not None:
                    out.driver[ch.cout] = ("cout", ci)
        out.pos = {k: list(v) for k, v in self.pos.items()}
        return out


# ---------------------------------------------------------------------------
# pure-python functional evaluation (reference oracle for tests)
# ---------------------------------------------------------------------------


def eval_netlist(net: Netlist, pi_values: dict[int, int], n_vectors: int = 1):
    """Evaluate bit-parallel over arbitrary-width python ints.

    ``pi_values[signal] = int`` whose bit ``v`` is the signal's value in test
    vector ``v``.  Returns ``dict signal -> int`` for every signal.
    """
    mask = (1 << n_vectors) - 1
    val: dict[int, int] = {CONST0: 0, CONST1: mask}
    val.update({s: v & mask for s, v in pi_values.items()})
    for nd in net.topo_order():
        kind, idx = nd
        if kind == "lut":
            ins = net.lut_inputs[idx]
            tt = net.lut_tt[idx]
            out = 0
            # sum-of-minterms, bit-parallel
            for m in range(1 << len(ins)):
                if not tt_eval(tt, m):
                    continue
                term = mask
                for j, s in enumerate(ins):
                    sv = val[s]
                    term &= sv if (m >> j) & 1 else (~sv & mask)
                    if term == 0:
                        break
                out |= term
            val[net.lut_out[idx]] = out
        else:
            ch = net.chains[idx]
            c = val[ch.cin]
            for i in range(len(ch.sums)):
                av, bv = val[ch.a[i]], val[ch.b[i]]
                val[ch.sums[i]] = av ^ bv ^ c
                c = (av & bv) | (c & (av ^ bv))
            if ch.cout is not None:
                val[ch.cout] = c
    return val


def bus_to_ints(val: dict[int, int], bus: Sequence[int], n_vectors: int) -> list[int]:
    """Decode a bus (LSB-first signal list) into per-vector integers."""
    out = []
    for v in range(n_vectors):
        x = 0
        for j, s in enumerate(bus):
            if (val[s] >> v) & 1:
                x |= 1 << j
        out.append(x)
    return out
