"""Benchmark circuit generators.

The paper evaluates on three suites (Table III).  No Verilog frontend exists
in this container, so each suite is re-generated from its published
structural description, scaled to laptop size (relative area/delay deltas are
the reproduction target — see DESIGN.md §3):

* **Kratos-like** [Dai et al., FPL'24]: unrolled DNN layers — every weight a
  compile-time constant, sparsity = fraction of zero weights, mixed
  precision.  Adder-dominated (paper: 61.4 % average adder fraction).
* **Koios-like** [Arora et al.]: ML accelerators with *runtime* operands —
  var x var multiplier arrays + accumulators + control logic (22.5 % adders).
* **VTR-like** [Rose et al.]: general logic — random control networks,
  comparators, small accumulators (19.5 % adders).
* **SHA-like**: 32-bit modular adds + Ch/Maj/Sigma logic, the filler circuit
  of the paper's end-to-end stress test (Table IV).
"""
from __future__ import annotations

import random

from .netlist import (CONST0, Netlist, TT_AND2, TT_MAJ3, TT_NOT, TT_OR2,
                      TT_XOR2, TT_XOR3, tt_from_fn)
from .synth import synth_dot_const, synth_var_mult, Row, reduce_rows
from .techmap import techmap


def _relu(net: Netlist, bus, sign_bit):
    """out = sign ? 0 : x  (bitwise AND with NOT sign)."""
    tt = tt_from_fn(lambda x, s: x & (1 - s), 2)
    return [net.add_lut((b, sign_bit), tt) for b in bus]


def _rand_weights(rng: random.Random, n: int, bits: int, sparsity: float,
                  signed: bool = True):
    ws = []
    for _ in range(n):
        if rng.random() < sparsity:
            ws.append(0)
        else:
            w = rng.getrandbits(bits)
            while w == 0:
                w = rng.getrandbits(bits)
            ws.append(w)
    return ws


# ---------------------------------------------------------------------------
# Kratos-like (unrolled DNN, constant weights)
# ---------------------------------------------------------------------------


def kratos_conv1d(name="conv1d-fu", in_ch=4, out_ch=8, taps=3, n_pos=4,
                  width=6, sparsity=0.5, algo="wallace", seed=0) -> Netlist:
    rng = random.Random(seed)
    net = Netlist(name)
    xs = {}
    for c in range(in_ch):
        for p in range(n_pos + taps - 1):
            xs[(c, p)] = net.add_pi_bus(f"x{c}_{p}", width)
    for o in range(out_ch):
        w = _rand_weights(rng, in_ch * taps, width, sparsity)
        for p in range(n_pos):
            buses = [xs[(c, p + t)] for c in range(in_ch) for t in range(taps)]
            acc = synth_dot_const(net, buses, w, width, algo=algo, signed=True)
            out = _relu(net, acc, acc[-1])
            net.set_po_bus(f"y{o}_{p}", out)
    return techmap(net.sweep())


def kratos_conv2d(name="conv2d-fu", in_ch=2, out_ch=4, k=3, n_pos=3,
                  width=6, sparsity=0.5, algo="wallace", seed=0) -> Netlist:
    rng = random.Random(seed)
    net = Netlist(name)
    span = n_pos + k - 1
    xs = {}
    for c in range(in_ch):
        for i in range(span):
            for j in range(span):
                xs[(c, i, j)] = net.add_pi_bus(f"x{c}_{i}_{j}", width)
    for o in range(out_ch):
        w = _rand_weights(rng, in_ch * k * k, width, sparsity)
        for pi in range(n_pos):
            for pj in range(n_pos):
                buses = [xs[(c, pi + di, pj + dj)]
                         for c in range(in_ch)
                         for di in range(k) for dj in range(k)]
                acc = synth_dot_const(net, buses, w, width, algo=algo,
                                      signed=True)
                out = _relu(net, acc, acc[-1])
                net.set_po_bus(f"y{o}_{pi}_{pj}", out)
    return techmap(net.sweep())


def kratos_gemm(name="gemm-fu", m=8, n=8, width=6, sparsity=0.5,
                algo="wallace", seed=0) -> Netlist:
    """y = W @ x with constant W (m outputs, n inputs)."""
    rng = random.Random(seed)
    net = Netlist(name)
    xs = [net.add_pi_bus(f"x{j}", width) for j in range(n)]
    for i in range(m):
        w = _rand_weights(rng, n, width, sparsity)
        acc = synth_dot_const(net, xs, w, width, algo=algo, signed=True)
        net.set_po_bus(f"y{i}", acc)
    return techmap(net.sweep())


def kratos_fc(name="fc-fu", m=12, n=12, width=4, sparsity=0.5,
              algo="wallace", seed=0) -> Netlist:
    net = kratos_gemm(name, m=m, n=n, width=width, sparsity=sparsity,
                      algo=algo, seed=seed)
    net.name = name
    return net


def kratos_suite(algo="wallace", scale=1.0, seed=0) -> list[Netlist]:
    s = scale
    return [
        kratos_conv1d("conv1d-fu", in_ch=max(2, int(4 * s)), out_ch=max(4, int(8 * s)),
                      width=6, sparsity=0.5, algo=algo, seed=seed),
        kratos_conv1d("conv1d-pw-fu", in_ch=max(2, int(4 * s)), out_ch=max(4, int(8 * s)),
                      taps=1, width=6, sparsity=0.5, algo=algo, seed=seed + 1),
        kratos_conv2d("conv2d-fu", in_ch=2, out_ch=max(2, int(4 * s)),
                      width=6, sparsity=0.5, algo=algo, seed=seed + 2),
        kratos_gemm("gemms-fu", m=max(4, int(8 * s)), n=max(4, int(8 * s)),
                    width=6, sparsity=0.5, algo=algo, seed=seed + 3),
        kratos_gemm("gemmt-fu", m=max(4, int(10 * s)), n=max(4, int(10 * s)),
                    width=6, sparsity=0.5, algo=algo, seed=seed + 4),
        kratos_fc("fc-fu", m=max(6, int(12 * s)), n=max(6, int(12 * s)),
                  width=4, sparsity=0.5, algo=algo, seed=seed + 5),
        kratos_gemm("gemm-dense-fu", m=max(4, int(8 * s)), n=max(4, int(8 * s)),
                    width=8, sparsity=0.25, algo=algo, seed=seed + 6),
    ]


# ---------------------------------------------------------------------------
# Koios-like (runtime operands: multiplier arrays + control)
# ---------------------------------------------------------------------------


def _random_logic(net: Netlist, rng: random.Random, inputs, n_nodes, k=4):
    pool = list(inputs)
    outs = []
    for _ in range(n_nodes):
        kk = rng.randint(2, k)
        ins = tuple(rng.sample(pool, min(kk, len(pool))))
        tt = rng.getrandbits(1 << len(ins))
        o = net.add_lut(ins, tt)
        pool.append(o)
        outs.append(o)
    return outs


def koios_mac_array(name="dla-like", pes=4, width=6, algo="wallace",
                    seed=0, ctrl_nodes=120, acc_width=28) -> Netlist:
    """ML-accelerator-like: var x var multipliers, a reduction tree, wide
    output accumulators fed by the (registered) reduction result, plus
    control/address logic."""
    rng = random.Random(seed)
    net = Netlist(name)
    outs = []
    for p in range(pes):
        x = net.add_pi_bus(f"x{p}", width)
        wv = net.add_pi_bus(f"w{p}", width)
        prod = synth_var_mult(net, x, wv, algo=algo, signed=True)
        outs.append(prod)
    # reduce products on carry chains
    rows = [Row(0, tuple(b)) for b in outs]
    acc = reduce_rows(net, rows, "binary", width_cap=2 * width + pes)
    from .synth import row_to_bus

    acc_bus = row_to_bus(acc, 2 * width + pes)
    net.set_po_bus("acc", acc_bus)
    # wide output accumulators (acc_reg += dot): operands are internal
    # (registered) buses — classic Koios accumulate stage
    state = net.add_pi_bus("acc_state", acc_width)
    ext = list(acc_bus) + [acc_bus[-1]] * (acc_width - len(acc_bus))
    new_state, _ = net.add_chain(list(state), ext[:acc_width])
    net.set_po_bus("acc_next", new_state)
    # control / address-generation logic
    ctrl_in = net.add_pi_bus("ctrl", 16)
    nodes = _random_logic(net, rng, ctrl_in, ctrl_nodes)
    net.set_po_bus("ctrl_out", nodes[-16:])
    return techmap(net.sweep())


def koios_suite(algo="wallace", scale=1.0, seed=0) -> list[Netlist]:
    s = scale
    return [
        koios_mac_array("dla-like", pes=max(2, int(4 * s)), width=6,
                        algo=algo, seed=seed),
        koios_mac_array("tpu-like", pes=max(2, int(6 * s)), width=8,
                        algo=algo, seed=seed + 1, ctrl_nodes=200),
        koios_mac_array("dnnweaver-like", pes=max(2, int(3 * s)), width=4,
                        algo=algo, seed=seed + 2, ctrl_nodes=300),
        koios_mac_array("conv-like", pes=max(2, int(5 * s)), width=6,
                        algo=algo, seed=seed + 3, ctrl_nodes=80),
        koios_mac_array("lstm-like", pes=max(2, int(4 * s)), width=8,
                        algo=algo, seed=seed + 4, ctrl_nodes=150),
    ]


# ---------------------------------------------------------------------------
# VTR-like (general logic)
# ---------------------------------------------------------------------------


def vtr_mixed(name="or1200-like", n_in=32, logic_nodes=500, adders=2,
              add_width=16, seed=0) -> Netlist:
    """General-logic circuit: a random control network whose internal nodes
    feed datapath adders (as in real cores, where ALU operands come from
    muxed/registered internal logic, not from pins)."""
    rng = random.Random(seed)
    net = Netlist(name)
    ins = net.add_pi_bus("in", n_in)
    nodes = _random_logic(net, rng, ins, logic_nodes)
    po_nodes = nodes[-min(32, len(nodes)):]
    for a in range(adders):
        # operands: mix of internal logic nodes and pins
        if a % 2 == 0 and len(nodes) >= 2 * add_width:
            xa = [rng.choice(nodes) for _ in range(add_width)]
            xb = [rng.choice(nodes) for _ in range(add_width)]
        else:
            xa = net.add_pi_bus(f"a{a}", add_width)
            xb = list(net.add_pi_bus(f"b{a}", add_width))
        sums, _ = net.add_chain(list(xa), list(xb))
        net.set_po_bus(f"sum{a}", sums)
    net.set_po_bus("logic", po_nodes)
    return techmap(net.sweep())


def vtr_suite(scale=1.0, seed=0) -> list[Netlist]:
    s = scale
    return [
        vtr_mixed("or1200-like", logic_nodes=int(500 * s), adders=3,
                  add_width=16, seed=seed),
        vtr_mixed("blob-merge-like", logic_nodes=int(800 * s), adders=4,
                  add_width=12, seed=seed + 1),
        vtr_mixed("arm-core-like", logic_nodes=int(1200 * s), adders=6,
                  add_width=24, seed=seed + 2),
        sha_like("sha-like", rounds=max(1, int(2 * s)), seed=seed + 3),
        vtr_mixed("stereovision-like", logic_nodes=int(600 * s), adders=8,
                  add_width=10, seed=seed + 4),
    ]


# ---------------------------------------------------------------------------
# SHA-like (end-to-end stress filler, Table IV)
# ---------------------------------------------------------------------------


def sha_like(name="sha", rounds=2, width=32, seed=0) -> Netlist:
    net = Netlist(name)
    a = net.add_pi_bus("a", width)
    b = net.add_pi_bus("b", width)
    c = net.add_pi_bus("c", width)
    d = net.add_pi_bus("d", width)
    w = net.add_pi_bus("w", width)
    TT_CH = tt_from_fn(lambda e, f, g: (e & f) | ((1 - e) & g), 3)
    for r in range(rounds):
        # Sigma: xor of rotations
        s0 = [net.add_lut((a[(i + 2) % width], a[(i + 13) % width],
                           a[(i + 22) % width]), TT_XOR3) for i in range(width)]
        maj = [net.add_lut((a[i], b[i], c[i]), TT_MAJ3) for i in range(width)]
        ch = [net.add_lut((b[i], c[i], d[i]), TT_CH) for i in range(width)]
        t1, _ = net.add_chain(ch, w)
        t2, _ = net.add_chain(s0, maj)
        t3, _ = net.add_chain(t1, t2)
        new_a, _ = net.add_chain(t3, d)
        a, b, c, d = new_a, a, b, c
        w = t3
    net.set_po_bus("h0", a)
    net.set_po_bus("h1", b)
    return techmap(net.sweep())
