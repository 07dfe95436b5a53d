"""The port's flow (pack + analyze, the equivalence gate, state
conversion) against the JAX package's, on the CPU: records equal key by
key, the same equivalence verdicts and the same first mismatch."""
import random

import numpy as np
import pytest

from repro.core import circuits as rcirc
from repro.core import equiv as requiv
from repro.core import flow as rflow
from repro.core.alm import ARCHS as RARCHS
from repro.core.netlist import Netlist as RNetlist
from repro.core.packing import pack as rpack
from repro_torch.core import circuits as tcirc
from repro_torch.core import equiv as tequiv
from repro_torch.core import flow as tflow
from repro_torch.core.alm import ARCHS, DD5
from repro_torch.core.convert import netlist_from_state, netlist_state
from repro_torch.core.netlist import Netlist
from repro_torch.core.packing import pack

CPU = "cpu"
ARCH_NAMES = ("baseline", "dd5", "dd6")

CIRCUITS = {
    "gemm": lambda c: c.kratos_gemm(m=4, n=4, width=5, sparsity=0.5),
    "conv1d": lambda c: c.kratos_conv1d(in_ch=2, out_ch=3, n_pos=2,
                                        width=4),
    "sha": lambda c: c.sha_like(rounds=1),
    "dla-like": lambda c: c.koios_mac_array(pes=2, width=4, ctrl_nodes=40),
}


def both(name):
    p, r = CIRCUITS[name](tcirc), CIRCUITS[name](rcirc)
    assert p.content_digest() == r.content_digest()
    return p, r


def random_netlist(cls, seed: int):
    """LUT cloud + carry chains + post-chain logic, sized for fast packs
    (the generator of tests/core/test_equiv.py, for either package)."""
    rng = random.Random(seed)
    net = cls(f"rand{seed}")
    pool = list(net.add_pi_bus("in", rng.randint(8, 16)))
    for _ in range(rng.randint(10, 35)):
        k = rng.randint(1, 6)
        ins = rng.sample(pool, min(k, len(pool)))
        o = net.add_lut(tuple(ins), rng.getrandbits(1 << len(ins)))
        pool.append(o)
    for c in range(rng.randint(1, 4)):
        w = rng.randint(2, 12)
        a = [rng.choice(pool) for _ in range(w)]
        b = [rng.choice(pool) for _ in range(w)]
        cin = rng.choice([0, 1, rng.choice(pool)])
        sums, cout = net.add_chain(a, b, cin=cin,
                                   want_cout=rng.random() < 0.5)
        pool.extend(sums)
        net.set_po_bus(f"s{c}", sums)
        if cout is not None:
            net.set_po_bus(f"c{c}", [cout])
    for i in range(rng.randint(5, 15)):
        k = rng.randint(2, 5)
        ins = rng.sample(pool, min(k, len(pool)))
        pool.append(net.add_lut(tuple(ins), rng.getrandbits(1 << len(ins))))
    net.set_po_bus("po", pool[-min(8, len(pool)):])
    return net.sweep()


def random_pair(seed):
    p, r = random_netlist(Netlist, seed), random_netlist(RNetlist, seed)
    assert p.content_digest() == r.content_digest()
    return p, r


def wide_chain_pair(n_bits=4, n_pis=12, seed=0):
    """A chain whose operands are fanout-2 4-LUTs (no absorption), so every
    bit's composed cone support exceeds 6 inputs (test_equiv.py's)."""
    def build(cls):
        rng = random.Random(seed)
        net = cls("wide")
        ins = net.add_pi_bus("in", n_pis)
        a_ops, b_ops = [], []
        for i in range(n_bits):
            la = net.add_lut(tuple(rng.sample(ins, 4)), rng.getrandbits(16))
            lb = net.add_lut(tuple(rng.sample(ins, 4)), rng.getrandbits(16))
            a_ops.append(la)
            b_ops.append(lb)
            net.set_po_bus(f"keep{i}", [la, lb])
        sums, cout = net.add_chain(a_ops, b_ops, want_cout=True)
        net.set_po_bus("s", sums)
        net.set_po_bus("c", [cout])
        return net
    return build(Netlist), build(RNetlist)


@pytest.mark.parametrize("name", ["gemm", "conv1d", "sha", "dla-like"])
def test_pack_and_analyze_records_equal_reference(name):
    p, r = both(name)
    for arch in ARCH_NAMES:
        got = tflow.pack_and_analyze(p, arch, seeds=(0, 1))
        want = rflow.pack_and_analyze(r, arch, seeds=(0, 1))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k], (arch, k)


def test_run_circuit_equiv_gate_and_ratios():
    p, r = both("gemm")
    got = tflow.run_circuit(p, ARCH_NAMES, seeds=(0,), check_equiv=True,
                            device=CPU)
    want = rflow.run_circuit(r, ARCH_NAMES, seeds=(0,), check_equiv=True)
    assert got == want
    assert all(rec["equivalent"] for rec in got.values())
    assert tflow.ratios_vs_baseline(got) == rflow.ratios_vs_baseline(want)
    suites = {"k": [p]}
    rows = tflow.run_suites(suites, ARCH_NAMES, seeds=(0,), device=CPU)
    assert rows["k"][0]["per_arch"]["dd5"]["adp"] == want["dd5"]["adp"]


@pytest.mark.parametrize("method", ["auto", "simulate"])
@pytest.mark.parametrize("arch_name", ["baseline", "dd5"])
def test_fused_engine_gate_matches_reference(arch_name, method):
    """The checker's fused path (the counterpart of the reference's
    ``use_jax=True``) proves healthy packs, as the reference does."""
    p, r = both("gemm")
    got = tequiv.check_pack_equivalence(p, ARCHS[arch_name], n_vectors=64,
                                        method=method, use_fused=True,
                                        device=CPU)
    want = requiv.check_pack_equivalence(r, RARCHS[arch_name], n_vectors=64,
                                         method=method, use_jax=True)
    assert got["equivalent"] and want["equivalent"]
    assert got == want


def test_gate_on_corrupted_pack_matches_reference(monkeypatch):
    """``check_pack_equivalence(method="simulate", use_fused=True)`` on a
    pack whose re-elaboration carries a flipped truth-table bit: the
    reference's verdict and its first mismatch."""
    def corrupting(real):
        def reelaborate(packed):
            re_elab = real(packed)
            re_elab.phys.lut_tt[0] ^= 1 << 1
            return re_elab
        return reelaborate

    monkeypatch.setattr(tequiv, "reelaborate",
                        corrupting(tequiv.reelaborate))
    monkeypatch.setattr(requiv, "reelaborate",
                        corrupting(requiv.reelaborate))
    p, r = random_pair(7)
    got = tequiv.check_pack_equivalence(p, DD5, n_vectors=128,
                                        method="simulate", use_fused=True,
                                        device=CPU)
    want = requiv.check_pack_equivalence(r, RARCHS["dd5"], n_vectors=128,
                                         method="simulate", use_jax=True)
    assert not got["equivalent"] and got["mismatches"]
    assert got["mismatches"][0] == want["mismatches"][0]
    assert got == want


def _corrupt(net_p, net_r, arch_name="dd5", seed=0):
    re_p = tequiv.reelaborate(pack(net_p, ARCHS[arch_name], seed=seed))
    re_r = requiv.reelaborate(rpack(net_r, RARCHS[arch_name], seed=seed))
    assert re_p.sig_map == re_r.sig_map
    assert re_p.phys.content_digest() == re_r.phys.content_digest()
    return re_p, re_r


def test_corrupted_truth_table_detected_like_reference():
    """A flipped physical truth-table bit: the same verdict and the same
    first mismatch as the reference, through the fused engine and through
    Python ints."""
    p, r = random_pair(7)
    re_p, re_r = _corrupt(p, r)
    assert tequiv.equivalence_report(p, re_p, n_vectors=128, use_fused=True,
                                     device=CPU)["equivalent"]
    re_p.phys.lut_tt[0] ^= 1 << 1
    re_r.phys.lut_tt[0] ^= 1 << 1
    want = requiv.equivalence_report(r, re_r, n_vectors=128, use_jax=True)
    assert not want["equivalent"] and want["mismatches"]
    for use_fused in (True, False):
        got = tequiv.equivalence_report(p, re_p, n_vectors=128,
                                        use_fused=use_fused, device=CPU)
        assert got == want
    assert requiv.equivalence_report(r, re_r, n_vectors=128,
                                     use_jax=False) == want


def test_symbolic_localization_like_reference():
    p, r = random_pair(7)
    re_p, re_r = _corrupt(p, r)
    re_p.phys.lut_tt[0] ^= 1 << 1
    re_r.phys.lut_tt[0] ^= 1 << 1
    got = tequiv.symbolic_equivalence_report(p, re_p)
    want = requiv.symbolic_equivalence_report(r, re_r)
    assert not got["equivalent"] and got["mismatches"]
    assert got == want
    got = tequiv.equivalence_report(p, re_p, n_vectors=128, use_fused=True,
                                    device=CPU)
    assert got == requiv.equivalence_report(r, re_r, n_vectors=128)


def test_exhaustive_residue_corruption_like_reference():
    p, r = wide_chain_pair(seed=3)
    re_p, re_r = _corrupt(p, r)
    re_p.phys.lut_tt[0] ^= 1
    re_r.phys.lut_tt[0] ^= 1
    residue = [("lut", i) for i in range(p.n_luts)]
    got = tequiv.exhaustive_residue_report(p, re_p, residue, device=CPU)
    want = requiv.exhaustive_residue_report(r, re_r, residue)
    assert got["mismatches"] and got == want


def test_exhaustive_vector_path_on_fused_engine():
    """With a lowered vector threshold the residue cones close through
    the fused evaluator and agree with the Python-int enumeration."""
    p, r = wide_chain_pair(seed=3)
    re_p, _ = _corrupt(p, r)
    residue = [("lut", i) for i in range(p.n_luts)] + [("chain", 0)]
    vec = tequiv.exhaustive_residue_report(p, re_p, residue,
                                           vector_min_support=1, device=CPU)
    ints = tequiv.exhaustive_residue_report(p, re_p, residue)
    assert vec["vector_cones"] > 0 and ints["vector_cones"] == 0
    assert vec["proven_cones"] == ints["proven_cones"] == len(residue)
    re_p.phys.lut_tt[0] ^= 1
    vec = tequiv.exhaustive_residue_report(p, re_p, residue,
                                           vector_min_support=1, device=CPU)
    ints = tequiv.exhaustive_residue_report(p, re_p, residue)
    assert vec["mismatches"] == ints["mismatches"] != []


def test_auto_fused_threshold():
    small, _ = both("gemm")
    assert not tequiv._resolve_use_fused("auto", small, small)
    assert tequiv._resolve_use_fused(True, small, small)
    big = tcirc.kratos_conv1d()
    assert big.n_signals * 2 >= tequiv.VECTOR_SIM_MIN_SIGNALS
    assert tequiv._resolve_use_fused("auto", big, big)


def test_netlist_state_round_trip():
    for name in CIRCUITS:
        p, r = both(name)
        q = netlist_from_state(netlist_state(r))
        assert q.content_digest() == r.content_digest()
        assert q.pack_digest() == r.pack_digest()
        assert q.driver == r.driver
        assert q._lut_cache == r._lut_cache
        assert q._chain_cache == r._chain_cache
        assert netlist_state(q) == netlist_state(p)
    p, r = random_pair(3)
    q = netlist_from_state(netlist_state(r))
    assert tflow.pack_and_analyze(q, DD5, seeds=(0,)) == \
        tflow.pack_and_analyze(p, DD5, seeds=(0,))


def test_oracle_check_sampled_words():
    p, _ = both("sha")
    lanes = tflow.random_lanes(p, 4, seed=2)
    vals = tflow.evaluate_netlist(p, lanes, 4, device=CPU)
    assert tflow.oracle_check(p, lanes, vals, 4)
    assert tflow.oracle_check(p, lanes, vals, 4, words=[0, 3])
    po = next(iter(p.pos.values()))[0]
    vals[po, 3] ^= 1
    assert not tflow.oracle_check(p, lanes, vals, 4, words=[3])
    assert tflow.oracle_check(p, lanes, vals, 4, words=[0, 1])
