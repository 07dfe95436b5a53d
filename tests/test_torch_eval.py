"""The port's evaluator (``repro_torch.core.eval_torch``) against the JAX
package's (``repro.core.eval_jax``) and the Python oracle, on the CPU:
plan arrays equal, and fused, grouped and per-level lanes equal."""
import random

import numpy as np
import pytest
import torch

from repro.core import circuits as rcirc
from repro.core import eval_jax as rev
from repro.core import flow as rflow
from repro.core import stress as rstress
from repro.core.netlist import eval_netlist as ref_eval_netlist
from repro_torch.core import circuits as tcirc
from repro_torch.core import eval_torch as tev
from repro_torch.core import flow as tflow
from repro_torch.core import stress as tstress
from repro_torch.core.netlist import CONST0, Netlist, eval_netlist

CPU = "cpu"

#: small circuits built identically by both packages' generators
CIRCUITS = {
    "dla-like": lambda c: c.koios_mac_array(pes=2, width=4, ctrl_nodes=40),
    "sha-like": lambda c: c.sha_like(name="sha-like", rounds=1),
    "or1200-like": lambda c: c.vtr_mixed(logic_nodes=120),
    "gemm": lambda c: c.kratos_gemm(m=4, n=4, width=5, sparsity=0.4),
}


def both(name):
    p, r = CIRCUITS[name](tcirc), CIRCUITS[name](rcirc)
    assert p.content_digest() == r.content_digest()
    return p, r


def stress_pair():
    kw = dict(n_adders=40, n_luts=40, seed=0, depth=3)
    p = tstress.packing_stress_circuit(**kw)
    r = rstress.packing_stress_circuit(**kw)
    assert p.content_digest() == r.content_digest()
    return p, r


def lanes_for(net, n_words, seed):
    return tflow.random_lanes(net, n_words, seed=seed)


def assert_plans_equal(p, r):
    assert (p.n_signals, p.n_levels, p.real_luts, p.real_chain_bits) == \
        (r.n_signals, r.n_levels, r.real_luts, r.real_chain_bits)
    assert p.flags == r.flags and p.envelope == r.envelope
    assert len(p.buckets) == len(r.buckets)
    for bp, br in zip(p.buckets, r.buckets):
        assert bp.shape == br.shape
        for ap, ar in zip(bp.arrays(), br.arrays()):
            assert ap.dtype == ar.dtype and np.array_equal(ap, ar)


@pytest.mark.parametrize("max_buckets", [1, 3])
def test_plan_arrays_equal_reference(max_buckets):
    nets_p = tcirc.kratos_suite(scale=0.2) + tcirc.vtr_suite(scale=0.3)
    nets_r = rcirc.kratos_suite(scale=0.2) + rcirc.vtr_suite(scale=0.3)
    for p, r in zip(nets_p, nets_r):
        assert p.content_digest() == r.content_digest()
        assert_plans_equal(tev.plan_netlist(p, max_buckets=max_buckets),
                           rev.plan_netlist(r, max_buckets=max_buckets))


def test_group_layouts_equal_reference():
    nets_p = tcirc.koios_suite(scale=0.3) + tcirc.vtr_suite(scale=0.3)
    nets_r = rcirc.koios_suite(scale=0.3) + rcirc.vtr_suite(scale=0.3)
    plans_p = [tev.plan_netlist(n) for n in nets_p]
    plans_r = [rev.plan_netlist(n) for n in nets_r]
    groups = tev.group_plans_by_envelope(plans_p, max_groups=3)
    assert groups == rev.group_plans_by_envelope(plans_r, max_groups=3)
    assert tev.grouping_padded_value_rows(plans_p, groups) == \
        rev.grouping_padded_value_rows(plans_r, groups)
    for g in groups:
        prog = tev.get_group_program([nets_p[i] for i in g])
        n_sig, _, flags, members_r = rev.get_group_program(
            [nets_r[i] for i in g])
        assert prog.n_signals == n_sig and prog.flags == flags
        for mp, mr in zip(prog.member_plans, members_r):
            assert_plans_equal(mp, mr)
        irs = [n.lower_ir() for n in (nets_p[i] for i in g)]
        irs_r = [n.lower_ir() for n in (nets_r[i] for i in g)]
        assert tev.group_layout(irs) == rev.group_layout(irs_r)


def oracle_vals(net, lanes, n_words):
    """Every signal's lanes from the Python oracle (one call per word)."""
    out = np.zeros((net.n_signals, n_words), dtype=np.uint32)
    for w in range(n_words):
        vals = eval_netlist(net, {s: int(v[w]) for s, v in lanes.items()},
                            32)
        for s, v in vals.items():
            out[s, w] = v & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("name", ["dla-like", "sha-like", "or1200-like",
                                  "gemm", "stress-d3"])
def test_evaluators_match_oracle_and_reference(name):
    p, r = stress_pair() if name == "stress-d3" else both(name)
    NW = 3
    lanes = lanes_for(p, NW, seed=7)
    want = oracle_vals(p, lanes, NW)
    ref_jax = np.asarray(rev.eval_netlist_jax(r, lanes, NW,
                                              use_pallas=False))
    assert np.array_equal(ref_jax, want)
    fused = tev.eval_netlist_fused(p, lanes, NW, device=CPU)
    assert fused.dtype == np.uint32 and fused.shape == (p.n_signals, NW)
    assert np.array_equal(fused, want)
    levels = tev.eval_netlist_levels(p, lanes, NW, device=CPU)
    assert np.array_equal(levels, want)
    grouped = tev.eval_netlists_batched([p, p], [lanes, lanes], NW,
                                        device=CPU)
    assert all(np.array_equal(g, want) for g in grouped)


def test_fused_matches_reference_with_pallas_interpret():
    """Where the reference reaches its Pallas kernel (interpret mode on
    the CPU) the port still agrees."""
    p, r = both("gemm")
    lanes = lanes_for(p, 2, seed=3)
    want = np.asarray(rev.eval_netlist_jax(r, lanes, 2, use_pallas=True))
    assert np.array_equal(tev.eval_netlist_fused(p, lanes, 2, device=CPU),
                          want)


def test_chain_cout_after_padded_tail():
    """Two chains on one level padded to the wider one's width: the short
    chain's cout is the carry after its last real bit, not after the
    padded tail (which adds 0 + 0 and would clear it)."""
    net = Netlist("pad-tail")
    a = net.add_pi_bus("a", 6)
    b = net.add_pi_bus("b", 6)
    s_long, c_long = net.add_chain(a, b, want_cout=True)
    s_short, c_short = net.add_chain(a[:2], b[:2], want_cout=True)
    net.set_po_bus("sl", s_long + [c_long])
    net.set_po_bus("ss", s_short + [c_short])
    plan = tev.plan_netlist(net)
    assert plan.envelope[2:] == (2, 6)   # both chains share one level
    # all-ones operands: the short chain's carry out is 1 in every vector
    lanes = {s: np.full(2, 0xFFFFFFFF, dtype=np.uint32) for s in net.pis}
    vals = tev.eval_netlist_fused(net, lanes, 2, plan=plan, device=CPU)
    assert (vals[c_short] == 0xFFFFFFFF).all()
    rng = random.Random(0)
    lanes = {s: np.array([rng.getrandbits(32) for _ in range(2)],
                         dtype=np.uint32) for s in net.pis}
    vals = tev.eval_netlist_fused(net, lanes, 2, device=CPU)
    assert np.array_equal(vals, oracle_vals(net, lanes, 2))


def test_constant_chain_inputs_and_empty_levels():
    """A chain fed by constants and a LUT-free circuit evaluate right."""
    net = Netlist("consts")
    a = net.add_pi_bus("a", 3)
    sums, cout = net.add_chain(a, [CONST0] * 3, cin=1, want_cout=True)
    net.set_po_bus("s", sums + [cout])
    lanes = lanes_for(net, 2, seed=1)
    vals = tev.eval_netlist_fused(net, lanes, 2, device=CPU)
    assert np.array_equal(vals, oracle_vals(net, lanes, 2))
    assert np.array_equal(tev.eval_netlist_levels(net, lanes, 2, device=CPU),
                          vals)


@pytest.mark.parametrize("max_groups", [1, 2, 4])
def test_evaluate_suite_grouped_equals_per_circuit(max_groups):
    nets = tcirc.koios_suite(scale=0.3)[:2] + tcirc.vtr_suite(scale=0.3)[:3]
    NW = 2
    lanes = [lanes_for(n, NW, seed=i) for i, n in enumerate(nets)]
    g, gs = tflow.evaluate_suite(nets, lanes, NW, mode="grouped",
                                 max_groups=max_groups, device=CPU)
    pc, ps = tflow.evaluate_suite(nets, lanes, NW, mode="per_circuit",
                                  device=CPU)
    assert gs["mode"] == "grouped" and ps["mode"] == "per_circuit"
    assert gs["n_groups"] <= max_groups
    for net, ln, a, b in zip(nets, lanes, g, pc):
        assert np.array_equal(a, b)
        assert np.array_equal(a, oracle_vals(net, ln, NW))
    prog = tflow.prepare_suite(nets, max_groups=max_groups, device=CPU)
    again, st = tflow.evaluate_suite(nets, lanes, NW, program=prog)
    assert st["mode"] == "grouped"
    assert all(np.array_equal(a, b) for a, b in zip(again, g))


def test_suite_stats_equal_reference():
    nets = tcirc.vtr_suite(scale=0.3)
    nets_r = rcirc.vtr_suite(scale=0.3)
    prog = tev.prepare_suite_program(nets, max_groups=2, device=CPU)
    prog_r = rev.prepare_suite_program(nets_r, max_groups=2)
    assert prog.stats == prog_r.stats
    assert prog.groups == prog_r.groups


def test_cost_model_backend_from_device():
    nets = tcirc.vtr_suite(scale=0.3)
    m = tflow.eval_mode_cost_model(nets, device=CPU)
    assert m["backend"] == "cpu" and not m["parallel"]
    assert m["pick"] in ("grouped", "per_circuit")
    assert m["cost_grouped"] == (m["padded_rows_grouped"]
                                 + m["dispatch_row_cost"]
                                 * m["n_programs_grouped"])
    # the serial padded volume matches the reference's cpu model
    ref = rflow.eval_mode_cost_model(rcirc.vtr_suite(scale=0.3),
                                     backend="cpu", warm=True)
    assert m["padded_rows_grouped"] == ref["padded_rows_grouped"]
    assert m["padded_rows_per_circuit"] == ref["padded_rows_per_circuit"]
    assert m["pick"] == ref["pick"]


def _assert_level_reads_no_output(ins: np.ndarray, out: np.ndarray,
                                  sinks: set, where: str):
    """No pin of the level reads a row the level writes, nor any sink:
    what makes the level kernel's in-place reads and writes sound."""
    real_out = set(out.tolist()) - sinks
    read = set(ins.flatten().tolist())
    assert not read & real_out, where
    assert not read & sinks, where


def test_plan_levels_never_read_their_own_outputs():
    """For every bucket level of the 17 suite circuits (scale 0.3), on
    their own and in their grouped layouts, no ``lut_ins`` index equals
    one of that level's real ``lut_out`` rows or a sink."""
    nets = tcirc.kratos_suite(scale=0.3) + tcirc.koios_suite(scale=0.3) + \
        tcirc.vtr_suite(scale=0.3)
    assert len(nets) == 17
    plans = [tev.plan_netlist(n) for n in nets]
    for net, plan in zip(nets, plans):
        for b, bk in enumerate(plan.buckets):
            if not bk.has_luts:
                continue
            for r in range(bk.n_levels):
                _assert_level_reads_no_output(
                    bk.lut_ins[r], bk.lut_out[r], {plan.sink},
                    f"{net.name} bucket {b} level {r}")
    for members in tev.group_plans_by_envelope(plans):
        prog = tev.get_group_program([nets[i] for i in members])
        rows = prog.n_signals + 1
        sinks = {g * rows + prog.n_signals for g in range(len(members))}
        for b, dbk in enumerate(prog.device_buckets(torch.device(CPU))):
            if not dbk.has_luts:
                continue
            for r in range(dbk.n_levels):
                _assert_level_reads_no_output(
                    dbk.lut_ins[r].numpy(), dbk.lut_out[r].numpy(), sinks,
                    f"group {members} bucket {b} level {r}")


def test_device_built_value_buffer_equals_numpy():
    """``_init_vals`` builds on the device what the numpy construction it
    replaced built on the host: CONST1 rows all-ones, PI rows from the
    lanes, every other row 0, per member."""
    nets = [both(n)[0] for n in ("dla-like", "gemm", "sha-like")]
    NW, rows = 3, max(n.n_signals for n in nets) + 1
    lanes = [lanes_for(n, NW, seed=i) for i, n in enumerate(nets)]
    want = np.zeros((len(nets), rows, NW), dtype=np.uint32)
    want[:, 1] = 0xFFFFFFFF   # CONST1
    for g, ln in enumerate(lanes):
        for s, v in ln.items():
            want[g, s] = v
    got = tev._init_vals(len(nets), rows, lanes, NW, torch.device(CPU))
    assert got.dtype == torch.int32 and got.shape == (len(nets) * rows, NW)
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.reshape(-1, NW))


def test_suite_runs_do_not_alias():
    """Two successive ``SuiteProgram.run`` calls return arrays that do not
    share memory: the first result is unchanged after the second."""
    nets = tcirc.vtr_suite(scale=0.3)[:3]
    NW = 2
    prog = tev.prepare_suite_program(nets, max_groups=2, device=CPU)
    first = prog.run([lanes_for(n, NW, seed=i) for i, n in enumerate(nets)],
                     NW)
    kept = [a.copy() for a in first]
    second = prog.run([lanes_for(n, NW, seed=10 + i)
                       for i, n in enumerate(nets)], NW)
    for a, k, b in zip(first, kept, second):
        assert np.array_equal(a, k)
        assert not np.shares_memory(a, b)
        assert not np.array_equal(a, b)
