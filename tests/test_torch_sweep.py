"""The port's batched timing program and design-space sweep against the
JAX package, on the CPU.

The port's torch program is held to the Python oracle
(``timing.analyze_oracle``), the vectorized ``critical_path_numpy`` and the
reference's ``sweep_suite(backend="numpy")``: every critical path, area and
ADP equal, bit for bit.  The reference's own batched program needs
``jax.experimental.enable_x64``, which jax 0.9.0 moved to
``jax.enable_x64``; under a test-local alias (the ``x64`` fixture) the
port's sweep is also held to the reference's ``backend="jax"`` sweep."""
import random

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import flow as rflow
from repro.core import timing_vec as rtv
from repro.core.alm import ARCHS as RARCHS
from repro.core.alm import DD5 as RDD5
from repro.core.alm import arch_grid as rarch_grid
from repro.core.alm import make_arch as rmake_arch
from repro.core.circuits import kratos_gemm as rkratos_gemm
from repro.core.circuits import sha_like as rsha_like
from repro.core.netlist import Netlist as RNetlist
from repro.core.packing import pack as rpack
from repro.core.plan import bucket_envelopes as rbucket_envelopes
from repro.core.plan import combined_profile as rcombined_profile
from repro.core.plan import segment_levels as rsegment_levels
from repro.core.sweep import sweep_suite as rsweep_suite
from repro.core.timing import analyze_oracle as ranalyze_oracle
from repro_torch.core import flow as tflow
from repro_torch.core import timing_vec as ttv
from repro_torch.core.alm import ARCHS, DD5, arch_grid, make_arch
from repro_torch.core.circuits import kratos_gemm, sha_like
from repro_torch.core.netlist import CONST0, CONST1, Netlist
from repro_torch.core.packing import pack
from repro_torch.core.plan import (bucket_envelopes, combined_profile,
                                   segment_levels)
from repro_torch.core.sweep import oracle_parity, sweep_suite

CPU = "cpu"


def random_netlist(cls, seed: int):
    """LUT cloud + carry chains + post-chain logic, for either package:
    the generator of ``tests/core/test_flow.py`` (the reference's sweep
    tests draw their random circuits from it)."""
    rng = random.Random(seed)
    net = cls(f"rand{seed}")
    pool = list(net.add_pi_bus("in", rng.randint(8, 16)))
    for _ in range(rng.randint(10, 40)):
        k = rng.randint(1, 6)
        ins = rng.sample(pool, min(k, len(pool)))
        pool.append(net.add_lut(tuple(ins), rng.getrandbits(1 << len(ins))))
    for c in range(rng.randint(1, 3)):
        w = rng.randint(2, 10)
        a = [rng.choice(pool) for _ in range(w)]
        b = [rng.choice(pool) for _ in range(w)]
        cin = rng.choice([CONST0, CONST1, rng.choice(pool)])
        sums, cout = net.add_chain(a, b, cin=cin,
                                   want_cout=rng.random() < 0.5)
        pool.extend(sums)
        net.set_po_bus(f"s{c}", sums)
        if cout is not None:
            net.set_po_bus(f"c{c}", [cout])
    for _ in range(rng.randint(5, 15)):
        k = rng.randint(2, 5)
        ins = rng.sample(pool, min(k, len(pool)))
        pool.append(net.add_lut(tuple(ins), rng.getrandbits(1 << len(ins))))
    net.set_po_bus("po", pool[-min(8, len(pool)):])
    return net.sweep()


def circuit_pair(name):
    """``(port netlist, reference netlist)`` of one test circuit, equal by
    content digest: ``rand<seed>`` or the reference tests' ``gemm`` /
    ``sha``."""
    if name.startswith("rand"):
        seed = int(name[4:])
        p, r = random_netlist(Netlist, seed), random_netlist(RNetlist, seed)
    elif name == "gemm":
        p = kratos_gemm(m=4, n=4, width=4, sparsity=0.5)
        r = rkratos_gemm(m=4, n=4, width=4, sparsity=0.5)
    else:
        p, r = sha_like(rounds=1), rsha_like(rounds=1)
    assert p.content_digest() == r.content_digest()
    return p, r


def pairs(names):
    both = [circuit_pair(n) for n in names]
    return [p for p, _ in both], [r for _, r in both]


def same_class_archs():
    """dd5 and a fan-in-20 variant: one structural class, two delay rows
    (the reference's ``test_jax_program_matches_oracle_batched``)."""
    port = [DD5, make_arch("dd5_f20", bypass_inputs=2, addmux_fanin=20,
                           z_sources=40)]
    ref = [RDD5, rmake_arch("dd5_f20", bypass_inputs=2, addmux_fanin=20,
                            z_sources=40)]
    assert port[0].structural_key() == port[1].structural_key()
    return port, ref


PROGRAM_CIRCUITS = ("rand3", "rand11", "gemm")


@pytest.mark.parametrize("max_buckets", [1, 2, 3])
def test_program_matches_oracle_batched(max_buckets):
    """Several circuits stacked, two delay rows of one structural class:
    every (circuit, arch) critical path of the torch program equals the
    reference's Python oracle and the vectorized numpy walk, whether the
    levels run as one bucket or are segmented into several."""
    nets, rnets = pairs(PROGRAM_CIRCUITS)
    archs, rarchs = same_class_archs()
    irs = [pack(n, archs[0], seed=0).lower_ir() for n in nets]
    prog = ttv.build_suite_timing_program(irs, max_buckets=max_buckets,
                                          device=CPU)
    assert 1 <= len(prog.bucket_shapes) <= max_buckets
    cps = prog.run(np.stack([a.delay_table() for a in archs]))
    assert cps.shape == (len(nets), len(archs)) and cps.dtype == np.float64
    for g, (net, rnet) in enumerate(zip(nets, rnets)):
        for k, (arch, rarch) in enumerate(zip(archs, rarchs)):
            want = ranalyze_oracle(rpack(rnet, rarch, seed=0))
            assert cps[g, k] == want["critical_path_ps"], (net.name,
                                                          arch.name)
            comps = ttv.delay_components(arch.delay_table())
            assert cps[g, k] == ttv.critical_path_numpy(irs[g], comps)


def test_member_order_does_not_move_the_bits():
    """A member's critical paths do not depend on which row block it
    occupies or on the envelope its neighbours set."""
    nets, _ = pairs(PROGRAM_CIRCUITS)
    archs, _ = same_class_archs()
    irs = [pack(n, archs[0], seed=0).lower_ir() for n in nets]
    tables = np.stack([a.delay_table() for a in archs])
    fwd = ttv.build_suite_timing_program(irs, device=CPU).run(tables)
    rev = ttv.build_suite_timing_program(irs[::-1], device=CPU).run(tables)
    assert np.array_equal(fwd.view(np.int64), rev[::-1].view(np.int64))


def _bounds_shapes(profile_fns, irs, max_buckets):
    """Bucket bounds and shapes, computed as each package's
    ``build_suite_timing_program`` computes them, from that package's
    planner functions."""
    combined, segment, envelopes = profile_fns
    L = max(ir.n_levels for ir in irs)
    m, c, b = combined([ir.level_profile() for ir in irs], L)
    bounds = segment(m, c, b, max_buckets)
    env = envelopes(m, c, b, bounds)
    shapes = [(max(j - i, 1), max(M, 1), max(C, 1), max(B, 1))
              for (i, j), (M, C, B) in zip(bounds, env)]
    return bounds, shapes


@pytest.mark.parametrize("max_buckets", [1, 3])
def test_padded_layout_equals_reference(max_buckets):
    """The port's copy of ``_pad_levels`` gives the reference's padded
    17-tuples, array by array (hop arrays at 13-16, pads on the sink)."""
    nets, rnets = pairs(PROGRAM_CIRCUITS)
    irs = [pack(n, DD5, seed=0).lower_ir() for n in nets]
    rirs = [rpack(n, RDD5, seed=0).lower_ir() for n in rnets]
    bounds, shapes = _bounds_shapes(
        (combined_profile, segment_levels, bucket_envelopes), irs,
        max_buckets)
    rbounds, rshapes = _bounds_shapes(
        (rcombined_profile, rsegment_levels, rbucket_envelopes), rirs,
        max_buckets)
    assert bounds == rbounds and shapes == rshapes
    sink = max(ir.n_signals for ir in irs)
    for ir, rir in zip(irs, rirs):
        got = ttv._pad_levels(ir, bounds, shapes, sink)
        want = rtv._pad_levels(rir, rbounds, rshapes, sink)
        assert len(got) == len(want)
        for gb, wb in zip(got, want):
            assert len(gb) == len(wb) == 17
            for ga, wa in zip(gb, wb):
                assert ga.dtype == wa.dtype and np.array_equal(ga, wa)
    for s in shapes:
        for ga, wa in zip(ttv._alloc_bucket(*s, sink),
                          rtv._alloc_bucket(*s, sink)):
            assert np.array_equal(ga, wa)


@pytest.mark.parametrize("max_buckets", [1, 3])
def test_no_gather_reads_a_sink(max_buckets):
    """Pad rows all scatter to their member's sink row, where duplicate
    writes land in an arbitrary order on the card; that is harmless only
    because no gather ever reads a sink (pad gathers read signal 0, pad
    PO slots CONST0).  Real scatter targets of a level never repeat."""
    nets, _ = pairs(PROGRAM_CIRCUITS)
    irs = [pack(n, DD5, seed=0).lower_ir() for n in nets]
    prog = ttv.build_suite_timing_program(irs, max_buckets=max_buckets,
                                          device=CPU)
    rows = prog.n_sig + 1
    n_members = prog._po.shape[0]
    sinks_hit = 0
    for bk in prog._tensors:
        for gather in (bk.lut_in, bk.ch_in):
            assert gather.dtype == torch.int64
            assert not bool((gather % rows == prog.n_sig).any())
            assert int(gather.max()) < n_members * rows
        for scatter in (bk.lut_out, bk.sums, bk.cout):
            is_sink = scatter % rows == prog.n_sig
            sinks_hit += int(is_sink.sum())
            for r in range(scatter.shape[0]):
                real = scatter[r][~is_sink[r]]
                assert real.unique().numel() == real.numel()
        assert int(bk.last.max()) < bk.sums.shape[1]
    assert sinks_hit > 0
    assert not bool((prog._po % rows == prog.n_sig).any())


@pytest.mark.parametrize("name", ["rand2", "rand7", "gemm", "sha"])
@pytest.mark.parametrize("arch_name", ["baseline", "dd5", "dd6"])
def test_analyze_ir_torch_equals_numpy(name, arch_name):
    net, _ = circuit_pair(name)
    ir = pack(net, ARCHS[arch_name], seed=0).lower_ir()
    got = ttv.analyze_ir(ir, ARCHS[arch_name], backend="torch", device=CPU)
    assert got == ttv.analyze_ir(ir, ARCHS[arch_name], backend="numpy")


def _sweep_nets():
    """The reference's ``test_sweep_matches_oracle_exactly`` suites."""
    (pa, ra), (pb, rb) = circuit_pair("rand5"), circuit_pair("gemm")
    return {"a": [pa], "b": [pb]}, {"a": [ra], "b": [rb]}


def _sweep_grid(which):
    if which == "triple":
        return ([ARCHS["baseline"], ARCHS["dd5"],
                 make_arch("dd5_f20", bypass_inputs=2, addmux_fanin=20,
                           z_sources=40)],
                [RARCHS["baseline"], RARCHS["dd5"],
                 rmake_arch("dd5_f20", bypass_inputs=2, addmux_fanin=20,
                            z_sources=40)])
    return arch_grid(), rarch_grid()


@pytest.mark.parametrize("grid", ["triple", "default"])
@pytest.mark.parametrize("max_groups", [1, 4])
def test_sweep_records_equal_reference(grid, max_groups):
    """Every record of the torch sweep equals the reference's numpy
    sweep key by key, and the Python oracle at every grid point."""
    nets, rnets = _sweep_nets()
    archs, rarchs = _sweep_grid(grid)
    res = sweep_suite(nets, archs, backend="torch", max_groups=max_groups,
                      device=CPU)
    ref = rsweep_suite(rnets, rarchs, backend="numpy",
                       max_groups=max_groups)
    assert res.records == ref.records
    assert (res.circuits, res.suites, res.archs, res.n_classes) == \
        (ref.circuits, ref.suites, ref.archs, ref.n_classes)
    assert oracle_parity(res, nets, archs)
    assert sweep_suite(nets, archs, backend="numpy").records == ref.records


@pytest.fixture
def x64(monkeypatch):
    """Let the reference's device program find ``enable_x64`` where
    jax < 0.9 kept it, for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def test_sweep_equals_reference_device_program(x64):
    """The port's torch sweep against the reference's own batched device
    program (``backend="jax"``) over the 7-point grid: every critical path
    and area ``==``."""
    nets, rnets = _sweep_nets()
    res = sweep_suite(nets, arch_grid(), backend="torch", device=CPU)
    ref = rsweep_suite(rnets, rarch_grid(), backend="jax")
    assert (res.circuits, res.archs) == (ref.circuits, ref.archs)
    for got, want in zip(res.records, ref.records):
        for g, w in zip(got, want):
            assert (g["arch"], g["critical_path_ps"], g["area_mwta"]) == \
                (w["arch"], w["critical_path_ps"], w["area_mwta"])


def test_flow_sweep_forwards_max_groups():
    """``flow.sweep_architectures`` forwards ``max_groups`` into the
    program key, so it hits a cache warmed by a direct ``sweep_suite``
    (the reference's own test of this cannot run here: its default
    backend is the jax program)."""
    nets, rnets = pairs(["rand4", "rand9"])
    grid = [ARCHS["baseline"], ARCHS["dd5"]]
    progs: dict = {}
    direct = sweep_suite(nets, grid, max_groups=1, programs=progs,
                         device=CPU)
    n = len(progs)
    assert n and all(k[4] == 1 and k[-1] == "cpu" for k in progs)
    via_flow = tflow.sweep_architectures(nets, archs=grid, max_groups=1,
                                         programs=progs, device=CPU)
    assert len(progs) == n
    assert direct.records == via_flow.records
    ref = rflow.sweep_architectures(rnets, archs=[RARCHS["baseline"],
                                                 RARCHS["dd5"]],
                                    max_groups=1, backend="numpy")
    assert via_flow.records == ref.records
    rows = tflow.sweep_frontier(via_flow, baseline="baseline")
    assert rows == rflow.sweep_frontier(ref, baseline="baseline")
    assert len(rows) == 1 and rows[0]["arch"] == "dd5"


@pytest.mark.parametrize("axes", [
    {"bypass_inputs": (2,), "addmux_fanin": (10,), "lut6": (False,),
     "alms_per_lb": (8, 10)},
    {"alms_per_lb": (8, 10), "lb_inputs": (48, 60)}])
def test_flow_sweep_grid_axes(axes):
    nets, rnets = pairs(["rand4", "gemm"])
    res = tflow.sweep_architectures(nets, grid_axes=axes, device=CPU)
    ref = rflow.sweep_architectures(rnets, grid_axes=axes, backend="numpy")
    assert res.archs == ref.archs and res.n_classes == ref.n_classes
    assert res.records == ref.records
    with pytest.raises(ValueError):
        tflow.sweep_architectures(nets, archs=[ARCHS["dd5"]],
                                  grid_axes={"alms_per_lb": (8,)},
                                  device=CPU)


def test_program_and_pack_caches_reused_warm():
    """A warm sweep packs nothing and builds no program; a program built
    for one device key is never served to another."""
    nets = [circuit_pair("rand2")[0], circuit_pair("gemm")[0]]
    grid = [ARCHS["baseline"], ARCHS["dd5"], ARCHS["dd6"]]
    packs, programs = {}, {}
    cold = sweep_suite(nets, grid, packs=packs, programs=programs,
                       device=CPU)
    n_packs, n_progs = len(packs), len(programs)
    built = ttv.read_compile_counts()["programs"]
    warm = sweep_suite(nets, grid, packs=packs, programs=programs,
                       device=CPU)
    assert (len(packs), len(programs)) == (n_packs, n_progs)
    assert ttv.read_compile_counts()["programs"] == built
    assert warm.records == cold.records
    assert {k[-1] for k in programs} == {"cpu"}
    other = sweep_suite(nets, grid, packs=packs, programs=programs,
                        device=torch.device("cpu", 0))
    assert len(programs) == 2 * n_progs
    assert {k[-1] for k in programs} == {"cpu", "cpu:0"}
    assert ttv.read_compile_counts()["programs"] > built
    assert other.records == cold.records
    for key, progs in programs.items():
        for _, prog in progs:
            assert str(prog.device) == key[-1]


def test_program_cache_is_suite_keyed():
    """Reusing a programs cache with a different suite rebuilds instead
    of running another suite's program."""
    (net_a, _), (net_b, rnet_b) = circuit_pair("gemm"), circuit_pair("sha")
    progs: dict = {}
    sweep_suite([net_a], [ARCHS["dd5"]], programs=progs, device=CPU)
    n = len(progs)
    res_b = sweep_suite([net_b], [ARCHS["dd5"]], programs=progs,
                        device=CPU)
    assert len(progs) == 2 * n
    ref_b = rsweep_suite([rnet_b], [RARCHS["dd5"]], backend="numpy")
    assert res_b.records == ref_b.records


def test_sweep_backends():
    nets = [circuit_pair("rand4")[0]]
    with pytest.raises(ValueError, match="torch"):
        sweep_suite(nets, [ARCHS["dd5"]], backend="jax", device=CPU)
    with pytest.raises(ValueError, match="unknown sweep backend"):
        sweep_suite(nets, [ARCHS["dd5"]], backend="tpu", device=CPU)
    with pytest.raises(ValueError, match="unknown timing backend"):
        ttv.analyze_ir(pack(nets[0], DD5).lower_ir(), DD5, backend="jax")
