"""The port's placer, annealer and placed sweep against the JAX package's
canonical numpy ones, on the CPU: placements equal element by element,
placed critical paths equal bit for bit, and every new cache in the one
registry that ``clear_caches()`` drops."""
import numpy as np
import pytest

from repro.core.alm import ARCHS as RARCHS
from repro.core.alm import arch_grid as rarch_grid
from repro.core.alm import make_arch as rmake_arch
from repro.core.anneal import criticality_weights as rcriticality_weights
from repro.core.anneal import edge_criticality as redge_criticality
from repro.core.packing import pack as rpack
from repro.core.place import channel_congestion as rchannel_congestion
from repro.core.place import place_and_apply as rplace_and_apply
from repro.core.place import placement_for as rplacement_for
from repro.core.sweep import sweep_suite as rsweep_suite
from repro.core.timing import analyze_placed_oracle as ranalyze_placed
from repro_torch.core import timing_vec as ttv
from repro_torch.core.alm import ARCHS, arch_grid, make_arch
from repro_torch.core.anneal import (ANNEAL_COUNTS, criticality_weights,
                                     edge_criticality, refine_placement)
from repro_torch.core.circuit_ir import apply_placement
from repro_torch.core.packing import pack
from repro_torch.core.place import (PLACE_COUNTS, channel_congestion,
                                    place_and_apply, place_ir,
                                    placement_for)
from repro_torch.core.plan import cache_stats, clear_caches
from repro_torch.core.sweep import oracle_parity, sweep_suite

from test_torch_sweep import circuit_pair, pairs

CPU = "cpu"

#: the wire-tier profiles of the placed sweep (ps): zero, and the
#: apicula-like hierarchy the placed benchmarks use
WIRE_PROFILES = ((0.0, 0.0, 0.0), (25.0, 40.0, 120.0))


def wired(make, arch, w1=25.0, w2=40.0, wl=120.0):
    return make(arch.name + "_wired", bypass_inputs=arch.bypass_inputs,
                addmux_fanin=arch.addmux_fanin, lut6=arch.concurrent_6lut,
                t_wire_hop1=w1, t_wire_hop2=w2, t_wire_long=wl)


def _same_placement(a, b):
    assert (a.grid_w, a.grid_h, a.seed, a.net_digest, a.placement_key,
            a.refine) == (b.grid_w, b.grid_h, b.seed, b.net_digest,
                          b.placement_key, b.refine)
    assert a.lb_x.dtype == b.lb_x.dtype and np.array_equal(a.lb_x, b.lb_x)
    assert a.lb_y.dtype == b.lb_y.dtype and np.array_equal(a.lb_y, b.lb_y)


@pytest.mark.parametrize("refine", [None, "anneal", "anneal_timing"])
@pytest.mark.parametrize("name", ["rand2", "rand6", "gemm", "sha"])
@pytest.mark.parametrize("arch_name", ["baseline", "dd5"])
def test_placement_equals_reference(name, arch_name, refine):
    """Analytic and annealed placements equal the reference's
    ``placement_for(..., backend="numpy")`` element by element."""
    net, rnet = circuit_pair(name)
    arch, rarch = ARCHS[arch_name], RARCHS[arch_name]
    ir = pack(net, arch, seed=0).lower_ir()
    rir = rpack(rnet, rarch, seed=0).lower_ir()
    got = placement_for(ir, arch, seed=1, refine=refine, cache=False)
    want = rplacement_for(rir, rarch, seed=1, refine=refine, cache=False,
                          backend="numpy")
    _same_placement(got, want)
    placed = apply_placement(ir, got)
    for col in ("sig_x", "sig_y"):
        assert np.array_equal(getattr(placed, col),
                              getattr(apply_placement(rir, want), col))


@pytest.mark.parametrize("name", ["rand6", "gemm"])
def test_criticality_equals_reference(name):
    net, rnet = circuit_pair(name)
    arch, rarch = ARCHS["dd5"], RARCHS["dd5"]
    ir = pack(net, arch).lower_ir()
    rir = rpack(rnet, rarch).lower_ir()
    assert np.array_equal(edge_criticality(ir, arch),
                          redge_criticality(rir, rarch))
    assert np.array_equal(criticality_weights(ir, arch, cache=False),
                          rcriticality_weights(rir, rarch, cache=False))


@pytest.mark.parametrize("name", ["rand6", "gemm"])
def test_channel_congestion_equals_reference(name):
    net, rnet = circuit_pair(name)
    arch, rarch = ARCHS["dd5"], RARCHS["dd5"]
    got = channel_congestion(place_and_apply(pack(net, arch).lower_ir(),
                                             arch, seed=0, cache=False),
                             arch=arch)
    want = rchannel_congestion(rplace_and_apply(
        rpack(rnet, rarch).lower_ir(), rarch, seed=0, cache=False),
        arch=rarch)
    assert set(got) == set(want)
    for k, v in got.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, want[k])
        else:
            assert v == want[k]


@pytest.mark.parametrize("refine", ["anneal", None])
@pytest.mark.parametrize("name", ["rand6", "gemm"])
def test_placed_program_matches_placed_oracle(name, refine):
    """The torch program on placed IRs, at zero and nonzero wire delays,
    equals the reference's placed oracle under the same placement."""
    net, rnet = circuit_pair(name)
    for arch, rarch in ((ARCHS["dd5"], RARCHS["dd5"]),
                        (wired(make_arch, ARCHS["dd5"]),
                         wired(rmake_arch, RARCHS["dd5"]))):
        p, rp = pack(net, arch, seed=0), rpack(rnet, rarch, seed=0)
        pl = placement_for(p.lower_ir(), arch, 0, refine=refine)
        rpl = rplacement_for(rp.lower_ir(), rarch, 0, refine=refine)
        _same_placement(pl, rpl)
        rec = ttv.analyze_ir(apply_placement(p.lower_ir(), pl), arch,
                             backend="torch", device=CPU)
        assert rec["critical_path_ps"] == \
            ranalyze_placed(rp, rpl)["critical_path_ps"]


@pytest.mark.parametrize("refine", ["anneal", None])
def test_placed_sweep_equals_reference(refine):
    """The 14-point placed grid (7 points x 2 wire profiles): records equal
    the reference's numpy placed sweep and the placed oracle; zero-wire
    rows equal the unplaced sweep bit for bit, wired rows are no faster."""
    nets, rnets = pairs(["rand5", "gemm"])
    grid = arch_grid(wire_delays=WIRE_PROFILES)
    rgrid = rarch_grid(wire_delays=WIRE_PROFILES)
    assert len(grid) == 14
    res = sweep_suite(nets, grid, place=True, refine=refine, device=CPU)
    ref = rsweep_suite(rnets, rgrid, backend="numpy", place=True,
                       refine=refine)
    assert res.records == ref.records
    assert oracle_parity(res, nets, grid, place=True, refine=refine)
    flat = sweep_suite(nets, grid, device=CPU)
    for k, arch in enumerate(grid):
        for g in range(len(nets)):
            placed_cp = res.records[g][k]["critical_path_ps"]
            flat_cp = flat.records[g][k]["critical_path_ps"]
            if (arch.t_wire_hop1, arch.t_wire_hop2, arch.t_wire_long) \
                    == (0.0, 0.0, 0.0):
                assert placed_cp == flat_cp
            else:
                assert placed_cp >= flat_cp
    assert res.wall["place_s"] >= res.wall["anneal_s"] >= 0.0


def test_placed_programs_keyed_by_refine_and_device():
    """A program built from analytic placements never serves annealed
    rows: refine and device are both part of the program key."""
    nets = [circuit_pair("gemm")[0]]
    grid = [ARCHS["dd5"], wired(make_arch, ARCHS["dd5"])]
    programs: dict = {}
    a = sweep_suite(nets, grid, place=True, refine=None, programs=programs,
                    device=CPU)
    b = sweep_suite(nets, grid, place=True, refine="anneal",
                    programs=programs, device=CPU)
    assert {(k[-2], k[-1]) for k in programs} == {(None, "cpu"),
                                                  ("anneal", "cpu")}
    assert a.records[0][0] == b.records[0][0]      # zero wire: no change


def test_ensemble_backends_not_ported_yet():
    """The ensembles are ported as ``backend="torch"``: the reference's
    name for them, ``"jax"``, raises ``ValueError`` naming the port's
    (``tests/test_torch_ensembles.py`` holds the torch backend to the
    reference's jax one).  The name is kept from before the port had
    the ensembles, when both backends raised."""
    net, _ = circuit_pair("gemm")
    arch = ARCHS["dd5"]
    ir = pack(net, arch).lower_ir()
    with pytest.raises(ValueError, match="'torch'"):
        place_ir(ir, arch, seed=0, backend="jax")
    with pytest.raises(ValueError, match="unknown placement backend"):
        place_ir(ir, arch, seed=0, backend="bogus")
    seed_pl = place_ir(ir, arch, seed=0)
    with pytest.raises(ValueError, match="'torch'"):
        refine_placement(ir, arch, seed_pl, backend="jax")
    with pytest.raises(ValueError, match="unknown anneal backend"):
        refine_placement(ir, arch, seed_pl, backend="bogus")


def test_placement_caches_in_registry_cleared_with_everything_else():
    """Placements, criticality weights and the placed sweep's device
    programs in the registry: one ``clear_caches()`` drops them all, and
    a re-request re-solves to the same values."""
    from repro_torch.core.search import search_archs

    clear_caches()
    net, _ = circuit_pair("gemm")
    arch = ARCHS["dd5"]
    ir = pack(net, arch).lower_ir()
    n0, c0 = PLACE_COUNTS["analytic"], ANNEAL_COUNTS["crit_solve"]
    a = placement_for(ir, arch, seed=0, refine="anneal_timing")
    assert placement_for(ir, arch, seed=0, refine="anneal_timing") is a
    assert PLACE_COUNTS["analytic"] == n0 + 1
    assert ANNEAL_COUNTS["crit_solve"] == c0 + 1
    grid = [ARCHS["dd5"], wired(make_arch, ARCHS["dd5"])]
    search_archs([net], grid, min_circuits=1, place=True, backend="torch",
                 device=CPU)
    stats = cache_stats()
    for name in ("placement", "criticality", "search_packs",
                 "search_programs", "pack_prefix"):
        assert stats[name]["size"] > 0, name
    clear_caches()
    stats = cache_stats()
    for name in ("placement", "criticality", "search_packs",
                 "search_programs", "pack_prefix"):
        assert stats[name]["size"] == 0, name
    b = placement_for(ir, arch, seed=0, refine="anneal_timing")
    assert b is not a and PLACE_COUNTS["analytic"] == n0 + 3
    _same_placement(a, b)
