"""The port's successive-halving search against the JAX package's, on the
CPU: rungs, survivors, frontier and winner identical, the winners
verified, and the search's caches in the registry ``clear_caches()``
drops."""
import copy

import pytest

from repro.core import flow as rflow
from repro.core import search as rsearch
from repro.core.alm import arch_grid as rarch_grid
from repro.core.alm import full_arch_grid as rfull_arch_grid
from repro.core.alm import subgrid as rsubgrid
from repro_torch.core import flow as tflow
from repro_torch.core import search as tsearch
from repro_torch.core.alm import arch_grid, full_arch_grid, subgrid
from repro_torch.core.plan import cache_stats, clear_caches

from test_torch_place import WIRE_PROFILES
from test_torch_sweep import pairs

CPU = "cpu"

#: five small circuits: the reference sweep tests' random seeds and gemm
FIVE = ("rand2", "rand3", "rand5", "rand11", "gemm")


def _stable(payload: dict) -> dict:
    """The deterministic part of a search payload (walls dropped)."""
    p = copy.deepcopy(payload)
    for r in p["rungs"]:
        r.pop("walls")
    return p


def _geometry_grid():
    """The cluster-geometry grid ``arch_grid(alms_per_lb=(8, 10),
    lb_inputs=(48, 60))``: 28 points, 28 structural classes."""
    axes = {"alms_per_lb": (8, 10), "lb_inputs": (48, 60)}
    return arch_grid(**axes), rarch_grid(**axes)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("allocation", ["halving", "bandit"])
def test_search_equals_reference(backend, allocation):
    """Same rung schedule, circuit subsets, survivors, frontier, Pareto
    front and winner as the reference's numpy search, and the winners
    pass oracle parity and pack equivalence."""
    nets, rnets = pairs(FIVE)
    grid, rgrid = _geometry_grid()
    res = tsearch.search_archs(nets, grid, baseline="b0", backend=backend,
                               allocation=allocation, packs={},
                               programs={}, device=CPU)
    ref = rsearch.search_archs(rnets, rgrid, baseline="b0",
                               backend="numpy", allocation=allocation,
                               packs={}, programs={})
    assert len(res.rungs) > 1
    assert res.survivor_trajectory() == ref.survivor_trajectory()
    assert _stable(res.payload()) == _stable(ref.payload())
    assert res.final.records == ref.final.records
    for rung in res.rungs:
        assert set(rung["walls"]) == set(ref.rungs[0]["walls"])
    rep = tsearch.verify_winners(res, nets, grid, device=CPU)
    assert rep == rsearch.verify_winners(ref, rnets, rgrid)
    assert rep["oracle_match"] and rep["equivalent"]


@pytest.mark.parametrize("budget_factor", [2, 3, 12])
def test_search_budget_ledger_equals_reference(budget_factor):
    """Rungs trimmed to a budget of ``budget_factor`` evaluations per
    grid point: the same ledger and payload as the reference."""
    nets, rnets = pairs(FIVE)
    grid = subgrid(full_arch_grid(), 12)
    rgrid = rsubgrid(rfull_arch_grid(), 12)
    assert [a.name for a in grid] == [a.name for a in rgrid]
    budget = len(grid) * budget_factor
    kw = dict(min_survivors=3, min_circuits=2, baseline="b0",
              budget=budget, packs={}, programs={})
    res = tsearch.search_archs(nets, grid, backend="torch", device=CPU, **kw)
    ref = rsearch.search_archs(rnets, rgrid, backend="numpy", **kw)
    assert res.budget == ref.budget
    assert res.budget["used"] <= budget
    assert _stable(res.payload()) == _stable(ref.payload())
    with pytest.raises(ValueError, match="budget"):
        tsearch.search_archs(nets, grid, min_circuits=2, baseline="b0",
                             budget=1, packs={}, programs={}, device=CPU)


def test_placed_search_equals_reference():
    """A placed search over the wire-delay axis: the same rungs and
    winner as the reference, the winner placed-oracle-parity-gated."""
    nets, rnets = pairs(FIVE[:3])
    axes = dict(bypass_inputs=(0, 2), addmux_fanin=(10,), lut6=(False,),
                wire_delays=WIRE_PROFILES)
    grid, rgrid = arch_grid(**axes), rarch_grid(**axes)
    kw = dict(eta=2, min_survivors=2, min_circuits=2, baseline="b0",
              place=True, packs={}, programs={})
    res = tsearch.search_archs(nets, grid, backend="torch", device=CPU, **kw)
    ref = rsearch.search_archs(rnets, rgrid, backend="numpy", **kw)
    assert _stable(res.payload()) == _stable(ref.payload())
    rep = tsearch.verify_winners(res, nets, grid, place=True, device=CPU,
                                 n_equiv_circuits=1)
    assert rep["oracle_match"] and rep["equivalent"]


def test_flow_search_design_space_equals_reference():
    """``flow.search_design_space`` forwards the backend and the device,
    takes ``b0`` as the baseline and attaches the verification report."""
    nets, rnets = pairs(FIVE)
    grid, rgrid = _geometry_grid()
    res = tflow.search_design_space(nets, archs=grid, backend="torch",
                                    verify=True, device=CPU, packs={},
                                    programs={})
    ref = rflow.search_design_space(rnets, archs=rgrid, backend="numpy",
                                    verify=True, packs={}, programs={})
    assert res.baseline == "b0"
    assert _stable(res.payload()) == _stable(ref.payload())
    assert res.verify == ref.verify and res.verify["equivalent"]


@pytest.mark.parametrize("allocation", ["halving", "bandit"])
@pytest.mark.parametrize("n_circuits", [1, 3, 10])
def test_survivor_selection_equals_reference(allocation, n_circuits):
    rows = [{"arch": f"a{i}", "area_mwta": 1.0 + 0.1 * (i % 4),
             "critical_path_ps": 1.0 + 0.07 * ((7 * i) % 5),
             "adp": (1.0 + 0.1 * (i % 4)) * (1.0 + 0.07 * ((7 * i) % 5))}
            for i in range(12)]
    assert tsearch.pareto_front(rows) == rsearch.pareto_front(rows)
    for k in (1, 3, 8):
        assert tsearch.select_survivors(rows, k, allocation, n_circuits) \
            == rsearch.select_survivors(rows, k, allocation, n_circuits)
    nets, rnets = pairs(FIVE)
    for n_rungs in (1, 2, 4):
        got = tsearch.circuit_schedule(nets, n_rungs, min(n_circuits, 5))
        want = rsearch.circuit_schedule(rnets, n_rungs, min(n_circuits, 5))
        assert [[n.name for n in s] for s in got] == \
            [[n.name for n in s] for s in want]


def test_search_caches_hold_device_programs_and_clear():
    """The default stores: ``search_programs`` holds the torch programs
    (device tensors) beside ``search_packs``; one ``clear_caches()``
    drops both, and a rebuilt search is identical in value."""
    nets, _ = pairs(FIVE[:3])
    grid = subgrid(full_arch_grid(), 8)
    clear_caches()
    first = tsearch.search_archs(nets, grid, min_survivors=3,
                                 min_circuits=2, baseline="b0",
                                 backend="torch", device=CPU)
    stats = cache_stats()
    assert stats["search_programs"]["size"] > 0
    assert stats["search_packs"]["size"] > 0
    clear_caches()
    stats = cache_stats()
    assert stats["search_programs"]["size"] == 0
    assert stats["search_packs"]["size"] == 0
    again = tsearch.search_archs(nets, grid, min_survivors=3,
                                 min_circuits=2, baseline="b0",
                                 backend="torch", device=CPU)
    assert _stable(first.payload()) == _stable(again.payload())
    assert cache_stats()["search_programs"]["size"] > 0
    clear_caches()
