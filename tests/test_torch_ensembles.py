"""The port's ensemble placer and multi-chain annealer (``backend="torch"``)
against the JAX package's ensembles (``backend="jax"``), on the CPU.

The reference's device programs need ``jax.experimental.enable_x64``,
which jax 0.9.0 moved to ``jax.enable_x64``; the ``x64`` fixture aliases
the old name for one test at a time (a function-scoped ``monkeypatch``,
so no other test sees it).  Each chain of either ensemble is the
canonical numpy chain seeded with ``anneal._rng(..., chain=ch)``, so the
port is also held to that numpy chain run chain by chain."""
import functools

import jax
import jax.experimental
import numpy as np
import pytest

from repro.core import anneal as ranneal
from repro.core import place as rplace
from repro.core.alm import ARCHS as RARCHS
from repro.core.alm import make_arch as rmake_arch
from repro.core.circuits import kratos_suite as rkratos_suite
from repro.core.circuits import vtr_mixed as rvtr_mixed
from repro.core.packing import pack as rpack
from repro.core.timing import analyze_placed_oracle as ranalyze_placed
from repro_torch.core import anneal, place
from repro_torch.core import timing_vec as ttv
from repro_torch.core.alm import ARCHS, make_arch
from repro_torch.core.circuit_ir import apply_placement
from repro_torch.core.circuits import kratos_suite, vtr_mixed
from repro_torch.core.packing import pack
from repro_torch.core.timing import analyze_placed_oracle

CPU = "cpu"
CHAINS = 3
#: Kratos at scale 0.3: 71 and 18 LBs under dd5
CIRCUITS = ("conv1d-fu", "conv1d-pw-fu")


@pytest.fixture
def x64(monkeypatch):
    """Let the reference's device programs find ``enable_x64`` where
    jax < 0.9 kept it, for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


@functools.lru_cache(maxsize=None)
def _suites():
    return ({n.name: n for n in kratos_suite(scale=0.3, seed=0)},
            {n.name: n for n in rkratos_suite(scale=0.3, seed=0)})


def _irs(name, arch_name="dd5"):
    """``(port IR, reference IR, port arch, reference arch)``."""
    port, ref = _suites()
    net, rnet = port[name], ref[name]
    assert net.content_digest() == rnet.content_digest()
    arch, rarch = ARCHS[arch_name], RARCHS[arch_name]
    return (pack(net, arch).lower_ir(), rpack(rnet, rarch).lower_ir(),
            arch, rarch)


def _same(a, b):
    assert (a.grid_w, a.grid_h, a.seed, a.net_digest, a.placement_key,
            a.refine) == (b.grid_w, b.grid_h, b.seed, b.net_digest,
                          b.placement_key, b.refine)
    assert np.array_equal(a.lb_x, b.lb_x) and np.array_equal(a.lb_y, b.lb_y)


def _legal(pl, n_lbs):
    assert pl.grid_w * pl.grid_h >= n_lbs
    assert (pl.lb_x >= 0).all() and (pl.lb_x < pl.grid_w).all()
    assert (pl.lb_y >= 0).all() and (pl.lb_y < pl.grid_h).all()
    assert len(set(zip(pl.lb_x.tolist(), pl.lb_y.tolist()))) == n_lbs


def _costs_agree(got, want, mode):
    if mode == "anneal":   # integer weights: exact in any summation order
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _reference_chains(rir, rarch, seed_pl, mode, seed=0):
    """The reference's jax ensemble on the reference's own inputs."""
    src, dst = rplace._routed_edges(rir)
    w = (ranneal.criticality_weights(rir, rarch) if mode == "anneal_timing"
         else np.ones(src.size))
    L = seed_pl.n_lbs
    ptr, nbr, wts = ranneal._adjacency(L, src, dst, w)
    return ranneal._anneal_chains_jax(
        ptr, nbr, wts, src, dst, w, seed_pl.lb_x.astype(np.int64),
        seed_pl.lb_y.astype(np.int64), seed_pl.grid_w, seed_pl.grid_h,
        seed_pl.net_digest, seed_pl.placement_key, seed,
        ranneal._default_steps(L), ranneal._default_moves(L),
        ranneal._DEF_T_FINAL, CHAINS)


@pytest.mark.parametrize("mode", ["anneal", "anneal_timing"])
@pytest.mark.parametrize("name", CIRCUITS)
def test_chains_equal_reference_ensemble_and_numpy_chains(x64, monkeypatch,
                                                          name, mode):
    """Chain by chain, the torch ensemble's best snapshots are the
    reference jax ensemble's and the numpy chain's with ``_rng(chain=ch)``:
    placements identical, costs ``==`` (anneal) or within 1e-12 relative
    (anneal_timing, where the float64 sums' order differs)."""
    monkeypatch.setattr(anneal, "CHAINS", CHAINS)
    ir, rir, arch, rarch = _irs(name)
    seed_pl = place.place_ir(ir, arch, seed=0)
    rseed_pl = rplace.place_ir(rir, rarch, seed=0)
    _same(seed_pl, rseed_pl)
    bc, bx, by = anneal._ensemble_chains(ir, arch, seed_pl, mode=mode,
                                         device=CPU)
    assert bx.shape == (CHAINS, ir.n_lbs) and bx.dtype == np.int64
    for other in (_reference_chains(rir, rarch, rseed_pl, mode),
                  anneal._ensemble_chains(ir, arch, seed_pl, mode=mode,
                                          backend="numpy")):
        oc, ox, oy = other
        assert np.array_equal(bx, ox) and np.array_equal(by, oy)
        _costs_agree(bc, oc, mode)


@pytest.mark.parametrize("refine", [None, "anneal", "anneal_timing"])
@pytest.mark.parametrize("name", CIRCUITS)
def test_place_ir_torch_equals_reference_jax(x64, name, refine):
    """After the final picks (the best relaxed member by wirelength, the
    best of ``[seed] + chains`` by exact cost) the port's torch backend
    gives the reference jax backend's placement."""
    ir, rir, arch, rarch = _irs(name)
    got = place.placement_for(ir, arch, seed=0, cache=False,
                              backend="torch", refine=refine, device=CPU)
    want = rplace.placement_for(rir, rarch, seed=0, cache=False,
                                backend="jax", refine=refine)
    _same(got, want)


@pytest.mark.parametrize("name", CIRCUITS + ("conv2d-fu",))
def test_relaxation_within_rounding_of_numpy(name):
    """Each relaxed member is within 1e-12 of ``_smooth_numpy`` on the
    same start, and legalizes to the same slots."""
    ir, _, arch, _ = _irs(name)
    A = place.lb_connectivity(ir)
    pos0 = np.random.default_rng(3).random((4, ir.n_lbs, 2))
    relaxed = place._smooth_torch(A, pos0, CPU)
    W, H = place.grid_shape(ir.n_lbs, arch.grid_aspect)
    for e in range(4):
        want = place._smooth_numpy(A, pos0[e])
        np.testing.assert_allclose(relaxed[e], want, rtol=0, atol=1e-12)
        for a, b in zip(place._legalize(relaxed[e], W, H),
                        place._legalize(want, W, H)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", CIRCUITS)
def test_refined_placement_deterministic_legal_never_worse(name):
    """The reference test of the same name, its jax backend as torch."""
    ir, _, arch, _ = _irs(name)
    seed_pl = place.place_ir(ir, arch, seed=0)
    tseed_pl = place.place_ir(ir, arch, seed=0, backend="torch", device=CPU)
    _legal(tseed_pl, ir.n_lbs)
    for backend in ("numpy", "torch"):
        kw = {"device": CPU} if backend == "torch" else {}
        a = place.place_ir(ir, arch, seed=0, refine="anneal",
                           backend=backend, **kw)
        b = place.place_ir(ir, arch, seed=0, refine="anneal",
                           backend=backend, **kw)
        _same(a, b)
        _legal(a, ir.n_lbs)
        assert a.refine == "anneal"
        base = tseed_pl if backend == "torch" else seed_pl
        assert (a.grid_w, a.grid_h) == (base.grid_w, base.grid_h)
        assert a.wirelength(ir) <= base.wirelength(ir)


def test_torch_ensemble_no_worse_than_single_chain_seed(monkeypatch):
    """The reference's ``test_jax_ensemble_no_worse_than_single_chain_seed``
    with the torch backend: the best of ``[seed] + chains`` is legal and
    never worse than the analytic seed, and ``refine_placement`` on the
    numpy seed keeps the best chain unless the seed is better."""
    monkeypatch.setattr(anneal, "CHAINS", 2)
    ir, _, arch, _ = _irs("conv1d-fu")
    seed_pl = place.place_ir(ir, arch, seed=0)
    j = place.place_ir(ir, arch, seed=0, refine="anneal", backend="torch",
                       anneal_steps=24, device=CPU)
    _legal(j, ir.n_lbs)
    r = anneal.refine_placement(ir, arch, seed_pl, backend="torch",
                                steps=24, device=CPU)
    bc, bx, by = anneal._ensemble_chains(ir, arch, seed_pl, steps=24,
                                         device=CPU)
    assert bc.shape == (2,)
    assert r.wirelength(ir) == min(seed_pl.wirelength(ir), int(bc.min()))
    assert r.wirelength(ir) <= seed_pl.wirelength(ir)
    # chain 0 is the numpy backend's one chain
    n = anneal.refine_placement(ir, arch, seed_pl, steps=24)
    assert np.array_equal(n.lb_x, bx[0]) and np.array_equal(n.lb_y, by[0])


@pytest.mark.parametrize("arch_name", ["baseline", "dd5", "dd6"])
def test_legalized_placements_respect_grid_capacity(arch_name):
    """The reference test of the same name, its jax backend as torch."""
    for name in CIRCUITS:
        ir, _, arch, _ = _irs(name, arch_name)
        for backend in ("numpy", "torch"):
            pl = place.place_ir(ir, arch, seed=0, backend=backend,
                                device=CPU if backend == "torch" else None)
            _legal(pl, ir.n_lbs)


@pytest.mark.parametrize("refine", [None, "anneal"])
def test_placed_timing_bit_identical_on_ensemble_placements(x64, refine):
    """The reference's placed-timing gates on ensemble placements: the
    port's torch program and numpy walk on the torch ensemble's placement
    equal the port's placed oracle and the reference's placed oracle on
    its jax ensemble's placement, at zero and nonzero wire delay."""
    port, ref = _suites()
    net, rnet = port["conv1d-fu"], ref["conv1d-fu"]
    wired = [make(a.name + "_wired", bypass_inputs=a.bypass_inputs,
                  addmux_fanin=a.addmux_fanin, lut6=a.concurrent_6lut,
                  t_wire_hop1=25.0, t_wire_hop2=40.0, t_wire_long=120.0)
             for make, a in ((make_arch, ARCHS["dd5"]),
                             (rmake_arch, RARCHS["dd5"]))]
    for arch, rarch in ((ARCHS["dd5"], RARCHS["dd5"]), wired):
        p = pack(net, arch)
        pl = place.placement_for(p.lower_ir(), arch, 0, cache=False,
                                 backend="torch", refine=refine, device=CPU)
        want = analyze_placed_oracle(p, pl)
        pir = apply_placement(p.lower_ir(), pl)
        assert ttv.analyze_ir(pir, arch) == want
        assert ttv.analyze_ir(pir, arch, backend="torch",
                              device=CPU) == want
        rp = rpack(rnet, rarch)
        rpl = rplace.placement_for(rp.lower_ir(), rarch, 0, cache=False,
                                   backend="jax", refine=refine)
        _same(pl, rpl)
        assert ranalyze_placed(rp, rpl) == want


def test_trivial_circuits_refine_to_seed():
    net = vtr_mixed(logic_nodes=8, adders=1)
    assert net.content_digest() == \
        rvtr_mixed(logic_nodes=8, adders=1).content_digest()
    arch = ARCHS["dd5"]
    ir = pack(net, arch).lower_ir()
    assert ir.n_lbs == 1
    seed_pl = place.place_ir(ir, arch, seed=0, backend="torch", device=CPU)
    assert anneal.refine_placement(ir, arch, seed_pl, backend="torch",
                                   device=CPU) is seed_pl
    assert anneal._ensemble_chains(ir, arch, seed_pl, device=CPU) is None


def test_backend_names():
    """``"jax"`` is the reference's name: the port raises ``ValueError``
    naming ``"torch"``; the torch backend with no card raises too."""
    ir, _, arch, _ = _irs("conv1d-pw-fu")
    seed_pl = place.place_ir(ir, arch, seed=0)
    with pytest.raises(ValueError, match="'torch'"):
        place.place_ir(ir, arch, backend="jax")
    with pytest.raises(ValueError, match="'torch'"):
        anneal.refine_placement(ir, arch, seed_pl, backend="jax")
    with pytest.raises(ValueError, match="'torch'"):
        anneal._ensemble_chains(ir, arch, seed_pl, backend="jax")
    with pytest.raises(ValueError, match="unknown refine mode"):
        anneal._ensemble_chains(ir, arch, seed_pl, mode="quench",
                                device=CPU)
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            place.place_ir(ir, arch, backend="torch")
