"""The port's flow server, ``edits`` and ``flow.serve`` against the JAX
package's, on the CPU: one counterpart of each test of
``tests/core/test_serve_flow.py``.

Every record the port's server resolves — ``timing_backend="torch"`` (on
``device="cpu"``) and ``"numpy"`` — must equal the port's serial
``pack_and_analyze(net, arch, seeds=(seed,))`` and the reference server's
record for the same request (its device program, ``"jax"``, and its
``"numpy"`` walk); delta attribution, eval lanes and the cache-stats
surface equal the reference's too.  The reference's device program needs
``jax.experimental.enable_x64``, which jax 0.9.0 moved to
``jax.enable_x64``: the ``x64`` fixture aliases it for one test at a time.
"""
from __future__ import annotations

import asyncio
import copy
import random

import jax
import jax.experimental
import numpy as np
import pytest

from repro.core import circuits as rcirc
from repro.core import edits as redits
from repro.core import plan as rplan
from repro.core import repack as rrepack
from repro.core import serve_flow as rserve
from repro_torch.core import circuits as tcirc
from repro_torch.core import edits, flow, plan
from repro_torch.core.alm import ARCHS
from repro_torch.core.flow import _METRIC_KEYS, pack_and_analyze
from repro_torch.core.repack import (cluster_delta, pack_prefix,
                                     pack_prefix_delta, repack, repack_delta,
                                     repack_with_log)
from repro_torch.core.serve_flow import (FlowRequest, FlowServer,
                                         serve_requests)
from repro_torch.core.timing import analyze

CPU = "cpu"
BACKENDS = ("torch", "numpy")

NETS = {
    "gemm": lambda c: c.kratos_gemm(m=4, n=4, width=5, sparsity=0.5),
    "gemm6": lambda c: c.kratos_gemm(m=4, n=4, width=6, sparsity=0.5),
    "sha": lambda c: c.sha_like(rounds=1),
    "vtr": lambda c: c.vtr_mixed(logic_nodes=100, adders=2),
}


@pytest.fixture(autouse=True)
def _fresh_caches():
    for p in (plan, rplan):
        p.clear_caches()
        p.reset_cache_stats()
    yield
    plan.clear_caches()
    rplan.clear_caches()


@pytest.fixture
def x64(monkeypatch):
    """Let the reference's device program find ``enable_x64`` where
    jax < 0.9 kept it, for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)


def both(name):
    p, r = NETS[name](tcirc), NETS[name](rcirc)
    assert p.content_digest() == r.content_digest()
    return p, r


def _nets():
    return [both(n) for n in ("gemm", "sha", "vtr")]


def _server(backend="torch", **kw):
    return FlowServer(timing_backend=backend, device=CPU, **kw)


def _assert_record_matches(rec: dict, net, arch: str, seed: int):
    ref = pack_and_analyze(net, arch, seeds=(seed,))
    for k in _METRIC_KEYS:
        assert rec[k] == ref[k], (net.name, arch, k, rec[k], ref[k])


def _reference_results(pairs, arch_seq, backend, **req_kw):
    reqs = [rserve.FlowRequest(r, arch, **req_kw)
            for _, r in pairs for arch in arch_seq]
    return rserve.serve_requests(reqs, timing_backend=backend)


# ---------------------------------------------------------------------------
# LRU cache layer (repro_torch.core.plan)
# ---------------------------------------------------------------------------


def test_cache_lru_order_and_counters():
    """The same operations on the port's and the reference's ``Cache``
    give the same contents and counters at every step."""
    seen = []
    for p in (plan, rplan):
        c = p.Cache("t", cap=2)
        log = []
        c.put("a", 1)
        c.put("b", 2)
        log.append(c.get("a"))
        c.put("c", 3)
        log.append(("a" in c, "b" in c, "c" in c, c.get("b")))
        log.append(c.stats())
        _ = "a" in c
        log.append(c.stats())
        c.clear()
        log.append(c.stats())
        c.reset_stats()
        log.append(c.stats())
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[0][2] == {"size": 2, "cap": 2, "hits": 1, "misses": 1,
                          "evictions": 1, "hit_rate": 0.5}
    assert seen[0][-1]["hits"] == 0 and seen[0][-1]["hit_rate"] == 0.0


def test_cache_resize_and_registry_knobs():
    cache = plan.register_cache("test_torch_resize_knob", cap=8)
    for i in range(8):
        cache.put(i, i)
    plan.set_cache_cap("test_torch_resize_knob", 3)
    assert len(cache) == 3 and cache.cap == 3
    assert cache.stats()["evictions"] == 5
    assert set(cache.keys()) == {5, 6, 7}
    with pytest.raises(KeyError, match="no_such_cache"):
        plan.set_cache_cap("no_such_cache", 4)
    with pytest.raises(ValueError):
        cache.resize(0)
    assert "test_torch_resize_knob" in plan.cache_stats()


def test_prefix_eviction_forces_clean_repack():
    net, _ = both("gemm")
    cache = plan.register_cache("pack_prefix")
    old_cap = cache.cap
    try:
        prefix = pack_prefix(net, seed=0)
        cache.put((net.content_digest(), 0), prefix)
        p0 = repack(prefix, ARCHS["baseline"])
        plan.set_cache_cap("pack_prefix", 1)
        other, _ = both("sha")
        cache.put((other.content_digest(), 0), pack_prefix(other, seed=0))
        assert (net.content_digest(), 0) not in cache
        p1 = repack(pack_prefix(net, seed=0), ARCHS["baseline"])
        assert cluster_delta(p0, p1)["n_changed"] == 0
        assert analyze(p0) == analyze(p1)
    finally:
        plan.set_cache_cap("pack_prefix", old_cap)


# ---------------------------------------------------------------------------
# serving: coalescing, priority, determinism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_matches_serial_flow(x64, backend):
    """Records equal the port's serial flow and the reference server's
    (its device program and its numpy walk), key for key."""
    pairs = _nets()
    archs = ("baseline", "dd5")
    reqs = [FlowRequest(p, arch, analyses=("area", "timing"), seed=0)
            for p, _ in pairs for arch in archs]
    results = serve_requests(reqs, timing_backend=backend, device=CPU)
    assert len(results) == len(reqs)
    for rbackend in ("jax", "numpy"):
        refs = _reference_results(pairs, archs, rbackend,
                                  analyses=("area", "timing"))
        for res, ref in zip(results, refs):
            assert res.record == ref.record
            assert (res.net, res.digest, res.arch) == \
                (ref.net, ref.digest, ref.arch)
            assert res.analyses == ref.analyses
    for req, res in zip(reqs, results):
        _assert_record_matches(res.record, req.net, req.arch, req.seed)
        stages = res.walls["stages"]
        assert {"repack_s", "timing_s", "build_s", "total_s"} <= set(stages)
        assert res.walls["total_s"] >= res.walls["service_s"] >= 0.0


def test_serve_coalesces_identical_requests():
    net, _ = both("gemm")

    async def main():
        server = _server(batch_window_s=0.01)
        rs = await asyncio.gather(*(server.submit(
            FlowRequest(net, "baseline")) for _ in range(4)))
        await server.aclose()
        return rs, dict(server.stats)

    rs, stats = asyncio.run(main())
    assert all(r.batch["id"] == rs[0].batch["id"] for r in rs)
    assert all(r.batch["n_shared"] == 4 for r in rs)
    assert stats["n_jobs"] == 1 and stats["n_coalesced"] == 3
    assert all(r.record is rs[0].record for r in rs)
    _assert_record_matches(rs[0].record, net, "baseline", 0)


def test_serve_priority_order_under_small_batches():
    nets = [p for p, _ in _nets()]

    async def main():
        server = _server(batch_window_s=0.02, max_batch=1)
        futs = [server.submit_nowait(FlowRequest(nets[0], "baseline",
                                                 priority=0)),
                server.submit_nowait(FlowRequest(nets[1], "baseline",
                                                 priority=5)),
                server.submit_nowait(FlowRequest(nets[2], "baseline",
                                                 priority=1))]
        rs = await asyncio.gather(*futs)
        await server.aclose()
        return rs

    r0, r1, r2 = asyncio.run(main())
    assert r1.batch["id"] < r2.batch["id"] < r0.batch["id"]
    for r, net in zip((r0, r1, r2), nets):
        _assert_record_matches(r.record, net, "baseline", 0)


def test_serve_concurrent_clients_with_midflight_eviction():
    nets = [p for p, _ in _nets()]
    pool = [(net, arch) for net in nets for arch in ("baseline", "dd5")]
    n_clients, n_requests = 4, 16
    results: list = [None] * n_requests

    async def main():
        server = _server(batch_window_s=0.001)

        async def client(ci):
            for j in range(ci, n_requests, n_clients):
                net, arch = pool[j % len(pool)]
                results[j] = await server.submit(
                    FlowRequest(net, arch, seed=0))

        async def evictor():
            for _ in range(6):
                await asyncio.sleep(0.002)
                plan.clear_caches()
                plan.set_cache_cap("serve_packs", 1)
                plan.set_cache_cap("serve_timing", 1)

        try:
            await asyncio.gather(evictor(),
                                 *(client(c) for c in range(n_clients)))
        finally:
            await server.aclose()
            plan.set_cache_cap("serve_packs", 256)
            plan.set_cache_cap("serve_timing", 2048)

    asyncio.run(main())
    refs: dict = {}
    for j in range(n_requests):
        net, arch = pool[j % len(pool)]
        key = (net.name, arch)
        if key not in refs:
            refs[key] = pack_and_analyze(net, arch, seeds=(0,))
        for k in _METRIC_KEYS:
            assert results[j].record[k] == refs[key][k]


# ---------------------------------------------------------------------------
# netlist-delta fast path
# ---------------------------------------------------------------------------


def test_pack_digest_ignores_truth_tables_only():
    (net, rnet), (structural, rstructural) = both("gemm"), both("gemm6")
    tt_edit, rtt_edit = copy.deepcopy(net), copy.deepcopy(rnet)
    tt_edit.lut_tt[0] ^= 0xFFFF
    rtt_edit.lut_tt[0] ^= 0xFFFF
    assert tt_edit.content_digest() != net.content_digest()
    assert tt_edit.pack_digest() == net.pack_digest()
    assert structural.pack_digest() != net.pack_digest()
    for a, b in ((tt_edit, rtt_edit), (structural, rstructural)):
        assert (a.content_digest(), a.pack_digest()) == \
            (b.content_digest(), b.pack_digest())


def _serve_base_then_edit(server, net, edited, arch):
    async def main():
        base = await server.submit(_request(server, net, arch))
        r = await server.submit(_request(server, edited, arch,
                                         base_digest=base.digest))
        await server.aclose()
        return base, r, dict(server.stats)

    return asyncio.run(main())


def _request(server, net, arch, **kw):
    cls = FlowRequest if isinstance(server, FlowServer) \
        else rserve.FlowRequest
    return cls(net, arch, **kw)


def _both_servers(backend="torch"):
    return (_server(backend),
            rserve.FlowServer(timing_backend="numpy"))


def test_serve_delta_tt_only_reuses_pack_and_timing():
    net, rnet = both("gemm")
    tt_edit, rtt_edit = copy.deepcopy(net), copy.deepcopy(rnet)
    tt_edit.lut_tt[0] ^= 0xFFFF
    rtt_edit.lut_tt[0] ^= 0xFFFF
    server, rserver = _both_servers()
    r0, r1, stats = _serve_base_then_edit(server, net, tt_edit, "baseline")
    _, rr1, rstats = _serve_base_then_edit(rserver, rnet, rtt_edit,
                                           "baseline")
    assert r1.delta == rr1.delta and r1.delta["mode"] == "tt_only"
    assert r1.delta["n_changed"] == 0
    assert r1.batch["pack_cached"] and r1.batch["timing_cached"]
    assert stats == rstats and stats["n_delta_pack_reuse"] == 1
    assert r1.record == rr1.record
    _assert_record_matches(r1.record, tt_edit, "baseline", 0)
    assert r1.record["critical_path_ps"] == r0.record["critical_path_ps"]


def test_serve_delta_structural_attribution():
    (net, rnet), (edited, redited) = both("gemm"), both("gemm6")
    server, rserver = _both_servers()
    _, r, stats = _serve_base_then_edit(server, net, edited, "baseline")
    _, rr, rstats = _serve_base_then_edit(rserver, rnet, redited,
                                          "baseline")
    assert r.delta == rr.delta and r.delta["mode"] == "structural"
    assert r.delta["n_lbs_base"] >= 1 and r.delta["n_lbs_new"] >= 1
    assert 0 <= r.delta["unchanged_frac"] <= 1
    assert stats == rstats
    assert r.record == rr.record
    _assert_record_matches(r.record, edited, "baseline", 0)


def _incremental_rewire(net, rnet, arch):
    """A single-LUT fanin rewire that stays on the incremental path, made
    by the port's and the reference's ``edits`` alike."""
    prefix = pack_prefix(net, seed=0)
    _, log = repack_with_log(prefix, arch)
    rng = random.Random(7)
    for _ in range(50):
        li = rng.randrange(net.n_luts)
        srcs = edits.safe_rewire_sources(net, li)
        assert srcs == redits.safe_rewire_sources(rnet, li)
        if not srcs:
            continue
        pin = rng.randrange(len(net.lut_inputs[li]))
        src = rng.choice(srcs)
        if net.lut_inputs[li][pin] == src:
            continue
        cand, rcand = edits.clone_netlist(net), redits.clone_netlist(rnet)
        assert edits.edit_rewire_fanin(cand, li, pin, src) == \
            redits.edit_rewire_fanin(rcand, li, pin, src)
        np_, pinfo = pack_prefix_delta(prefix, cand, base_log=log)
        if np_ is None or pinfo["mode"] != "incremental":
            continue
        _, rinfo = repack_delta(np_, log, arch,
                                dirty_atoms=pinfo["dirty_atoms"])
        if rinfo["mode"] == "incremental":
            return cand, rcand
    raise AssertionError("no incremental-path rewire found")


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_delta_dirty_set_incremental_path(backend):
    net, rnet = both("gemm")
    edited, redited = _incremental_rewire(net, rnet, ARCHS["dd5"])
    assert edited.content_digest() == redited.content_digest()
    plan.clear_caches()
    server, rserver = _both_servers(backend)
    _, r, stats = _serve_base_then_edit(server, net, edited, "dd5")
    _, rr, rstats = _serve_base_then_edit(rserver, rnet, redited, "dd5")
    assert r.delta["mode"] == "structural"
    assert r.delta["repack"]["mode"] == "incremental"
    assert r.delta["repack"]["n_frozen_lbs"] >= 1
    assert r.delta["verify"]["method"] == "symbolic_scoped"
    assert r.delta["verify"]["equivalent"] is True
    assert (r.delta["n_frozen"] + r.delta["n_moved"]
            + r.delta["n_reclustered"]) >= r.delta["n_lbs_new"] - 1
    assert r.delta == rr.delta
    assert stats == rstats
    assert stats["n_delta_incremental"] == 1
    assert stats["n_delta_fallback"] == 0
    assert stats["n_verify_scoped"] == 1 and stats["n_verify_full"] == 0
    assert r.record == rr.record
    _assert_record_matches(r.record, edited, "dd5", 0)


def test_cluster_delta_identical_and_disjoint():
    (net, rnet), (other, rother) = both("gemm"), both("sha")
    arch = ARCHS["baseline"]
    p = repack(pack_prefix(net, seed=0), arch)
    d = cluster_delta(p, p)
    assert d["n_changed"] == 0 and d["unchanged_frac"] == 1.0
    d2 = cluster_delta(p, repack(pack_prefix(other, seed=0), arch))
    assert d2["n_changed"] == max(d2["n_lbs_base"], d2["n_lbs_new"])
    from repro.core.alm import ARCHS as RARCHS

    rp = rrepack.repack(rrepack.pack_prefix(rnet, seed=0),
                        RARCHS["baseline"])
    rother_p = rrepack.repack(rrepack.pack_prefix(rother, seed=0),
                              RARCHS["baseline"])
    assert d2 == rrepack.cluster_delta(rp, rother_p)


def test_edits_match_reference():
    """Each ``edits`` operator on the port's netlist gives the content and
    pack digests the reference's operator gives on the same circuit."""
    net, rnet = both("gemm")
    pi = net.pis[:2]
    li = next(i for i in range(net.n_luts)
              if edits.safe_rewire_sources(net, i))
    logs = []
    for mod, base in ((edits, net), (redits, rnet)):
        n = mod.clone_netlist(base)
        assert n.content_digest() == net.content_digest()
        log = [mod.edit_lut_tt(n, li, 0x6996), n.content_digest(),
               n.pack_digest()]
        src = random.Random(5).choice(mod.safe_rewire_sources(n, li))
        log += [mod.edit_rewire_fanin(n, li, 0, src), n.content_digest(),
                n.pack_digest()]
        new_li = mod.edit_add_lut(n, pi, 0x8)
        log += [new_li, n.content_digest(), n.pack_digest()]
        log += [mod.edit_extend_chain(n, 0, pi[0], pi[1]),
                n.content_digest(), n.pack_digest()]
        # a dead LUT (no consumer, no PO) is removable
        n.pos["__edit_taps"].remove(n.lut_out[new_li])
        log += [mod.edit_remove_lut(n, new_li), n.content_digest(),
                n.pack_digest(), n.n_luts]
        logs.append(log)
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# eval analysis
# ---------------------------------------------------------------------------


def test_serve_eval_matches_oracle_and_memoizes():
    net, rnet = both("sha")
    lanes = flow.random_lanes(net, 2, seed=0)
    ref = flow.evaluate_netlist(net, lanes, 2, device=CPU)

    async def main(server, n):
        r0 = await server.submit(_request(server, n, "baseline",
                                          analyses=("eval",),
                                          n_lane_words=2))
        r1 = await server.submit(_request(server, n, "dd5",
                                          analyses=("eval",),
                                          n_lane_words=2))
        await server.aclose()
        return r0, r1, dict(server.stats)

    r0, r1, stats = asyncio.run(main(_server(), net))
    rr0, _, rstats = asyncio.run(main(
        rserve.FlowServer(timing_backend="numpy"), rnet))
    for name, bus in net.pos.items():
        want = ref[np.asarray(bus, dtype=np.int64)]
        assert np.array_equal(r0.analyses["eval"][name], want)
        assert np.array_equal(r1.analyses["eval"][name], want)
        assert np.array_equal(rr0.analyses["eval"][name], want)
    assert stats == rstats and stats["n_eval_hits"] == 1
    assert r1.record is None and "eval" in r1.analyses
    assert r0.record is None
    assert flow.oracle_check(net, lanes, ref, 2)


def test_server_rejects_eval_warm_and_pad_timing_shapes():
    """The counterpart of ``test_eval_warm_auto_derives_from_actual_runs``:
    the port's evaluator compiles nothing per program, so its server has
    neither the reference's ``eval_warm`` nor its ``pad_timing_shapes``
    and rejects both as unknown arguments."""
    with pytest.raises(TypeError, match="eval_warm"):
        FlowServer(eval_warm="auto", device=CPU)
    with pytest.raises(TypeError, match="pad_timing_shapes"):
        FlowServer(pad_timing_shapes=True, device=CPU)
    with pytest.raises(TypeError, match="use_pallas"):
        FlowServer(use_pallas=False, device=CPU)


# ---------------------------------------------------------------------------
# server surface
# ---------------------------------------------------------------------------


def test_serve_request_validation_and_close():
    net, _ = both("sha")
    with pytest.raises(ValueError, match="unknown analyses"):
        FlowRequest(net, "baseline", analyses=("timing", "power"))
    with pytest.raises(ValueError, match="no analyses"):
        FlowRequest(net, "baseline", analyses=())
    with pytest.raises(ValueError, match="backend"):
        FlowServer(timing_backend="fpga", device=CPU)
    with pytest.raises(ValueError, match="'torch'"):
        FlowServer(timing_backend="jax", device=CPU)

    async def main():
        server = _server(batch_window_s=10.0)
        fut = server.submit_nowait(FlowRequest(net, "baseline"))
        await asyncio.sleep(0)
        await server.aclose()
        with pytest.raises(RuntimeError, match="closed"):
            await fut

    asyncio.run(main())


def test_serve_cache_stats_surface(x64):
    """The surface the reference test reads, with the same registry
    names as the reference server's and the same hit counters."""
    net, rnet = both("sha")

    async def main(server, req):
        await server.submit(req)
        await server.submit(req)
        st = server.cache_stats()
        await server.aclose()
        return st, dict(server.stats)

    st, stats = asyncio.run(main(_server(), FlowRequest(net, "baseline")))
    rst, rstats = asyncio.run(main(rserve.FlowServer(),
                                   rserve.FlowRequest(rnet, "baseline")))
    names = ("serve_packs", "serve_timing", "serve_eval", "serve_programs",
             "serve_digests", "serve_repack_logs", "pack_prefix")
    for name in names:
        assert name in st and st[name]["cap"] == rst[name]["cap"] >= 1
        assert st[name] == rst[name]
    assert stats == rstats
    assert stats["n_pack_hits"] == 1 and stats["n_timing_hits"] == 1
    assert st["serve_packs"]["hits"] >= 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_numpy_backend_parity(backend):
    """The reference's numpy-backend case, with both of the port's
    backends, which must also agree with each other record for record."""
    nets = [p for p, _ in _nets()[:2]]
    reqs = [FlowRequest(net, arch) for net in nets
            for arch in ("baseline", "dd6")]
    results = serve_requests(reqs, timing_backend=backend, device=CPU)
    plan.clear_caches()
    other = serve_requests(reqs, timing_backend=BACKENDS[
        1 - BACKENDS.index(backend)], device=CPU)
    for req, res, o in zip(reqs, results, other):
        _assert_record_matches(res.record, req.net, req.arch, req.seed)
        assert res.record == o.record


def test_flow_serve_is_serve_requests():
    """``flow.serve`` serves through one server: coalesced, and equal to
    ``serve_requests`` and the serial flow; eval lanes equal a direct
    ``evaluate_suite``."""
    pairs = _nets()
    reqs = [FlowRequest(p, arch, analyses=("area", "timing", "eval"),
                        n_lane_words=2)
            for p, _ in pairs for arch in ("baseline", "dd5")]
    got = flow.serve(reqs, device=CPU)
    plan.clear_caches()
    want = serve_requests(reqs, device=CPU)
    nets = [p for p, _ in pairs]
    lanes = [flow.random_lanes(n, 2, seed=0) for n in nets]
    direct, _ = flow.evaluate_suite(nets, lanes, 2, device=CPU)
    vals = {n.content_digest(): v for n, v in zip(nets, direct)}
    for req, g, w in zip(reqs, got, want):
        assert g.record == w.record and g.delta is None
        _assert_record_matches(g.record, req.net, req.arch, 0)
        v = vals[req.net.content_digest()]
        for name, bus in req.net.pos.items():
            assert np.array_equal(g.analyses["eval"][name],
                                  v[np.asarray(bus, dtype=np.int64)])
    assert got[0].batch["n_requests"] == len(reqs)
