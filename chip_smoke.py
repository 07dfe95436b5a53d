"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the paper's CAD flow and its bit-parallel
functional evaluator — at full size on the card, and holds every CUDA
kernel against its plain-torch version.  Phases, each printing one JSON
line; any failure raises, so the script exits non-zero:

1. device and build: the card, its power limit, the nvcc build of every
   kernel source;
2. kernel parity: ``lut_eval6`` and ``lut_eval`` (K = 1..5) bit-exact
   against their plain versions on the card, ragged shapes included, and
   timed at the main path's shapes beside the plain version and the
   memory / operation bound;
3. flow: Kratos + Koios + VTR at scale 1.0 packed under baseline / DD5 /
   DD6 with the equivalence gate on, geomean area / critical-path / ADP
   ratios per suite;
4. suite evaluation: all 17 circuits at 4096 lane words (131,072 vectors
   per circuit), grouped and per-circuit, equal to each other, to the
   plain-version path and to the Python oracle on sampled words;
5. profile: one warm grouped suite evaluation under ``torch.profiler``
   (device time by kernel and copy, device idle share, host hot spots);
6. equivalence through the card: ``conv2d-fu`` and ``conv1d-fu`` under
   DD5 proven by lane simulation on the fused evaluator;
7. per-level baseline: the Fig. 9 stress workload through ``lut_eval``,
   equal to the fused evaluator;
8. summary: the ``kernels`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each phase that drives the main
path and read just after; the parity phase's launches are not counted.
It exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

N_LANE_WORDS = 4096
ARCH_NAMES = ("baseline", "dd5", "dd6")
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/lut_eval.cu"

#: H100 SXM peaks used for the bounds: HBM3 bandwidth (NVIDIA data sheet)
#: and int32 logic throughput (132 SMs x 64 INT32 lanes per clock x 1.98 GHz
#: boost, Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def card_line() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def geomean(xs) -> float:
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


# ---------------------------------------------------------------------------
# kernels: parity and timing
# ---------------------------------------------------------------------------


def _u32(t) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _random_words(rng: np.random.Generator, shape, device):
    import torch

    a = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def _max_abs_err(got, want) -> int:
    g = _u32(got).astype(np.int64)
    w = _u32(want).astype(np.int64)
    return int(np.abs(g - w).max()) if g.size else 0


def time_ms(fn, reps: int = 10, inner: int = 10, warmup: int = 3) -> float:
    """Milliseconds per ``fn()`` on the card: CUDA events around ``inner``
    back-to-back calls (so the host's launch overhead hides behind the
    device's work), median over ``reps`` such runs."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def lut_bound_ms(M: int, K: int, N: int, n_tables: int) -> dict:
    """Least time for a K-input LUT evaluation of ``[M, K, N]`` words: the
    bytes it must move (inputs and tables read once, output written once)
    over the HBM rate, against the logic it must do over the int32 rate.
    The operation count is that of a Shannon mux tree, the cheapest known
    formulation: 2^K - 1 three-input LOP3s per output word."""
    nbytes = 4 * (M * K * N + M * n_tables + M * N)
    ops = M * N * ((1 << K) - 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def kernel_parity(device, main_shapes: dict) -> dict:
    """Each kernel against its plain version on the card over random
    inputs (ragged shapes, equal-table rows), then timed at the main
    path's shapes.  Returns per-kernel records for the summary line."""
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    M6, N6 = main_shapes["lut_eval6"]
    err6 = 0
    for M, N in [(M6, N6), (2330, 4096), (513, 3), (1, 1), (300, 129)]:
        ins = _random_words(rng, (M, 6, N), device)
        lo = _random_words(rng, (M,), device)
        hi = _random_words(rng, (M,), device)
        hi[::2] = lo[::2]   # narrower LUTs replicate their table
        got = ops.lut_eval6(ins, lo, hi, use_kernel=True)
        want = ops.lut_eval6(ins, lo, hi, use_kernel=False)
        torch.cuda.synchronize()
        e = _max_abs_err(got, want)
        check(e == 0, f"lut_eval6 differs from its plain version at "
                      f"M={M} N={N} (max abs err {e})")
        err6 = max(err6, e)
    err = 0
    for K in range(1, 6):
        for M, N in [(main_shapes["lut_eval"][0], N6), (513, 3), (1, 1),
                     (257, 129)]:
            ins = _random_words(rng, (M, K, N), device)
            tts = _random_words(rng, (M,), device)
            got = ops.lut_eval(ins, tts, use_kernel=True)
            want = ops.lut_eval(ins, tts, use_kernel=False)
            torch.cuda.synchronize()
            e = _max_abs_err(got, want)
            check(e == 0, f"lut_eval K={K} differs from its plain version "
                          f"at M={M} N={N} (max abs err {e})")
            err = max(err, e)

    recs = {}
    ins = _random_words(rng, (M6, 6, N6), device)
    lo = _random_words(rng, (M6,), device)
    hi = _random_words(rng, (M6,), device)
    b6 = lut_bound_ms(M6, 6, N6, 2)
    recs["lut_eval6"] = {
        "shape": [M6, 6, N6], "max_abs_err": err6,
        "ms": time_ms(lambda: ops.lut_eval6(ins, lo, hi)),
        "plain_ms": time_ms(lambda: ops.lut_eval6(ins, lo, hi,
                                                  use_kernel=False),
                            reps=3, inner=2),
        **b6}
    M5, K5 = main_shapes["lut_eval"]
    ins5 = _random_words(rng, (M5, K5, N6), device)
    tts = _random_words(rng, (M5,), device)
    b5 = lut_bound_ms(M5, K5, N6, 1)
    recs["lut_eval"] = {
        "shape": [M5, K5, N6], "max_abs_err": err,
        "ms": time_ms(lambda: ops.lut_eval(ins5, tts)),
        "plain_ms": time_ms(lambda: ops.lut_eval(ins5, tts,
                                                 use_kernel=False),
                            reps=3, inner=2),
        **b5}
    return recs


# ---------------------------------------------------------------------------
# main-path phases (device-generic: the tests rehearse them on the CPU at
# tiny sizes; the script runs them on the card at full size)
# ---------------------------------------------------------------------------


def full_suites(scale: float = 1.0, seed: int = 0) -> dict:
    from repro_torch.core.circuits import koios_suite, kratos_suite, vtr_suite

    return {"kratos": kratos_suite(scale=scale, seed=seed),
            "koios": koios_suite(scale=scale, seed=seed),
            "vtr": vtr_suite(scale=scale, seed=seed)}


def _counted(fn):
    """Run ``fn()`` with the launch counters set to 0 just before and read
    just after; returns ``(result, counts)``."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = fn()
    return out, ops.launch_counts()


def phase_flow(suites: dict, device, seeds=(0,)) -> dict:
    """Pack + analyze every circuit under baseline / DD5 / DD6 with the
    equivalence gate; geomean ratios against the baseline per suite."""
    from repro_torch.core import flow

    t0 = time.perf_counter()
    res, counts = _counted(lambda: flow.run_suites(
        suites, ARCH_NAMES, seeds=seeds, check_equiv=True, device=device))
    wall = time.perf_counter() - t0
    ratios = {}
    for suite, rows in res.items():
        per = [flow.ratios_vs_baseline(r["per_arch"]) for r in rows]
        for r in rows:
            for arch, rec in r["per_arch"].items():
                check(rec["equivalent"], f"{r['net']}@{arch} not equivalent")
        ratios[suite] = {
            arch: {k: geomean(p[arch][k] for p in per)
                   for k in ("area_mwta", "critical_path_ps", "adp")}
            for arch in ARCH_NAMES[1:]}
    return {"phase": "flow", "wall_s": wall, "circuits":
            sum(len(v) for v in suites.values()), "archs": list(ARCH_NAMES),
            "seeds": list(seeds), "geomean_ratios_vs_baseline": ratios,
            "launches": counts}


def suite_lanes(nets: list, n_lane_words: int) -> list:
    from repro_torch.core import flow

    return [flow.random_lanes(n, n_lane_words, seed=i)
            for i, n in enumerate(nets)]


def lut_eval6_launches_per_circuit(nets: list) -> dict:
    """Launches the fused evaluator makes for each circuit on its own: one
    per level of every bucket that holds LUTs."""
    from repro_torch.core.eval_torch import plan_netlist

    return {n.name: sum(bk.n_levels for bk in plan_netlist(n).buckets
                        if bk.has_luts) for n in nets}


def phase_suite_eval(nets: list, lanes: list, n_lane_words: int, device,
                     n_oracle_words: int = 4) -> dict:
    """Evaluate the suite grouped and per circuit through the kernels,
    and grouped through the plain version; all three equal, and equal to
    the Python oracle on sampled lane words of every circuit."""
    import torch

    from repro_torch.core import flow

    def run(mode, use_kernel=True):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, stats = flow.evaluate_suite(nets, lanes, n_lane_words,
                                          use_kernel=use_kernel, mode=mode,
                                          device=device)
        return outs, stats, time.perf_counter() - t0

    # cold: first upload of plan tensors; warm: the same call again
    (grouped, gstats, t_g_cold), c_g = _counted(lambda: run("grouped"))
    (per, _, t_p_cold), c_p = _counted(lambda: run("per_circuit"))
    _, _, t_g = run("grouped")
    _, _, t_p = run("per_circuit")
    plain, _, t_plain = run("grouped", use_kernel=False)
    for n, a, b, c in zip(nets, grouped, per, plain):
        check(np.array_equal(a, b), f"{n.name}: grouped != per-circuit")
        check(np.array_equal(a, c), f"{n.name}: kernel != plain version")
    rng = np.random.default_rng(0)
    for n, vals, ln in zip(nets, grouped, lanes):
        words = sorted({0, n_lane_words - 1,
                        *rng.integers(0, n_lane_words,
                                      max(n_oracle_words - 2, 0)).tolist()})
        check(flow.oracle_check(n, ln, vals, n_lane_words, words=words),
              f"{n.name}: differs from the Python oracle")
    per_circuit = lut_eval6_launches_per_circuit(nets)
    if device.type == "cuda":
        check(c_p["lut_eval6"] == sum(per_circuit.values()),
              f"per-circuit launches {c_p['lut_eval6']} != planned "
              f"{sum(per_circuit.values())}")
    luts = sum(n.n_luts for n in nets)
    vectors = 32 * n_lane_words
    return {"phase": "suite_eval", "circuits": len(nets),
            "signals": sum(n.n_signals for n in nets), "luts": luts,
            "n_lane_words": n_lane_words, "vectors_per_circuit": vectors,
            "groups": gstats["n_groups"],
            "wall_ms": {"grouped_cold": t_g_cold * 1e3,
                        "per_circuit_cold": t_p_cold * 1e3,
                        "grouped": t_g * 1e3, "per_circuit": t_p * 1e3,
                        "grouped_plain": t_plain * 1e3},
            "lut_evals_per_s": {"grouped": luts * vectors / t_g,
                                "per_circuit": luts * vectors / t_p},
            "launches": {"grouped": c_g, "per_circuit": c_p},
            "lut_eval6_launches_per_circuit": per_circuit,
            "oracle_words_per_circuit": n_oracle_words}


def phase_profile(nets: list, lanes: list, n_lane_words: int,
                  device, top: int = 10) -> dict:
    """One warm grouped suite evaluation under ``torch.profiler``: device
    time by kernel and copy, busy share of the wall, and the host
    operations that take the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import flow

    def run():
        flow.evaluate_suite(nets, lanes, n_lane_words, mode="grouped",
                            device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()

    run()  # warm: plan tensors uploaded, allocator primed
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side records only (kernels and copies; CPU ops also carry
    # their children's device time); CUPTI's own buffer requests are the
    # profiler's overhead, not the program's work
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in events if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer")),
                 key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in dev)
    return {"phase": "profile", "what": "evaluate_suite grouped (warm)",
            "n_lane_words": n_lane_words, "wall_ms": wall * 1e3,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "device_ms_by_name": [{"name": k[:80], "ms": ms, "count": c}
                                  for k, ms, c in dev[:top]],
            "host_self_ms_by_name": [{"name": k[:80], "ms": ms, "count": c}
                                     for k, ms, c in host[:top]]}


def phase_equiv(nets: list, device, n_vectors: int) -> dict:
    """Lane-simulation equivalence of each circuit under DD5 on the fused
    evaluator."""
    from repro_torch.core.alm import DD5
    from repro_torch.core.equiv import check_pack_equivalence

    recs = []
    t0 = time.perf_counter()
    for net in nets:
        rep, counts = _counted(lambda: check_pack_equivalence(
            net, DD5, n_vectors=n_vectors, method="simulate",
            use_fused=True, device=device))
        check(rep["equivalent"], f"{net.name}@dd5 not equivalent: "
                                 f"{rep['mismatches'][:1]}")
        recs.append({"net": net.name, "signals": net.n_signals,
                     "equivalent": rep["equivalent"],
                     "signals_checked": rep["signals_checked"],
                     "launches": counts})
    return {"phase": "equiv", "arch": "dd5", "n_vectors": n_vectors,
            "wall_s": time.perf_counter() - t0, "circuits": recs}


def phase_levels(net, n_lane_words: int, device) -> dict:
    """The per-level baseline (``lut_eval`` per level) against the fused
    evaluator on one workload."""
    import torch

    from repro_torch.core import flow
    from repro_torch.core.eval_torch import (eval_netlist_fused,
                                             eval_netlist_levels)

    lanes = flow.random_lanes(net, n_lane_words, seed=0)

    def timed(fn):
        fn()  # warm: plan upload, allocator
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    (lv, t_lv), c_lv = _counted(lambda: timed(
        lambda: eval_netlist_levels(net, lanes, n_lane_words,
                                    device=device)))
    fused, t_f = timed(lambda: eval_netlist_fused(net, lanes, n_lane_words,
                                                  device=device))
    check(np.array_equal(lv, fused), f"{net.name}: per-level != fused")
    return {"phase": "levels", "net": net.name, "signals": net.n_signals,
            "n_lane_words": n_lane_words,
            "wall_ms": {"levels": t_lv * 1e3, "fused": t_f * 1e3},
            "launches": c_lv}


def fig9_workload():
    """The Fig. 9 evaluation workload: the saturated packing-stress
    circuit (500 adders, 500 LUTs) stacked three layers deep."""
    from repro_torch.core.stress import packing_stress_circuit

    return packing_stress_circuit(n_adders=500, n_luts=500, seed=0, depth=3)


def main_path_shapes(nets: list, levels_net) -> dict:
    """The shapes the main path hands each kernel: the widest fused LUT
    level of the suite for ``lut_eval6``, the widest level of the
    per-level workload for ``lut_eval``."""
    from repro_torch.core.circuit_ir import levelize
    from repro_torch.core.eval_torch import plan_netlist

    m6 = max(bk.shape[1] for n in nets for bk in plan_netlist(n).buckets
             if bk.has_luts)
    by_luts, _, _ = levelize(levels_net)
    ids = max(by_luts.values(), key=len)
    k = max(len(levels_net.lut_inputs[i]) for i in ids)
    return {"lut_eval6": (m6, N_LANE_WORDS), "lut_eval": (len(ids), min(k, 5))}


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    device = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    emit({"phase": "device", "device": name, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    secs = build.build_all()
    ptxas = {s: [ln.strip() for ln in build.build_log(s).splitlines()
                 if "registers" in ln or "spill" in ln]
             for s in build.sources()}
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_source_s": secs, "ptxas": ptxas})

    suites = full_suites()
    nets = [n for v in suites.values() for n in v]
    levels_net = fig9_workload()
    shapes = main_path_shapes(nets, levels_net)
    krec = kernel_parity(device, shapes)
    emit({"phase": "kernel_parity", **krec})

    emit(phase_flow(suites, device))
    lanes = suite_lanes(nets, N_LANE_WORDS)
    rec = phase_suite_eval(nets, lanes, N_LANE_WORDS, device)
    emit(rec)
    launches6 = rec["launches"]["grouped"]["lut_eval6"] \
        + rec["launches"]["per_circuit"]["lut_eval6"]
    check(rec["launches"]["grouped"]["lut_eval6"] > 0
          and rec["launches"]["per_circuit"]["lut_eval6"] > 0,
          "suite evaluation did not launch lut_eval6")

    emit(phase_profile(nets, lanes, N_LANE_WORDS, device))

    by_name = {n.name: n for n in nets}
    erec = phase_equiv([by_name["conv2d-fu"], by_name["conv1d-fu"]], device,
                       n_vectors=32 * N_LANE_WORDS)
    emit(erec)
    check(all(c["launches"]["lut_eval6"] > 0 for c in erec["circuits"]),
          "equivalence did not go through lut_eval6")

    lrec = phase_levels(levels_net, N_LANE_WORDS, device)
    emit(lrec)
    check(lrec["launches"]["lut_eval"] > 0,
          "the per-level baseline did not launch lut_eval")

    replaces = {"lut_eval6": "src/repro/kernels/lut_eval.py:90",
                "lut_eval": "src/repro/kernels/lut_eval.py:47"}
    launches = {"lut_eval6": launches6,
                "lut_eval": lrec["launches"]["lut_eval"]}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": krec[k]["max_abs_err"], "ms": krec[k]["ms"],
         "plain_ms": krec[k]["plain_ms"], "bound_ms": krec[k]["bound_ms"],
         "bound_by": krec[k]["bound_by"], "library_ms": None,
         "shape": krec[k]["shape"]}
        for k in ("lut_eval6", "lut_eval")]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
