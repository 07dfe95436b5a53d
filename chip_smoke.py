"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the paper's CAD flow and its bit-parallel
functional evaluator, serving of the dense LMs, and the forward and
serving of the Mamba-2 and Hymba families — at full size on the card, and
holds every CUDA kernel against its plain-torch version.  Phases, each
printing one JSON line, in this order; any failure raises, so the script
exits non-zero:

1. device and build: the card, its power limit, the nvcc build of every
   kernel source (one nvcc each, started together);
2. kernel parity: ``lut_eval6`` (the mux-tree kernel: ragged M, N not a
   multiple of 4 and an unaligned view, which take the one-word path),
   its fused level variant ``lut_eval6_level`` (the widest level of the
   suite's grouped layout over a random buffer of its group's height, and
   random levels whose padding rows share one sink row) and ``lut_eval``
   (K = 1..5) bit-exact against their plain versions on the card; the
   6-input kernels' LOP3.LUT and instruction counts per lane word read
   from ``cuobjdump -sass`` (both 4-word kernels present, each at 63-66
   LOP3 per word: the mux tree); the op, the level variant at that widest
   level (against its data's bound: distinct rows read and written once)
   and ``lut_eval`` timed at the main path's shapes (CUDA events and
   device time) beside the plain version and the memory / operation
   bound;
3. LM kernel parity: ``flash_attention`` (causal / not, GQA and MQA,
   G = 5, windows, softcap, queries at the tail, ragged S and T, a long
   split decode, every instantiated head dimension, float32 within 2e-4
   and bfloat16 within 2e-2, and the serving shapes, the decode ones read
   in place from a cache) and ``bitplane_matmul`` (B = 1, 4, 6, 8 and 10,
   ragged M / K / N, M = 1, 8, 16 and 17, the quantized-serving shapes;
   rtol 1e-5 / atol 1e-4, the atol in units of max |W| / 128 beyond
   B = 8, where a one-bit fault's reading is kept beside the sound
   one's) against their plain versions on the card, every kernel variant
   among them (flash: mma, split, ffma; bitplane: tensor_core, small_m,
   ffma); each main shape timed (CUDA events, and device time per kernel
   under the profiler) beside the plain version, the bound and one
   library call (SDPA; ``torch.matmul`` on the dequantized weight);
4. SSM kernel parity: ``ssd_scan`` (the reference test's shapes, L < 128,
   the smoke heads, ragged P blocks, N = 16 and 128, B and C sliced from
   an odd-width projection, mamba2's and hymba's layer shapes; float32
   (ffma) within 3e-4, bfloat16 (mma, also against the plain version that
   rounds as it does) within 2e-2; model-like inputs at both layer shapes
   held normwise) and ``popcount_matmul`` (both modes, ragged shapes, one
   word, k_bits < 32 words, a binarised kratos-dd FFN ``wi``; bit-exact)
   against their plain versions on the card, each main shape timed (CUDA
   events and device time) beside the plain version, the bound and, for
   the binary GEMM, ``torch.matmul`` on the unpacked bits; the SSD scan
   also on the score path it did not choose (shared across heads or
   formed per CTA);
5. flow: Kratos + Koios + VTR at scale 1.0 packed under baseline / DD5 /
   DD6 with the equivalence gate on, geomean area / critical-path / ADP
   ratios per suite;
6. suite evaluation: all 17 circuits at 4096 lane words (131,072 vectors
   per circuit), grouped and per-circuit, cold and warm, equal to each
   other, to the plain-version path and to the Python oracle on sampled
   words; every LUT level one launch of the level variant (launches and
   variants equal to the plans'), and ``flow.eval_mode_cost_model``'s pick
   beside both warm walls;
7. profile: one warm grouped, then one warm per-circuit suite evaluation
   under ``torch.profiler`` (device time by kernel and copy, the copies by
   name, kernels launched, device idle share, host hot spots);
8. equivalence through the card: ``conv2d-fu`` and ``conv1d-fu`` under
   DD5 proven by lane simulation on the fused evaluator;
9. per-level baseline: the Fig. 9 stress workload through ``lut_eval``,
   equal to the fused evaluator;
10. serve: ``kratos-dd`` at full width — a float32 gate run (kernel path
    against the plain path and the teacher-forced forward, within 5e-3,
    identical greedy tokens), a bfloat16 gate (the float32 plain run's
    tokens forced through the bfloat16 kernel and plain paths: kernel
    logits within ``max(5e-3, 4 x`` the bfloat16 plain path's own
    disagreement with float32``)``, and within ``max(5e-3, 4 x`` its
    disagreement with float32 activations on the same weights``)`` of the
    bfloat16 plain path with every greedy token agreeing) and a timed
    bfloat16 run whose flash launches are counted (12 layers x 64 steps:
    one mma call per layer for the prefill, split calls for the decode
    steps); then profile_decode, a warm bfloat16 prefill and decode step
    under ``torch.profiler``;
11. serve_gemma2: ``gemma2-2b`` at full width, the same gates with a
    prompt of 4608 tokens so that the local layers' window of 4096 bites,
    a timed bfloat16 run, and its profile_decode;
12. quantized: the quantized-serving flow on ``kratos-dd`` — every
    layer's FFN ``wi`` as 6 bit-planes through ``bitplane_matmul`` at 8
    rows (the small_m variant) and 4096 rows (tensor_core);
13. ssm_mamba2: ``mamba2-2.7b`` at full width — a float32 gate (the
    kernel-path forward against the plain forward at 512 tokens; cached
    serving of a 497-token prompt and 16 new tokens against the plain
    serving run and the kernel-path forward, within 5e-3, identical
    greedy tokens; ``ssd_scan`` on its ffma variant), a bfloat16 forward
    gate at 512 tokens (the kernel path, on the mma variant, against the
    bfloat16 plain forward within ``max(5e-3, 4 x`` the plain path's
    disagreement with float32 activations``)``, argmax bounded alike), a
    timed bfloat16 forward (2 x 4096, 64 ``ssd_scan`` launches, all mma)
    and a timed bfloat16 serving run (8 x 512, 32 new tokens);
14. profile_ssm: a warm mamba2 forward and decode step under
    ``torch.profiler``;
15. ssm_hymba: ``hymba-1.5b`` at full width, the same gate, a timed
    forward at 2 x 2048 (the window of 1024 bites; 32 ``ssd_scan`` and 32
    ``flash_attention`` launches) and a timed serving run with 2048-token
    prompts (32 flash launches per step); then its profile_ssm;
16. summary: the ``kernels`` line (all six kernels; for those with
    variants, each variant's calls on the main paths; ``lut_eval6``'s
    times and bound are its level variant's, the one the main paths
    launch, with the op's beside), the card line, and as the last line
    ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each phase that drives the main
path and read just after; the parity phases' launches are not counted.
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
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
BITPLANE_SOURCE = "src/repro_torch/kernels/csrc/bitplane_matmul.cu"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
POPCOUNT_SOURCE = "src/repro_torch/kernels/csrc/popcount_matmul.cu"

#: H100 SXM peaks used for the bounds: HBM3 bandwidth (NVIDIA data sheet)
#: and int32 logic throughput (132 SMs x 64 INT32 lanes per clock x 1.98 GHz
#: boost, Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: dense bfloat16 tensor-core and float32 CUDA-core peaks (NVIDIA H100 SXM
#: data sheet, without sparsity)
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

#: the global layers' window, as the models pass it (``blocks.HUGE_WINDOW``)
HUGE_WINDOW = 1 << 30
#: the reference's own bound between cached and teacher-forced logits
#: (``tests/train/test_substrate.py``), used for every serve comparison
SERVE_TOL = 5e-3


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


def device_ms(fn, calls: int = 20) -> tuple[float, list[dict]]:
    """Device time per ``fn()`` on the card: the summed duration of every
    kernel and copy that ``calls`` back-to-back calls ran, under
    ``torch.profiler``, over ``calls``; and the same per kernel name.
    Unlike :func:`time_ms` it leaves out the host's time between launches,
    which sets the pace of back-to-back calls that take the device only a
    few microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and not e.key.startswith("Activity Buffer")]
    by_name = [{"name": e.key[:80],
                "ms": e.self_device_time_total / 1e3 / calls}
               for e in dev]
    return sum(k["ms"] for k in by_name), by_name


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


#: lut_eval6 parity shapes beyond the main one: ragged M, N not a multiple
#: of 4 (the one-word path), one word
LUT6_CASES = [(2330, 4096), (513, 3), (1, 1), (300, 129), (64, 4098)]
#: the level variant on random buffers: (rows, LUTs, words), a fifth of
#: the LUTs padding rows that all write one sink row
LEVEL_CASES = [(5000, 2330, 4096), (100, 20, 3), (300, 64, 129)]


def lut_sass_counts() -> dict:
    """LOP3.LUT and all instructions of each 6-input LUT kernel in the
    built library (``cuobjdump -sass``), in all and per lane word (over the
    words one thread evaluates)."""
    import re

    from repro_torch.kernels import build
    from repro_torch.kernels.lut_eval import words_per_thread

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    check(tool.exists(), f"cuobjdump not found at {tool}")
    sass = subprocess.run([str(tool), "-sass",
                           str(build.library_path("lut_eval"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?(lut_eval6(?:_level)?_kernel)ILi(\d)E",
                      line)
        if m:
            fn = f"{m.group(1)}<{m.group(2)}>"
            counts[fn] = {"vec": int(m.group(2)), "lop3": 0,
                          "instructions": 0}
            continue
        if "Function :" in line:
            fn = None
        elif fn and re.search(r"/\*[0-9a-f]{4}\*/", line):
            counts[fn]["instructions"] += 1
            counts[fn]["lop3"] += "LOP3.LUT" in line
    for rec in counts.values():
        words = words_per_thread(rec["vec"])
        rec["words_per_thread"] = words
        rec["lop3_per_word"] = rec["lop3"] / words
        rec["instructions_per_word"] = rec["instructions"] / words
    return counts


#: LOP3.LUT per lane word the 4-word 6-input kernels may compile to: the
#: mux tree's 63 selects plus a few of the index arithmetic (a sum of
#: products takes ~260)
LOP3_PER_WORD = (63, 66)


def check_lut_sass(sass: dict) -> None:
    """Both 4-word 6-input kernels are in ``sass`` (from
    :func:`lut_sass_counts`) and each compiled to a mux tree: between
    ``LOP3_PER_WORD`` LOP3.LUT per lane word."""
    lo, hi = LOP3_PER_WORD
    for name in ("lut_eval6_kernel<4>", "lut_eval6_level_kernel<4>"):
        check(name in sass, f"{name} not found in the SASS of the library")
        per_word = sass[name]["lop3_per_word"]
        check(lo <= per_word <= hi,
              f"{name}: {per_word} LOP3 per word, the mux tree needs "
              f"{lo}-{hi}")


def widest_grouped_level(nets: list, device) -> dict:
    """The widest LUT level of the suite's grouped layout (the groups that
    ``evaluate_suite(mode="grouped")`` runs): its index and table tensors
    on ``device``, the LUT rows it holds (real and padding), and the height
    of its group's value buffer.  The tensors are uploaded here, apart
    from the group program's own cache, so that the suite phase's cold run
    still uploads its plan."""
    from repro_torch.core.eval_torch import (_device_buckets,
                                             get_group_program,
                                             group_plans_by_envelope,
                                             plan_netlist)

    groups = group_plans_by_envelope([plan_netlist(n) for n in nets])
    best = None
    for members in groups:
        prog = get_group_program([nets[i] for i in members])
        for bi, bk in enumerate(prog.member_plans[0].buckets):
            width = bk.shape[1] * len(members)
            if prog.flags[bi][0] and (best is None or width > best[0]):
                best = (width, members, prog, bi)
    width, members, prog, bi = best
    real = [sum(int((p.buckets[bi].lut_out[r] != p.sink).sum())
                for p in prog.member_plans)
            for r in range(prog.member_plans[0].buckets[bi].n_levels)]
    r = int(np.argmax(real))
    bk = _device_buckets(prog.member_plans, prog.flags, prog.n_signals + 1,
                         device)[bi]
    return {"group": [nets[i].name for i in members], "bucket": bi,
            "level": r, "luts": width, "real_luts": real[r],
            "member_rows": prog.n_signals + 1,
            "rows": len(members) * (prog.n_signals + 1),
            "ins": bk.lut_ins[r], "tt_lo": bk.tt_lo[r], "tt_hi": bk.tt_hi[r],
            "out": bk.lut_out[r]}


def _level_buffer(rng, rows: int, member_rows: int, n_words: int, device):
    """A random value buffer whose members' CONST0 / CONST1 rows hold
    their constants."""
    vals = _random_words(rng, (rows, n_words), device)
    vals[0::member_rows] = 0
    vals[1::member_rows] = -1
    return vals


def level_rows_once_bound(level: dict, n_words: int) -> dict:
    """The level's bound from what its data needs: the table words, each
    distinct row that a LUT with a table other than 0 reads (LUTs share
    fanins) read once and each distinct row it writes written once,
    against the mux tree's operations on the LUTs whose table is not 0.
    A zero table (the padding rows, whose pins all read CONST0) gives 0
    whatever its pins.  ``lut_bound_ms`` of the level's ``[M, 6, N]``
    counts every pin row of every LUT as read from memory."""
    live = (level["tt_lo"] != 0) | (level["tt_hi"] != 0)
    n_live = int(live.sum())
    rows_in = int(level["ins"][live].unique().numel())
    rows_out = int(level["out"].unique().numel())
    nbytes = 4 * n_words * (rows_in + rows_out) + 8 * level["luts"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lut_bound_ms(n_live, 6, n_words, 2)["ops_ms"]
    return {"nonzero_tables": n_live, "rows_read": rows_in,
            "rows_written": rows_out, "bytes": nbytes,
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def random_level(rng, rows: int, M: int, n_words: int, device,
                 unaligned: bool = False):
    """A random level of ``M`` LUTs over a random buffer of ``rows`` rows,
    laid out as the planner lays one out: outputs on distinct rows that no
    pin reads, every fifth LUT a padding row (table 0, pins on CONST0,
    output on the last row, the sink, shared by all of them), and every
    seventh of the others a real LUT whose table is 0 (its output row
    must be zeroed over the random buffer's contents).
    ``unaligned`` puts the buffer one word past a 16-byte boundary."""
    import torch

    if unaligned:
        flat = _random_words(rng, (rows * n_words + 1,), device)
        vals = flat[1:].view(rows, n_words)
        vals[0], vals[1] = 0, -1
    else:
        vals = _level_buffer(rng, rows, rows, n_words, device)
    perm = torch.from_numpy(rng.permutation(rows - 3) + 2).to(device)
    out_idx = perm[:M].clone()
    pool = perm[M:]
    ins_idx = pool[torch.from_numpy(
        rng.integers(0, pool.numel(), (M, 6))).to(device)]
    lo = _random_words(rng, (M,), device)
    hi = _random_words(rng, (M,), device)
    pad = torch.arange(M, device=device) % 5 == 0
    lo[3::7] = 0
    hi[3::7] = 0
    out_idx[pad] = rows - 1
    ins_idx[pad] = 0
    lo[pad] = 0
    hi[pad] = 0
    return vals, ins_idx, lo, hi, out_idx


def level_parity(device, level: dict | None, cases=LEVEL_CASES,
                 n_words: int = N_LANE_WORDS, seed: int = 1) -> dict:
    """``ops.lut_eval6_level`` (the kernel on the card) against its plain
    version on copies of the same buffer, bit for bit over the whole
    buffer: on ``level`` (a real suite level from
    :func:`widest_grouped_level`) over a random buffer of its group's
    height, on random levels with duplicate sink rows, and on an
    unaligned buffer (the one-word path)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    runs = []
    if level is not None:
        vals = _level_buffer(rng, level["rows"], level["member_rows"],
                             n_words, device)
        runs.append(("suite level", (vals, level["ins"], level["tt_lo"],
                                     level["tt_hi"], level["out"])))
    for rows, M, N in cases:
        runs.append((f"random {rows}x{N}, {M} LUTs",
                     random_level(rng, rows, M, N, device)))
    runs.append(("unaligned 300x128, 64 LUTs",
                 random_level(rng, 300, 64, 128, device, unaligned=True)))
    errs = {}
    for label, (vals, ins, lo, hi, out) in runs:
        got = ops.lut_eval6_level(vals.clone(), ins, lo, hi, out)
        want = ops.lut_eval6_level(vals.clone(), ins, lo, hi, out,
                                   use_kernel=False)
        _sync(device)
        e = _max_abs_err(got, want)
        check(e == 0, f"lut_eval6_level differs from its plain version on "
                      f"{label} (max abs err {e})")
        errs[label] = e
    return errs


def kernel_parity(device, main_shapes: dict, level: dict) -> dict:
    """Each LUT kernel against its plain version on the card over random
    inputs (ragged shapes, N not a multiple of 4, an unaligned view,
    equal-table rows, zero-table rows; the level variant on a real suite level and on
    random levels with duplicate sink rows), then timed at the main
    path's shapes (CUDA events and device time).  Returns per-kernel
    records for the summary line."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_eval import vector_width

    rng = np.random.default_rng(0)
    M6, N6 = main_shapes["lut_eval6"]
    err6 = 0
    cases = [(M6, N6, False)] + [(M, N, False) for M, N in LUT6_CASES] \
        + [(300, 128, True)]
    paths = {}
    for M, N, unaligned in cases:
        if unaligned:  # one word past a 16-byte boundary: one-word path
            flat = _random_words(rng, (M * 6 * N + 1,), device)
            ins = flat[1:].view(M, 6, N)
        else:
            ins = _random_words(rng, (M, 6, N), device)
        lo = _random_words(rng, (M,), device)
        hi = _random_words(rng, (M,), device)
        hi[::2] = lo[::2]   # narrower LUTs replicate their table
        lo[1::7] = 0        # zero tables (the level kernel skips them)
        hi[1::7] = 0
        got = ops.lut_eval6(ins, lo, hi, use_kernel=True)
        want = ops.lut_eval6(ins, lo, hi, use_kernel=False)
        torch.cuda.synchronize()
        e = _max_abs_err(got, want)
        check(e == 0, f"lut_eval6 differs from its plain version at "
                      f"M={M} N={N} unaligned={unaligned} (max abs err {e})")
        err6 = max(err6, e)
        paths[f"{M}x{N}{' unaligned' if unaligned else ''}"] = \
            vector_width(N, ins)
    level_errs = level_parity(device, level)
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

    sass = lut_sass_counts()
    check_lut_sass(sass)

    recs = {}
    ins = _random_words(rng, (M6, 6, N6), device)
    lo = _random_words(rng, (M6,), device)
    hi = _random_words(rng, (M6,), device)
    dev6, kern6 = device_ms(lambda: ops.lut_eval6(ins, lo, hi))
    vals = _level_buffer(rng, level["rows"], level["member_rows"], N6,
                         device)
    largs = (vals, level["ins"], level["tt_lo"], level["tt_hi"],
             level["out"])
    dev_l, kern_l = device_ms(lambda: ops.lut_eval6_level(*largs))
    # the headline is the level variant's, the one the main paths launch:
    # its bound is its data's (rows read and written once), with the
    # [M, 6, N] figure that counts every pin row beside it
    pin_rows = lut_bound_ms(level["luts"], 6, N6, 2)
    recs["lut_eval6"] = {
        "variant": "level", "group": level["group"],
        "bucket": level["bucket"], "level": level["level"],
        "shape": [level["luts"], 6, N6], "real_luts": level["real_luts"],
        "buffer_rows": level["rows"],
        "max_abs_err": max(err6, *level_errs.values()),
        "level_max_abs_err": level_errs,
        "ms": time_ms(lambda: ops.lut_eval6_level(*largs)),
        "device_ms": dev_l, "kernels": kern_l,
        "plain_ms": time_ms(lambda: ops.lut_eval6_level(
            *largs, use_kernel=False), reps=3, inner=2),
        **level_rows_once_bound(level, N6),
        "pin_rows_bound_ms": pin_rows["bound_ms"],
        "pin_rows_bound_by": pin_rows["bound_by"], "sass": sass,
        "op": {
            "shape": [M6, 6, N6], "max_abs_err": err6,
            "ms": time_ms(lambda: ops.lut_eval6(ins, lo, hi)),
            "device_ms": dev6, "kernels": kern6,
            "plain_ms": time_ms(lambda: ops.lut_eval6(ins, lo, hi,
                                                      use_kernel=False),
                                reps=3, inner=2),
            **lut_bound_ms(M6, 6, N6, 2), "vector_width": paths}}
    M5, K5 = main_shapes["lut_eval"]
    ins5 = _random_words(rng, (M5, K5, N6), device)
    tts = _random_words(rng, (M5,), device)
    dev5, kern5 = device_ms(lambda: ops.lut_eval(ins5, tts))
    recs["lut_eval"] = {
        "shape": [M5, K5, N6], "max_abs_err": err,
        "ms": time_ms(lambda: ops.lut_eval(ins5, tts)),
        "device_ms": dev5, "kernels": kern5,
        "plain_ms": time_ms(lambda: ops.lut_eval(ins5, tts,
                                                 use_kernel=False),
                            reps=3, inner=2),
        **lut_bound_ms(M5, K5, N6, 1)}
    return recs


# ---------------------------------------------------------------------------
# LM kernels: parity and timing
# ---------------------------------------------------------------------------


def visible_pairs(S: int, T: int, causal: bool, window) -> int:
    """(query, key) pairs attention must compute when the S queries sit
    at the tail of T keys: key k is visible to the query at position q
    when ``k <= q`` (causal) and ``k > q - window``."""
    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(qpos, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def visible_keys(S: int, T: int, window) -> int:
    """Keys that at least one of the S tail queries can see: those from
    the earliest query's window start to the last key."""
    return T - (max(0, T - S - window + 1) if window else 0)


def flash_bound_ms(B, Hq, Hkv, S, T, D, elem_bytes, causal, window) -> dict:
    """Least time for one attention call: 4 D FLOPs per visible pair
    (q.k and p.v) over the peak of the input type (bf16 tensor cores,
    fp32 CUDA cores), against q read and o written once, and k and v read
    once for every key some query can see, over the HBM rate."""
    flops = 4 * B * Hq * visible_pairs(S, T, causal, window) * D
    nbytes = elem_bytes * (2 * B * Hq * S * D +
                           2 * B * Hkv * visible_keys(S, T, window) * D)
    peak = BF16_FLOPS if elem_bytes == 2 else FP32_FLOPS
    return _bound(flops, peak, nbytes)


def bitplane_bound_ms(M: int, K: int, N: int, B: int) -> dict:
    """Least time for ``[M, K] x [B, K, N]``: the planes, x and the scale
    read once and y written once over the HBM rate, against the
    operations of the cheapest exact design.  For B <= 8 the folded W is
    an integer that bfloat16 holds exactly and x splits exactly into three
    bfloat16 parts, so the product is 3 x 2 M K N FLOPs at the bf16
    tensor-core peak; for B > 8 it is 2 M K N float32 FLOPs at the
    CUDA-core peak.  The float32 CUDA-core figure is kept beside it under
    ``fp32_*`` (a reading against it can exceed 100 %)."""
    nbytes = 4 * (B * K * N + M * K + M * N + N)
    fp32 = _bound(2 * M * K * N, FP32_FLOPS, nbytes)
    best = _bound(3 * 2 * M * K * N, BF16_FLOPS, nbytes) if B <= 8 else fp32
    return {**best, "fp32_flops": fp32["flops"],
            "fp32_bound_ms": fp32["bound_ms"],
            "fp32_bound_by": fp32["bound_by"]}


def _bound(flops: int, peak: float, nbytes: int) -> dict:
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": t_ops,
            "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


#: (label, B, Hq, Hkv, S, T, causal, window, softcap), run at every head
#: dimension and in both types
FLASH_CASES = [
    ("causal", 2, 4, 4, 100, 100, True, None, None),
    ("bidirectional_gqa2", 1, 4, 2, 70, 70, False, None, None),
    ("mqa_window_softcap", 2, 4, 1, 130, 130, True, 48, 30.0),
    ("tail_ragged_window", 1, 4, 2, 37, 201, True, 64, None),
    ("decode_softcap", 3, 4, 2, 1, 77, True, None, 50.0),
    ("window_not_causal", 1, 2, 1, 90, 90, False, 40, None),
    # the split (decode) variant over many splits, gemma2's G = 2
    ("split_decode_long", 1, 8, 4, 1, 4616, True, 4096, 50.0),
    # hymba's G = 5: a split call (15 rows) and an mma call
    ("gqa5_split", 2, 10, 2, 3, 150, True, 64, None),
    ("gqa5_prefill", 1, 25, 5, 70, 90, True, 48, None),
    ("tail_s2", 2, 4, 4, 2, 130, True, None, 30.0),
    # more kv groups than the split CTAs wanted: one split, no combine
    ("decode_one_split", 34, 4, 4, 1, 40, True, None, None),
]
FLASH_DIMS = (16, 32, 64, 128, 256)
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}

#: the serving path's attention calls: (label, B, Hq, Hkv, S, T, D,
#: causal, window, softcap, dtype, cache_len).  A call with a cache length
#: reads k / v in place from a ``[B, cache_len, H, D]`` cache sliced to T,
#: as decode does.
FLASH_MAIN = [
    ("kratos-dd prefill", 8, 12, 12, 512, 512, 64, True, HUGE_WINDOW, None,
     "bfloat16", None),
    ("kratos-dd decode", 8, 12, 12, 1, 576, 64, True, HUGE_WINDOW, None,
     "bfloat16", 640),
    ("kratos-dd gate prefill fp32", 2, 12, 12, 128, 128, 64, True,
     HUGE_WINDOW, None, "float32", None),
    ("gemma2-2b local prefill", 2, 8, 4, 4608, 4608, 256, True, 4096, 50.0,
     "bfloat16", None),
    ("gemma2-2b decode local", 2, 8, 4, 1, 4616, 256, True, 4096, 50.0,
     "bfloat16", 4624),
    ("gemma2-2b decode global", 2, 8, 4, 1, 4616, 256, True, HUGE_WINDOW,
     50.0, "bfloat16", 4624),
    ("hymba-1.5b prefill local", 2, 25, 5, 2048, 2048, 64, True, 1024, None,
     "bfloat16", None),
    ("hymba-1.5b decode local", 8, 25, 5, 1, 2064, 64, True, 1024, None,
     "bfloat16", 2080),
    ("hymba-1.5b decode global", 8, 25, 5, 1, 2064, 64, True, HUGE_WINDOW,
     None, "bfloat16", 2080),
]

#: (M, K, N, B): ragged shapes with random {0, 1} planes; K is kept where
#: the reference's own kernel tests hold it for B = 8
BITPLANE_CASES = [(1, 1, 1, b) for b in (1, 4, 6, 8)] + \
    [(65, 130, 70, b) for b in (1, 4, 6, 8)] + \
    [(37, 200, 129, 6), (130, 768, 257, 4), (3, 768, 100, 1)] + \
    [(1, 130, 70, 6), (8, 201, 128, 8), (16, 77, 4096, 6), (17, 77, 36, 6),
     (8, 768, 130, 3)] + \
    [(65, 130, 70, 10), (8, 100, 64, 10)]
#: the quantized-serving shapes (kratos-dd's FFN wi as 6 planes)
BITPLANE_MAIN = [(8, 768, 4096, 6), (4096, 768, 4096, 6)]
BITPLANE_RTOL, BITPLANE_ATOL = 1e-5, 1e-4


def bitplane_atol(B: int) -> float:
    """The absolute tolerance for ``B`` planes: ``BITPLANE_ATOL`` where the
    reference's tests set it (B <= 8, |W| <= 128).  Every float32 rounding
    term of either version scales with max |W| = 2^(B-1), so beyond that
    the same tolerance is kept in units of max |W| / 128 (x4 at B = 10,
    where the two float32 versions differ by up to ~8.5e-4 on an H100)."""
    return BITPLANE_ATOL * 2.0 ** max(0, B - 8)


def _dtype(name: str):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _attn_inputs(gen, B, Hq, Hkv, S, T, D, dtype, device, cache_len=None):
    """q ``[B, Hq, S, D]`` and k / v ``[B, Hkv, T, D]`` as the model hands
    them over: transposed views of ``[B, S, H, D]`` activations, k / v
    sliced from a longer cache when ``cache_len`` is given."""
    import torch

    def act(s, h):
        return torch.randn((B, s, h, D), generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    q = act(S, Hq).transpose(1, 2)
    T_buf = cache_len if cache_len else T
    k = act(T_buf, Hkv)[:, :T].transpose(1, 2)
    v = act(T_buf, Hkv)[:, :T].transpose(1, 2)
    return q, k, v


def _within(got, want, rtol: float, atol: float) -> tuple[bool, float]:
    import torch

    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    return bool(torch.allclose(g, w, rtol=rtol, atol=atol)), err


def flash_parity(device, cases=FLASH_CASES, dims=FLASH_DIMS,
                 dtypes=("float32", "bfloat16"), seed: int = 0) -> dict:
    """``flash_attention`` against its plain version on every case, head
    dimension and type; raises on the first disagreement.  Returns the
    largest error per type."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(seed)
    worst = {}
    for dt in dtypes:
        worst[dt] = 0.0
        for D in dims:
            for label, B, Hq, Hkv, S, T, causal, window, softcap in cases:
                q, k, v = _attn_inputs(gen, B, Hq, Hkv, S, T, D, _dtype(dt),
                                       device)
                kw = dict(causal=causal, window=window, softcap=softcap)
                got = ops.flash_attention(q, k, v, **kw)
                want = ops.flash_attention(q, k, v, use_kernel=False, **kw)
                ok, err = _within(got, want, FLASH_TOL[dt], FLASH_TOL[dt])
                check(ok and got.dtype == want.dtype,
                      f"flash_attention {label} D={D} {dt} differs from "
                      f"its plain version (max abs err {err})")
                worst[dt] = max(worst[dt], err)
    return worst


def bitplane_parity(device, cases=BITPLANE_CASES, seed: int = 0,
                    faults: list | None = None) -> float:
    """``bitplane_matmul`` against its plain version on random planes;
    raises on the first disagreement.  Returns the largest error.

    For B > 8, where :func:`bitplane_atol` widens the tolerance, a record
    per case goes into ``faults`` when it is given: the kernel run again
    with one bit of the lowest plane (coefficient 1) flipped where that
    moves y least, its error against the sound plain result and whether
    the tolerance rejects it, beside the sound run's error."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(seed)
    worst = 0.0
    for M, K, N, B in cases:
        x = torch.randn((M, K), generator=gen, device=device)
        planes = torch.randint(0, 2, (B, K, N), generator=gen,
                               device=device).float()
        scale = torch.randn((N,), generator=gen, device=device) * 0.1
        got = ops.bitplane_matmul(x, planes, scale)
        want = ops.bitplane_matmul(x, planes, scale, use_kernel=False)
        ok, err = _within(got, want, BITPLANE_RTOL, bitplane_atol(B))
        check(ok, f"bitplane_matmul M={M} K={K} N={N} B={B} differs from "
                  f"its plain version (max abs err {err})")
        worst = max(worst, err)
        if B > 8 and faults is not None:
            effect = x.abs().amax(0)[:, None] * scale.abs()[None, :]
            k, n = divmod(int(effect.argmin()), N)
            bad = planes.clone()
            bad[0, k, n] = 1.0 - bad[0, k, n]
            caught, ferr = _within(ops.bitplane_matmul(x, bad, scale), want,
                                   BITPLANE_RTOL, bitplane_atol(B))
            faults.append({"shape": [M, K, N, B], "atol": bitplane_atol(B),
                           "sound_err": err, "fault_err": ferr,
                           "fault_rejected": not caught})
    return worst


def quantized_planes(gen, K: int, N: int, bits: int, device):
    """6-bit planes and scale of a weight drawn as the model's
    ``init_dense`` draws it."""
    import torch

    from repro_torch.quant.bitplane import quantize_bitplanes

    w = torch.randn((K, N), generator=gen, device=device) * K ** -0.5
    return quantize_bitplanes(w, bits)


def sdpa_backend(q, k, v, is_causal: bool) -> list[str]:
    """Names of the device kernels one SDPA call ran (which backend)."""
    import torch.nn.functional as F

    _, by_name = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=is_causal), calls=1)
    return sorted(k["name"] for k in by_name)


def lm_kernel_parity(device) -> dict:
    """Both LM kernels against their plain versions on the card (every
    case within tolerance, else it raises), then each main-path shape
    timed: kernel, plain version, bound and library call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.bitplane_matmul import \
        variant as bitplane_variant
    from repro_torch.kernels.flash_attention import variant as flash_variant
    from repro_torch.quant.bitplane import dequantize

    torch.backends.cuda.matmul.allow_tf32 = False  # the library yardstick
    flash_err = flash_parity(device)
    gen = torch.Generator(device=device).manual_seed(1)
    flash_main = []
    for (label, B, Hq, Hkv, S, T, D, causal, window, softcap, dt,
         cache_len) in FLASH_MAIN:
        q, k, v = _attn_inputs(gen, B, Hq, Hkv, S, T, D, _dtype(dt), device,
                               cache_len)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q, k, v, use_kernel=False, **kw)
        ok, err = _within(got, want, FLASH_TOL[dt], FLASH_TOL[dt])
        check(ok, f"flash_attention {label} differs from its plain version "
                  f"(max abs err {err})")
        heavy = S * T > 1 << 22
        rec = {"label": label, "q": [B, Hq, S, D], "kv": [B, Hkv, T, D],
               "variant": flash_variant(q.dtype, S, Hq // Hkv),
               "dtype": dt, "causal": causal, "window": window,
               "softcap": softcap, "kv_from_cache": cache_len is not None,
               "max_abs_err": err,
               "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
               "plain_ms": time_ms(lambda: ops.flash_attention(
                   q, k, v, use_kernel=False, **kw),
                   reps=3 if heavy else 10, inner=2 if heavy else 10),
               **flash_bound_ms(B, Hq, Hkv, S, T, D, q.element_size(),
                                causal, window)}
        # SDPA computes the same function only without softcap and with
        # the window wider than the keys; its is_causal aligns the mask
        # top-left, which is the tail alignment only when S == T (and a
        # single tail query sees every key)
        rec["device_ms"], rec["kernels"] = device_ms(
            lambda: ops.flash_attention(q, k, v, **kw))
        if softcap is None and Hq == Hkv and window >= T:
            is_causal = causal and S == T

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=is_causal)

            rec["library_ms"] = time_ms(sdpa)
            rec["library_device_ms"] = device_ms(sdpa)[0]
            rec["library_kernels"] = sdpa_backend(q, k, v, is_causal)
        else:
            rec["library_ms"] = rec["library_device_ms"] = None
        flash_main.append(rec)
        del q, k, v, got, want

    bit_faults = []
    bit_err = bitplane_parity(device, faults=bit_faults)
    bit_main = []
    for M, K, N, B in BITPLANE_MAIN:
        planes, scale = quantized_planes(gen, K, N, B, device)
        x = torch.randn((M, K), generator=gen, device=device)
        got = ops.bitplane_matmul(x, planes, scale)
        want = ops.bitplane_matmul(x, planes, scale, use_kernel=False)
        ok, err = _within(got, want, BITPLANE_RTOL, BITPLANE_ATOL)
        check(ok, f"bitplane_matmul [{M}, {K}] x [{B}, {K}, {N}] differs "
                  f"from its plain version (max abs err {err})")
        w = dequantize(planes, scale)
        dev_ms, kernels = device_ms(
            lambda: ops.bitplane_matmul(x, planes, scale))
        bit_main.append({
            "shape": [M, K, N, B], "variant": bitplane_variant(M, B),
            "max_abs_err": err,
            "ms": time_ms(lambda: ops.bitplane_matmul(x, planes, scale)),
            "device_ms": dev_ms, "kernels": kernels,
            "plain_ms": time_ms(lambda: ops.bitplane_matmul(
                x, planes, scale, use_kernel=False)),
            "library_ms": time_ms(lambda: torch.matmul(x, w)),
            "library_device_ms": device_ms(lambda: torch.matmul(x, w))[0],
            **bitplane_bound_ms(M, K, N, B)})
    return {"phase": "lm_kernel_parity",
            "flash_attention": {"max_abs_err": flash_err,
                                "cases": len(FLASH_CASES) * len(FLASH_DIMS)
                                * 2, "main": flash_main},
            "bitplane_matmul": {"max_abs_err": bit_err,
                                "cases": len(BITPLANE_CASES),
                                "b_gt_8_faults": bit_faults,
                                "main": bit_main}}


# ---------------------------------------------------------------------------
# SSM kernels (ssd_scan) and the binary GEMM (popcount_matmul): parity and
# timing
# ---------------------------------------------------------------------------

#: (Bb, L, H, P, N): the reference test's shapes, lengths under one chunk
#: (L = 24: one short chunk), the smoke configs' heads (H 4, P 16, N 8),
#: P that is not a multiple of the P block (40 in 16-wide blocks, 48 in
#: 32-wide ones: 72 heads give the mma variant those; 21: odd, staged and
#: stored element by element) and N = 16 and 128; each in float32 (ffma)
#: and bfloat16 (mma)
SSD_CASES = [(1, 128, 2, 16, 8), (2, 256, 2, 32, 16), (1, 512, 4, 16, 32),
             (2, 64, 3, 16, 8), (1, 24, 4, 16, 8), (2, 256, 4, 16, 8),
             (2, 256, 4, 40, 16), (2, 128, 72, 48, 16), (1, 128, 2, 21, 16),
             (1, 256, 3, 64, 128)]
#: B and C as column slices of an odd-width projection, as hymba's are
#: (rows 2N + 3 elements apart, odd offsets): the mma variant stages them
#: element by element
SSD_SLICED_CASES = [(2, 256, 5, 64, 16)]
#: the model paths' layer shapes: (label, Bb, L, H, P, N)
SSD_MAIN = [("mamba2-2.7b", 2, 4096, 80, 64, 128),
            ("hymba-1.5b", 2, 2048, 25, 64, 16)]
#: the reference's own kernel-test tolerance (rtol = atol) in float32;
#: bfloat16 output rounding in bfloat16
SSD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}
#: (rtol, atol) of the mma variant against ``ref.ssd_scan_mma_ref``, which
#: rounds where the kernel rounds: two to four bfloat16 ulps of the output
#: (2^-6 of it), and 2^-8 beyond, 2.7x the largest absolute part measured
#: beyond one ulp (1.46e-3 over every case and main shape on an H100,
#: where the largest difference was 2^-8; PERF.md)
MMA_REF_TOL = (2.0 ** -6, 2.0 ** -8)
#: (M, N, words): the reference test's shapes and the microbenchmark's,
#: then M and N off the 128 x 128 tile, one word, more words than the
#: kernel stages at once; both modes, xnor with k_bits = 32 words
POPCOUNT_CASES = [(4, 4, 1), (16, 8, 2), (130, 70, 3), (256, 128, 4),
                  (256, 256, 8), (257, 129, 1), (33, 17, 3), (300, 200, 40)]
#: (M, N, words, k_bits): xnor with k_bits < 32 words (the padding bits
#: are counted as the reference counts them)
POPCOUNT_KBITS_CASES = [(130, 70, 3, 70), (257, 129, 1, 20),
                        (64, 136, 24, 700)]
#: a binarised kratos-dd FFN wi: 4096 rows of 768 bits against 4096
#: output columns, xnor
POPCOUNT_MAIN = (4096, 4096, 24)
#: population counts per second: 16 per clock per SM for compute
#: capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
#: throughput table) x 132 SMs x 1.98 GHz boost (H100 SXM): the bound of
#: the first port's __popc kernel, kept beside the tensor-core one
POPC_PER_S = 16 * 132 * 1.98e9
#: dense int8 tensor-core peak (NVIDIA H100 SXM data sheet)
INT8_OPS_PER_S = 1979e12


def ssd_inputs(gen, Bb, L, H, P, N, dtype, device, model_like=False,
               sliced=False):
    """Random SSD inputs.  By default drawn as the reference's kernel test
    draws them: x, B, C normal * 0.5 in ``dtype``, dt in [0.001, 0.051),
    A in (-1.5, -0.5], both float32.  With ``model_like`` as a layer of
    the models at init hands them over: x = silu(normal), dt =
    softplus(normal) (steps up to ~4, so a chunk's decay underflows), A =
    -1 (``a_log = 0``), B and C unit normal.  With ``sliced`` B and C
    are column slices of a ``[Bb, L, 2N + 3]`` tensor."""
    import torch
    import torch.nn.functional as F

    def normal(shape, scale=0.5):
        return (torch.randn(shape, generator=gen, device=device) * scale
                ).to(dtype)

    if model_like:
        x = F.silu(normal((Bb, L, H, P), 1.0).float()).to(dtype)
        dt = F.softplus(torch.randn((Bb, L, H), generator=gen,
                                    device=device))
        A = -torch.ones((H,), device=device)
        return x, dt, A, normal((Bb, L, N), 1.0), normal((Bb, L, N), 1.0)
    x = normal((Bb, L, H, P))
    dt = 0.001 + 0.05 * torch.rand((Bb, L, H), generator=gen, device=device)
    A = -0.5 - torch.rand((H,), generator=gen, device=device)
    if sliced:
        proj = normal((Bb, L, 2 * N + 3))
        return x, dt, A, proj[..., 1:1 + N], proj[..., 1 + N:1 + 2 * N]
    return x, dt, A, normal((Bb, L, N)), normal((Bb, L, N))


def ssd_bound_ms(Bb, L, H, P, N, elem_bytes) -> dict:
    """Least time for one SSD scan: the chunked algorithm's FLOPs with the
    score tile C . B^T formed once per (batch, chunk), since B and C are
    shared by the heads: Bb (L / Q) 2 Q^2 N + Bb H (L / Q) (2 Q^2 P +
    4 Q P N) with Q = min(128, L), at the peak of the input type, against
    x, dt, B, C read once and y written once."""
    Q = min(128, L)
    nc = L // Q
    flops = Bb * nc * 2 * Q * Q * N \
        + Bb * H * nc * (2 * Q * Q * P + 4 * Q * P * N)
    nbytes = elem_bytes * (2 * Bb * L * H * P + 2 * Bb * L * N) \
        + 4 * (Bb * L * H + H)
    peak = BF16_FLOPS if elem_bytes == 2 else FP32_FLOPS
    return _bound(flops, peak, nbytes)


def popcount_bound_ms(M: int, N: int, W: int) -> dict:
    """Least time for ``[M, W] x [N, W]`` packed words: the exact integer
    product of the 32 W bits, 2 M N 32 W operations at the dense int8
    tensor-core peak, against x and w read once and y written once.  The
    ``popc_*`` figures are the bound of M N W population counts at the
    card's ``__popc`` rate (the first port's kernel)."""
    ops = 2 * M * N * 32 * W
    t_ops = ops / INT8_OPS_PER_S * 1e3
    nbytes = 4 * (M * W + N * W + M * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_popc = M * N * W / POPC_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": t_ops,
            "bytes_ms": t_bytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "popc_popcounts": M * N * W, "popc_ops_ms": t_popc,
            "popc_bound_ms": max(t_popc, t_bytes)}


def mma_ref_reading(got, want) -> dict:
    """How far an mma call lies from ``ref.ssd_scan_mma_ref``: the largest
    absolute difference, and the absolute part left beyond one bfloat16
    ulp of the output (2^-7 of it), the slack a tolerance needs there."""
    g, w = got.float(), want.float()
    e = (g - w).abs()
    return {"max_abs_err": float(e.max()),
            "beyond_one_ulp": float((e - 2.0 ** -7 * w.abs()).max())}


def check_mma_ref(got, want, label: str) -> dict:
    """An mma call ``got`` held to ``want``, ``ref.ssd_scan_mma_ref`` on
    its inputs, within ``MMA_REF_TOL``; raises otherwise.  Returns the
    :func:`mma_ref_reading`."""
    ok, _ = _within(got, want, *MMA_REF_TOL)
    reading = mma_ref_reading(got, want)
    check(ok and got.shape == want.shape,
          f"ssd_scan {label} (mma) differs from ref.ssd_scan_mma_ref "
          f"beyond {MMA_REF_TOL} ({reading})")
    return reading


def _worse(a: dict, b: dict) -> dict:
    """The keywise maximum of two readings."""
    return {k: max(a.get(k, v), v) for k, v in b.items()}


def ssd_parity(device, cases=SSD_CASES, dtypes=("float32", "bfloat16"),
               seed: int = 0, sliced_cases=SSD_SLICED_CASES) -> dict:
    """``ssd_scan`` against its plain version on every case and type (the
    mma variant's calls on the card also against ``ref.ssd_scan_mma_ref``
    with :func:`check_mma_ref`); raises on the first disagreement.
    Returns the largest error per type and, where mma calls were checked,
    their largest :func:`mma_ref_reading` under ``mma_ref``."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import variant

    gen = torch.Generator(device=device).manual_seed(seed)
    worst = {}
    near = {}
    runs = [(c, False) for c in cases] + [(c, True) for c in sliced_cases]
    for dt_name in dtypes:
        worst[dt_name] = 0.0
        for case, sliced in runs:
            args = ssd_inputs(gen, *case, _dtype(dt_name), device,
                              sliced=sliced)
            got = ops.ssd_scan(*args)
            kind = variant(got.dtype, case[4])
            tol = SSD_TOL[dt_name]
            want = ops.ssd_scan(*args, use_kernel=False)
            ok, err = _within(got, want, tol, tol)
            check(ok and got.dtype == want.dtype
                  and got.shape == want.shape,
                  f"ssd_scan {case} {dt_name} ({kind}) differs from its "
                  f"plain version (max abs err {err})")
            worst[dt_name] = max(worst[dt_name], err)
            if got.is_cuda and kind == "mma":
                near = _worse(near, check_mma_ref(
                    got, ref.ssd_scan_mma_ref(*args), f"{case}"))
    if near:
        worst["mma_ref"] = near
    return worst


def popcount_parity(device, cases=POPCOUNT_CASES,
                    kbits_cases=POPCOUNT_KBITS_CASES, seed: int = 0) -> int:
    """``popcount_matmul`` bit-exact against its plain version in both
    modes on every case (and in mode "xnor" with k_bits < 32 W); raises
    on the first difference.  Returns the largest error (0)."""
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    worst = 0
    runs = [(M, N, W, mode, 32 * W) for M, N, W in cases
            for mode in ("and", "xnor")] + \
        [(M, N, W, "xnor", kb) for M, N, W, kb in kbits_cases]
    for M, N, W, mode, kb in runs:
        x = _random_words(rng, (M, W), device)
        w = _random_words(rng, (N, W), device)
        got = ops.popcount_matmul(x, w, mode=mode, k_bits=kb)
        want = ops.popcount_matmul(x, w, mode=mode, k_bits=kb,
                                   use_kernel=False)
        err = int((got.long() - want.long()).abs().max())
        check(err == 0 and got.dtype == torch.int32,
              f"popcount_matmul {mode} M={M} N={N} W={W} k_bits={kb} "
              f"differs from its plain version (max abs err {err})")
        worst = max(worst, err)
    return worst


def unpack_signs(words, k_bits: int, signed: bool):
    """Packed int32 words ``[R, W]`` -> ``[R, k_bits]`` bfloat16 of the
    bits (0 / 1) or of their signs (-1 / +1)."""
    import torch

    from repro_torch.kernels.ref import unpack_bits

    bits = unpack_bits(words)[:, :k_bits]
    vals = 2 * bits - 1 if signed else bits
    return vals.to(torch.bfloat16)


def at_p_block(args, width: int, want, tol: float) -> dict:
    """The mma variant on the SSD inputs ``args`` with its P block forced
    to ``width`` (the one :func:`repro_torch.kernels.ssd_scan.p_block`
    did not choose), held to the plain output ``want`` within ``tol`` and
    timed as the chosen width is."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss

    chosen = ss.p_block
    ss.p_block = lambda *_, **__: width
    try:
        ok, err = _within(ops.ssd_scan(*args), want, tol, tol)
        check(ok, f"ssd_scan with {width}-wide P blocks differs from its "
                  f"plain version (max abs err {err})")
        dev, kernels = device_ms(lambda: ops.ssd_scan(*args))
        return {"p_block": width, "max_abs_err": err,
                "ms": time_ms(lambda: ops.ssd_scan(*args)),
                "device_ms": dev, "kernels": kernels}
    finally:
        ss.p_block = chosen


def ssm_kernel_parity(device) -> dict:
    """``ssd_scan`` and ``popcount_matmul`` against their plain versions
    on the card, every variant (every case within tolerance / bit-exact,
    else it raises), then each main shape timed: kernel (CUDA events and
    device time), plain version, bound and library call (none computes the
    SSD scan; ``torch.matmul`` on the unpacked bits in bfloat16, timed
    without the unpacking, for the binary GEMM).  At the SSD main shapes
    the mma variant is also held to ``ref.ssd_scan_mma_ref``, that check
    must reject the kernel's output with :func:`drop_diagonal` planted,
    and the variant runs at the P-block width it did not choose
    (:func:`at_p_block`).  The
    binary GEMM's main call runs once more with the launch counters set to
    0, as a caller of ``ops.popcount_matmul`` would make it."""
    import torch

    from repro_torch.device import sm_count
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.popcount_matmul import variant as pop_variant
    from repro_torch.kernels.ssd_scan import p_block
    from repro_torch.kernels.ssd_scan import variant as ssd_variant

    ssd_err = ssd_parity(device)
    mma_near = ssd_err.pop("mma_ref", {})
    gen = torch.Generator(device=device).manual_seed(3)
    ssd_main = []
    for label, Bb, L, H, P, N in SSD_MAIN:
        for dt_name in ("float32", "bfloat16"):
            args = ssd_inputs(gen, Bb, L, H, P, N, _dtype(dt_name), device)
            got = ops.ssd_scan(*args)
            want = ops.ssd_scan(*args, use_kernel=False)
            tol = SSD_TOL[dt_name]
            ok, err = _within(got, want, tol, tol)
            check(ok, f"ssd_scan {label} [{Bb}, {L}, {H}, {P}] N={N} "
                      f"{dt_name} differs from its plain version (max abs "
                      f"err {err})")
            ssd_err[dt_name] = max(ssd_err[dt_name], err)
            if dt_name != "bfloat16":  # the models run in bfloat16
                continue
            mref = ref.ssd_scan_mma_ref(*args)
            mma_near = _worse(mma_near, check_mma_ref(got, mref, label))
            faulty = drop_diagonal(lambda *_: got)(*args)
            fault = {**mma_ref_reading(faulty, mref),
                     "rejected": not _within(faulty, mref, *MMA_REF_TOL)[0],
                     "within_plain_tol": _within(faulty, want, tol, tol)[0]}
            check(fault["rejected"], f"ssd_scan {label}: the check against "
                                     f"ref.ssd_scan_mma_ref passes a "
                                     f"planted fault ({fault})")
            pb = p_block(Bb, H, P, sm_count(device.index))
            rec = {"label": label, "shape": [Bb, L, H, P, N],
                   "dtype": dt_name, "variant": ssd_variant(got.dtype, N),
                   "p_block": pb, "max_abs_err": err,
                   "ms": time_ms(lambda: ops.ssd_scan(*args)),
                   "plain_ms": time_ms(lambda: ops.ssd_scan(
                       *args, use_kernel=False), reps=3, inner=1, warmup=1),
                   "library_ms": None,
                   **ssd_bound_ms(Bb, L, H, P, N, 2)}
            rec["device_ms"], rec["kernels"] = device_ms(
                lambda: ops.ssd_scan(*args))
            rec["other_p_block"] = at_p_block(args, 16 if pb == 32 else 32,
                                              want, tol)
            rec["planted_fault"] = fault
            ssd_main.append(rec)
            del args, got, want, mref, faulty

    # the models' regime: outputs of a few hundred, so the error is held
    # against the output's scale (normwise), as rounding in a sum scales
    # with its terms; in bfloat16 the plain version's float32 arithmetic
    # on the same bfloat16 inputs is rounded once at the output (2^-9 of
    # it) and the mma variant's W, x w_u and h copies alike, so the
    # reference's 2e-2 applies to the output's scale
    model_regime = {}
    for dt_name in ("float32", "bfloat16"):
        model_regime[dt_name] = []
        for label, Bb, L, H, P, N in SSD_MAIN:
            args = ssd_inputs(gen, Bb, L, H, P, N, _dtype(dt_name), device,
                              model_like=True)
            got = ops.ssd_scan(*args).float()
            want = ops.ssd_scan(*args, use_kernel=False).float()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            tol = SSD_TOL[dt_name] * max(1.0, scale)
            check(err <= tol, f"ssd_scan {label} model-like {dt_name} "
                              f"inputs differ from the plain version by "
                              f"{err} (tol {tol})")
            model_regime[dt_name].append({"label": label,
                                          "max_abs_err": err,
                                          "scale": scale, "tol": tol})
            del args, got, want

    pop_err = popcount_parity(device)
    M, N, W = POPCOUNT_MAIN
    rng = np.random.default_rng(5)
    x = _random_words(rng, (M, W), device)
    w = _random_words(rng, (N, W), device)
    kb = 32 * W
    got, counts = _counted(lambda: ops.popcount_matmul(x, w, "xnor", kb))
    variants = _variants()["popcount_matmul"]
    check(variants == {"tensor_core": 1},
          f"the popcount main call's variants were {variants}")
    want = ops.popcount_matmul(x, w, "xnor", kb, use_kernel=False)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, f"popcount_matmul xnor {POPCOUNT_MAIN} differs from its "
                    f"plain version (max abs err {err})")
    xs, ws = unpack_signs(x, kb, True), unpack_signs(w, kb, True)
    lib = torch.matmul(xs, ws.T)
    pop_main = {
        "shape": [M, N, W], "mode": "xnor", "max_abs_err": max(err, pop_err),
        "variant": pop_variant(M, N, W), "variants": variants,
        "launches": counts["popcount_matmul"],
        "ms": time_ms(lambda: ops.popcount_matmul(x, w, "xnor", kb)),
        "plain_ms": time_ms(lambda: ops.popcount_matmul(
            x, w, "xnor", kb, use_kernel=False), reps=3, inner=2),
        "library_ms": time_ms(lambda: torch.matmul(xs, ws.T)),
        "library_device_ms": device_ms(lambda: torch.matmul(xs, ws.T))[0],
        "library_equal": bool(torch.equal(lib.float(), got.float())),
        **popcount_bound_ms(M, N, W)}
    pop_main["device_ms"], pop_main["kernels"] = device_ms(
        lambda: ops.popcount_matmul(x, w, "xnor", kb))
    return {"phase": "ssm_kernel_parity",
            "ssd_scan": {"max_abs_err": ssd_err,
                         "cases": 2 * (len(SSD_CASES) + len(SSD_SLICED_CASES)
                                       + len(SSD_MAIN)),
                         "tol": SSD_TOL, "mma_ref": mma_near,
                         "mma_ref_tol": MMA_REF_TOL, "main": ssd_main,
                         "model_regime": model_regime},
            "popcount_matmul": {"max_abs_err": max(err, pop_err),
                                "cases": 2 * len(POPCOUNT_CASES)
                                + len(POPCOUNT_KBITS_CASES) + 1,
                                "main": pop_main}}


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


def _variants() -> dict:
    """Calls per kernel variant since the last reset (read right after a
    :func:`_counted` run, they are that run's)."""
    from repro_torch.kernels import ops

    return ops.variant_counts()


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


def lut_eval6_launches_grouped(nets: list) -> int:
    """Launches the grouped suite evaluation makes: one per level of every
    bucket of each envelope group that holds LUTs."""
    from repro_torch.core.eval_torch import (get_group_program,
                                             group_plans_by_envelope,
                                             plan_netlist)

    groups = group_plans_by_envelope([plan_netlist(n) for n in nets])
    total = 0
    for members in groups:
        prog = get_group_program([nets[i] for i in members])
        total += sum(bk.n_levels for bk, (luts, _) in
                     zip(prog.member_plans[0].buckets, prog.flags) if luts)
    return total


def cost_model_reading(nets: list, device, walls_ms: dict) -> dict:
    """``flow.eval_mode_cost_model``'s pick for the suite on ``device``
    beside the two measured warm walls, the terms it weighed, and the
    constants that reproduce both walls in its form ``wall = ms_per_row x
    padded rows + ms_per_program x programs`` (what the walls imply for
    the model's dispatch cost; ``None`` when no positive pair fits)."""
    from repro_torch.core import flow

    model = flow.eval_mode_cost_model(nets, device=device)
    faster = min(("grouped", "per_circuit"), key=lambda k: walls_ms[k])
    rg, rp = model["padded_rows_grouped"], model["padded_rows_per_circuit"]
    pg, pp = model["n_programs_grouped"], model["n_programs_per_circuit"]
    det = rg * pp - rp * pg
    per_row = per_prog = 0.0
    if det:
        per_row = (walls_ms["grouped"] * pp
                   - walls_ms["per_circuit"] * pg) / det
        per_prog = (rg * walls_ms["per_circuit"]
                    - rp * walls_ms["grouped"]) / det
    fit = None
    if per_row > 0 and per_prog > 0:
        fit = {"ms_per_row": per_row, "ms_per_program": per_prog,
               "dispatch_row_cost": per_prog / per_row}
    return {**model, "warm_wall_ms": walls_ms, "faster": faster,
            "pick_is_faster": model["pick"] == faster, "fit": fit}


def phase_suite_eval(nets: list, lanes: list, n_lane_words: int, device,
                     n_oracle_words: int = 4) -> dict:
    """Evaluate the suite grouped and per circuit through the kernels,
    and grouped through the plain version; all three equal, and equal to
    the Python oracle on sampled lane words of every circuit.  On the
    card every LUT level is one launch of the level kernel, as planned;
    the cost model's pick is read beside both warm walls."""
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
    v_g = _variants()["lut_eval6"]
    (per, _, t_p_cold), c_p = _counted(lambda: run("per_circuit"))
    v_p = _variants()["lut_eval6"]
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
    planned_grouped = lut_eval6_launches_grouped(nets)
    if device.type == "cuda":
        check(c_p["lut_eval6"] == sum(per_circuit.values()),
              f"per-circuit launches {c_p['lut_eval6']} != planned "
              f"{sum(per_circuit.values())}")
        check(c_g["lut_eval6"] == planned_grouped,
              f"grouped launches {c_g['lut_eval6']} != planned "
              f"{planned_grouped}")
        for mode, c, v in (("grouped", c_g, v_g), ("per_circuit", c_p, v_p)):
            check(v == {"op": 0, "level": c["lut_eval6"]},
                  f"{mode}: lut_eval6 variants {v}, expected one level "
                  f"launch per LUT level and no op call")
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
            "variants": {"grouped": v_g, "per_circuit": v_p},
            "lut_eval6_launches_planned": {
                "grouped": planned_grouped,
                "per_circuit": sum(per_circuit.values())},
            "lut_eval6_launches_per_circuit": per_circuit,
            "cost_model": cost_model_reading(
                nets, device, {"grouped": t_g * 1e3,
                               "per_circuit": t_p * 1e3}),
            "oracle_words_per_circuit": n_oracle_words}


def phase_profile(nets: list, lanes: list, n_lane_words: int,
                  device, top: int = 10) -> dict:
    """One warm grouped suite evaluation under ``torch.profiler``: device
    time by kernel and copy, busy share of the wall, and the host
    operations that take the most time; then the same for one warm
    per-circuit evaluation.  Each run's results are dropped before the
    next, so the pinned host buffers come from the allocator's cache."""
    import torch

    from repro_torch.core import flow

    def run(mode):
        def go():
            flow.evaluate_suite(nets, lanes, n_lane_words, mode=mode,
                                device=device)
            if device.type == "cuda":
                torch.cuda.synchronize()
        go()  # warm: plan tensors uploaded, allocators primed
        return go

    rec = {"phase": "profile", "what": "evaluate_suite grouped (warm)",
           "n_lane_words": n_lane_words,
           **profile_summary(run("grouped"), device, top)}
    rec["per_circuit"] = profile_summary(run("per_circuit"), device, top)
    return rec


def profile_summary(run, device, top: int = 10) -> dict:
    """One call of ``run()`` (which ends in a device synchronisation)
    under ``torch.profiler``: its wall, device busy time and idle share,
    device time by kernel and copy (the copies and memsets also on their
    own, by name), the number of kernels launched, and the host operations
    that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    copies = [r for r in dev if r[0].startswith(("Memcpy", "Memset"))]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "device_kernel_launches": sum(c for _, _, c in dev)
            - sum(c for _, _, c in copies),
            "copy_ms": sum(ms for _, ms, _ in copies),
            "copy_ms_by_name": [{"name": k[:80], "ms": ms, "count": c}
                                for k, ms, c in copies],
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
# serving phases (device-generic, like the ones above)
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def as_float32(cfg):
    import dataclasses

    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def cast_params(params: dict, dtype) -> dict:
    """Every leaf cast to ``dtype`` but those the reference keeps float32
    whatever ``param_dtype`` is (``lm.FLOAT32_LEAVES``: the SSD's
    ``dt_bias``, ``a_log`` and ``d_skip``)."""
    from repro_torch.models.lm import FLOAT32_LEAVES

    return {k: cast_params(v, dtype) if isinstance(v, dict)
            else v if k in FLOAT32_LEAVES else v.to(dtype)
            for k, v in params.items()}


def serve_gate(cfg32, params32, batch: int, prompt_len: int, max_new: int,
               device, tol: float = SERVE_TOL) -> dict:
    """Float32 serving through the kernels against the plain path
    (``use_kernel=False``, the reference's masked attention over the whole
    cache) and against the teacher-forced forward: logits within ``tol``
    (``SERVE_TOL`` unless the caller calibrated it, see
    :func:`forward_gate`) at the prefill and every decode step, identical
    greedy tokens.  Raises on any difference."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm

    prompts = serve.make_prompts(cfg32, batch, prompt_len, device, seed=0)
    (kern, counts) = _counted(lambda: serve.generate(
        cfg32, params32, prompts, max_new, keep_logits=True))
    variants = _variants()
    plain = serve.generate(cfg32, params32, prompts, max_new,
                           use_kernel=False, keep_logits=True)
    d_plain = float((kern["logits"] - plain["logits"]).abs().max())
    check(d_plain <= tol, f"{cfg32.name}: kernel-path logits differ from "
                          f"the plain path by {d_plain} (tol {tol})")
    check(torch.equal(kern["tokens"], plain["tokens"]),
          f"{cfg32.name}: greedy tokens differ between the kernel and plain "
          "paths")
    fed = torch.cat([prompts, kern["tokens"][:, :-1]], dim=1)
    hidden, _ = lm.forward(cfg32, params32, fed, return_hidden=True)
    tf = lm.unembed(cfg32, params32, hidden[:, prompt_len - 1:]).float()
    d_tf = float((kern["logits"] - tf).abs().max())
    check(d_tf <= tol, f"{cfg32.name}: cached logits differ from the "
                       f"teacher-forced forward by {d_tf} (tol {tol})")
    check(bool(torch.isfinite(kern["logits"]).all()),
          f"{cfg32.name}: non-finite logits")
    return {"batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            "max_abs_logit_diff_vs_plain": d_plain,
            "max_abs_logit_diff_vs_forward": d_tf, "tol": tol,
            "tokens_identical": True, "launches": counts,
            "variants": variants, "first_row": kern["tokens"][0].tolist()}


def forced_logits(cfg, params, prompts, tokens, use_kernel: bool):
    """Serving with the tokens forced (teacher forcing through the cache):
    prefill ``prompts [B, S]``, then decode ``tokens [B, n]`` one by one.
    Returns the float32 logits ``[B, n, V]`` of the prefill's last position
    and of the first n - 1 decode steps, aligned with ``serve.generate``'s
    when ``tokens`` are its own."""
    import torch

    from repro_torch.serve.decode import decode_step, prefill
    from repro_torch.serve.kvcache import init_cache

    B, S = prompts.shape
    n = tokens.shape[1]
    cache = init_cache(cfg, B, S + n, device=prompts.device)
    logits, cache = prefill(cfg, params, cache, prompts,
                            use_kernel=use_kernel)
    kept = [logits.float()]
    for i in range(n - 1):
        logits, cache = decode_step(cfg, params, cache, tokens[:, i:i + 1],
                                    S + i, use_kernel=use_kernel)
        kept.append(logits.float())
    return torch.cat(kept, dim=1)


def serve_gate_bf16(cfg, cfg32, params32, params, batch: int,
                    prompt_len: int, max_new: int, device) -> dict:
    """bfloat16 serving through the kernels (prefill on the mma variant,
    decode on the split variant) against the plain paths.

    The float32 plain path serves greedily; its tokens are then forced
    through the bfloat16 kernel path, the bfloat16 plain path (the
    reference's masked attention) and the float32 plain path on the
    bfloat16-rounded weights, so all logits sit on the same tokens.  Two
    bounds, each ``max(SERVE_TOL, NOISE_MARGIN x d)`` with d measured in
    this run (as :func:`forward_gate` calibrates the SSM gates):

    - the kernel path against the float32 run, d the bfloat16 plain
      path's own disagreement with it (weights and activations rounded);
    - the kernel path against the bfloat16 plain path (the same weights,
      the same precision), d the bfloat16 plain path's disagreement with
      float32 activations on the same rounded weights: the rounding of
      activations alone, which is all the two bfloat16 paths can differ
      by.  Every forced position's greedy token must also agree between
      them.

    Also reported: the share of greedy tokens that agree with float32."""
    import torch

    from repro_torch.launch import serve

    prompts = serve.make_prompts(cfg32, batch, prompt_len, device, seed=0)
    ref32 = serve.generate(cfg32, params32, prompts, max_new,
                           use_kernel=False, keep_logits=True)
    forced = ref32["tokens"]
    rounded32 = cast_params(params, torch.float32)
    act32 = forced_logits(cfg32, rounded32, prompts, forced, False)
    del rounded32
    kern, counts = _counted(lambda: forced_logits(cfg, params, prompts,
                                                  forced, True))
    variants = _variants()
    plain = forced_logits(cfg, params, prompts, forced, False)
    d_plain = float((plain - ref32["logits"]).abs().max())
    d = float((kern - ref32["logits"]).abs().max())
    tol = max(SERVE_TOL, NOISE_MARGIN * d_plain)
    d_act = float((plain - act32).abs().max())
    d_same = float((kern - plain).abs().max())
    tol_same = max(SERVE_TOL, NOISE_MARGIN * d_act)
    top, top_plain = kern.argmax(-1), plain.argmax(-1)
    agree = float((top == top_plain).float().mean())
    check(_finite(kern), f"{cfg.name}: non-finite bf16 logits")
    check(d <= tol, f"{cfg.name}: bf16 kernel-path logits differ from the "
                    f"float32 run by {d} (tol {tol})")
    check(d_same <= tol_same,
          f"{cfg.name}: bf16 kernel-path logits differ from the bf16 plain "
          f"path by {d_same} (tol {tol_same})")
    check(agree == 1.0, f"{cfg.name}: bf16 kernel-path greedy tokens agree "
                        f"with the bf16 plain path at {agree} of positions")
    return {"batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            "dtype": cfg.compute_dtype,
            "max_abs_logit_diff_vs_float32": d,
            "plain_bf16_vs_float32": d_plain, "tol": tol,
            "max_abs_logit_diff_vs_plain_bf16": d_same,
            "plain_bf16_vs_float32_activations": d_act,
            "tol_vs_plain_bf16": tol_same,
            "logit_scale": float(ref32["logits"].abs().max()),
            "greedy_agreement_vs_plain_bf16": agree,
            "greedy_agreement_vs_float32": float(
                (top == ref32["logits"].argmax(-1)).float().mean()),
            "launches": counts, "variants": variants}


def serve_timed(cfg, params, batch: int, prompt_len: int, max_new: int,
                device) -> dict:
    """One warm-up, then the timed serving run with its launches
    counted."""
    from repro_torch.launch import serve

    prompts = serve.make_prompts(cfg, batch, prompt_len, device, seed=1)
    serve.generate(cfg, params, prompts, 2)  # warm: library, allocator
    res, counts = _counted(lambda: serve.generate(cfg, params, prompts,
                                                  max_new))
    return {"batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            "dtype": cfg.compute_dtype, "prefill_ms": res["prefill_ms"],
            "decode_ms_per_step": res["decode_ms_per_step"],
            "tok_per_s": res["tok_per_s"],
            "decode_tok_per_s": res["decode_tok_per_s"],
            "launches": counts, "variants": _variants()}


def check_flash_variants(rec: dict) -> None:
    """A dense serving phase's flash calls went through every variant its
    path has: the float32 gate through ``ffma``; the timed bfloat16 run's
    prefill (one call per layer) through ``mma`` and each decode step's
    through ``split``."""
    layers, steps = rec["layers"], rec["timed"]["max_new"] - 1
    gate = rec["gate"]["variants"]["flash_attention"]
    timed = rec["timed"]["variants"]["flash_attention"]
    check(gate["ffma"] == rec["gate"]["launches"]["flash_attention"] > 0,
          f"{rec['arch']}: the float32 gate's flash variants were {gate}")
    check(timed == {"mma": layers, "split": layers * steps, "ffma": 0},
          f"{rec['arch']}: the bf16 serving run's flash variants were "
          f"{timed}, expected mma {layers}, split {layers * steps}")
    bf16 = rec["gate_bf16"]["variants"]["flash_attention"]
    check(bf16["mma"] > 0 and bf16["split"] > 0,
          f"{rec['arch']}: the bf16 gate's flash variants were {bf16}")


def phase_serve(name: str, cfg, device, gate: tuple, timed: tuple,
                seed: int = 0) -> tuple[dict, dict]:
    """A config at full width: the float32 gate run, then a timed run in
    the config's own types with the same (cast) weights.  Returns the
    phase record and the bfloat16 weights (for the profile phase)."""
    import torch

    from repro_torch.launch import serve

    cfg32 = as_float32(cfg)
    params32 = serve.make_params(cfg32, device, seed=seed)
    gate_rec = serve_gate(cfg32, params32, *gate, device)
    params = cast_params(params32, getattr(torch, cfg.param_dtype))
    bf16_rec = serve_gate_bf16(cfg, cfg32, params32, params, *gate, device)
    del params32
    if device.type == "cuda":
        torch.cuda.empty_cache()
    timed_rec = serve_timed(cfg, params, *timed, device)
    n_layers = cfg.n_layers
    return ({"phase": name, "arch": cfg.name, "layers": n_layers,
             "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
             "head_dim": cfg.hd, "vocab": cfg.vocab, "gate": gate_rec,
             "gate_bf16": bf16_rec, "timed": timed_rec,
             "flash_launches_expected": n_layers * timed[2]}, params)


#: the margin over the reference's own float32 disagreement that the SSM
#: gates allow (see :func:`forward_gate`)
NOISE_MARGIN = 4.0


def forward_gate(cfg32, params32, batch: int, seq_len: int, device) -> dict:
    """Float32 teacher-forced forward through the kernels against the
    plain forward (``use_kernel=False``: the sequential SSD scan, the
    reference's masked attention).

    Over a full-depth stack of random layers, float32 rounding differences
    grow from layer to layer, so two correct summation orders need not
    agree to ``SERVE_TOL``.  The gate measures that growth with the
    reference's own two plain SSD forms: the chunked dual form
    (``ssd_chunk = 128``) against the sequential scan, both plain.  The
    kernel path must agree with the sequential forward within
    ``tol = max(SERVE_TOL, NOISE_MARGIN x that disagreement)``; the
    serving gate then uses the same ``tol``."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import lm

    toks = serve.make_prompts(cfg32, batch, seq_len, device, seed=3)
    kern, counts = _counted(lambda: lm.forward(cfg32, params32, toks)[0])
    variants = _variants()
    kern = kern.float()
    plain = lm.forward(cfg32, params32, toks, use_kernel=False)[0].float()
    chunked = lm.forward(dataclasses.replace(cfg32, ssd_chunk=128),
                         params32, toks, use_kernel=False)[0].float()
    noise = float((chunked - plain).abs().max())
    tol = max(SERVE_TOL, NOISE_MARGIN * noise)
    d = float((kern - plain).abs().max())
    check(d <= tol, f"{cfg32.name}: kernel-path forward differs from the "
                    f"plain forward by {d} (tol {tol})")
    check(_finite(kern), f"{cfg32.name}: non-finite logits")
    return {"batch": batch, "seq_len": seq_len,
            "max_abs_logit_diff_vs_plain": d,
            "plain_chunked_vs_sequential": noise, "tol": tol,
            "logit_scale": float(plain.abs().max()),
            "argmax_agreement": float(
                (kern.argmax(-1) == plain.argmax(-1)).float().mean()),
            "launches": counts, "variants": variants}


def drop_diagonal(scan):
    """An SSD scan ``scan(x, dt, A, B, C)`` with a planted fault: each
    step's own input left out of its causal sum, as a mask of t > u in
    place of t >= u would leave it, ``y - (C[t] . B[t]) dt[t] x[t]``.
    Takes and ignores ``use_kernel``, so it can stand in for
    ``ops.ssd_scan``.  The bf16 forward gate must reject it."""
    def faulty(x, dt, A, B, C, use_kernel=True):
        y = scan(x, dt, A, B, C)
        own = (C.float() * B.float()).sum(-1)[:, :, None, None] \
            * dt[..., None] * x.float()
        return (y.float() - own).to(y.dtype)
    return faulty


def forward_gate_bf16(cfg, params, batch: int, seq_len: int,
                      device) -> dict:
    """The bfloat16 teacher-forced forward through the kernels (the SSD
    layers on ``ssd_scan``'s mma variant, hymba's attention on flash's)
    against the bfloat16 plain forward (``use_kernel=False``: the
    sequential scan and the masked attention, float32 arithmetic on the
    same bfloat16 tensors), on the pattern of :func:`serve_gate_bf16`.

    The plain forward's disagreement with float32 arithmetic on the same
    bfloat16 weights is the rounding of activations alone: d' in the
    largest logit, r' in the RMS over all logits, and n' positions whose
    argmax differs.  The kernel path must agree with the plain one within
    ``max(SERVE_TOL, NOISE_MARGIN x d')`` in the largest logit and
    ``max(SERVE_TOL, NOISE_MARGIN x r')`` in RMS, and its argmax may
    differ at ``n' + 3 sqrt(max(n', 1))`` positions at most (n' with
    three times the spread of a count).  The kernel-path forward runs
    once more with :func:`drop_diagonal` planted in every SSD layer; its
    readings, and the checks that reject it, are kept under
    ``planted_fault`` (:func:`phase_ssm` requires a rejection where the
    gate can see the scan: over the first ``BF16_GATE_LAYERS``)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.launch import serve
    from repro_torch.models import lm

    toks = serve.make_prompts(cfg, batch, seq_len, device, seed=3)
    kern, counts = _counted(lambda: lm.forward(cfg, params, toks)[0])
    variants = _variants()
    plain = lm.forward(cfg, params, toks, use_kernel=False)[0].float()
    act32 = lm.forward(as_float32(cfg), cast_params(params, torch.float32),
                       toks, use_kernel=False)[0].float()
    top_plain = plain.argmax(-1)
    n_act = int((top_plain != act32.argmax(-1)).sum())
    positions = top_plain.numel()
    d_act = float((plain - act32).abs().max())
    r_act = float((plain - act32).pow(2).mean().sqrt())
    tol = max(SERVE_TOL, NOISE_MARGIN * d_act)
    rms_tol = max(SERVE_TOL, NOISE_MARGIN * r_act)
    flips_tol = (n_act + 3.0 * math.sqrt(max(n_act, 1))) / positions

    def reading(logits) -> dict:
        logits = logits.float()
        diff = logits - plain
        r = {"max_abs": float(diff.abs().max()),
             "rms": float(diff.pow(2).mean().sqrt()),
             "argmax_flips": float((logits.argmax(-1) != top_plain)
                                   .float().mean())}
        r["rejected_by"] = [k for k, lim in (
            ("max_abs", tol), ("rms", rms_tol), ("argmax_flips", flips_tol))
            if not r[k] <= lim]
        return r

    sound = reading(kern)
    check(_finite(kern), f"{cfg.name}: non-finite bf16 logits")
    check(not sound["rejected_by"],
          f"{cfg.name}: bf16 kernel-path forward differs from the bf16 "
          f"plain forward ({sound}; tol {tol}, rms {rms_tol}, argmax "
          f"flips {flips_tol})")
    rec = {"batch": batch, "seq_len": seq_len, "dtype": cfg.compute_dtype,
           "max_abs_logit_diff_vs_plain_bf16": sound["max_abs"],
           "plain_bf16_vs_float32_activations": d_act, "tol": tol,
           "rms_logit_diff_vs_plain_bf16": sound["rms"],
           "rms_plain_bf16_vs_float32_activations": r_act,
           "rms_tol": rms_tol,
           "logit_scale": float(plain.abs().max()),
           "logit_rms": float(plain.pow(2).mean().sqrt()),
           "argmax_agreement_vs_plain_bf16": 1.0 - sound["argmax_flips"],
           "argmax_agreement_plain_vs_float32_activations":
               1.0 - n_act / positions,
           "argmax_disagreement_tol": flips_tol,
           "launches": counts, "variants": variants}
    # the fault wraps the kernel (the plain scan on the CPU) beneath
    # ops.ssd_scan, whose launch counts it leaves alone
    scan = ops.ssd_scan
    ops.ssd_scan = drop_diagonal(ssd_scan_cuda if device.type == "cuda"
                                 else ref.ssd_scan_ref)
    try:
        rec["planted_fault"] = reading(lm.forward(cfg, params, toks)[0])
    finally:
        ops.ssd_scan = scan
    return rec


#: depth of the second bf16 SSM forward gate.  On an H100, at full depth
#: on random weights, mamba2's bf16 logits differ from float32
#: activations' by more than their own RMS (53.9 against 50.6), and a
#: scan that drops each step's own input (:func:`drop_diagonal`) passes
#: the gate there; over the first 4 layers that difference is 1.42
#: (hymba 0.71) against logits of RMS 51 (40), and the same fault moves
#: them by 56 (28) in RMS (PERF.md, the SSM bf16 gate readings)
BF16_GATE_LAYERS = 4


def first_layers(cfg, params: dict, k: int):
    """The config and weights of a model's first ``k`` layers (views of
    the stacked block weights)."""
    import dataclasses

    return (dataclasses.replace(cfg, n_layers=k),
            {**params, "blocks": {n: v[:k]
                                  for n, v in params["blocks"].items()}})


def check_ssd_variants(rec: dict) -> None:
    """An SSM phase's SSD calls went through the variant of their type:
    the float32 gate through ``ffma``; the bfloat16 gates and the timed
    bfloat16 forward through ``mma``, one call per layer."""
    L = rec["layers"]
    cut = rec["gate"]["forward_bf16_first_layers"]
    for what, run, want in (
            ("float32 gate", rec["gate"]["forward"], {"mma": 0, "ffma": L}),
            ("bf16 gate", rec["gate"]["forward_bf16"], {"mma": L, "ffma": 0}),
            ("bf16 gate over the first layers", cut,
             {"mma": cut["layers"], "ffma": 0}),
            ("bf16 forward", rec["forward"], {"mma": L, "ffma": 0})):
        got = run["variants"]["ssd_scan"]
        check(got == want, f"{rec['arch']}: the {what}'s ssd_scan variants "
                           f"were {got}, expected {want}")


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t.float()).all())


def forward_timed(cfg, params, batch: int, seq_len: int, device) -> dict:
    """A warm-up, then three teacher-forced forwards in the config's own
    types on the host clock (each ends in a synchronisation); the first is
    counted.  Returns the median ms and tokens / s."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    toks = serve.make_prompts(cfg, batch, seq_len, device, seed=4)

    def run():
        _sync(device)
        t0 = time.perf_counter()
        logits = lm.forward(cfg, params, toks)[0]
        _sync(device)
        return logits, (time.perf_counter() - t0) * 1e3

    run()  # warm: libraries, allocator
    (logits, ms0), counts = _counted(run)
    check(tuple(logits.shape) == (batch, seq_len, cfg.vocab)
          and _finite(logits),
          f"{cfg.name}: forward gave {tuple(logits.shape)} or non-finite "
          "logits")
    variants = _variants()
    del logits
    times = [ms0] + [run()[1] for _ in range(2)]
    ms = float(np.median(times))
    return {"batch": batch, "seq_len": seq_len, "dtype": cfg.compute_dtype,
            "ms": ms, "ms_each": times,
            "tok_per_s": batch * seq_len / (ms / 1e3), "launches": counts,
            "variants": variants}


def phase_ssm(name: str, cfg, device, gate: tuple, forward: tuple,
              timed: tuple, seed: int = 0) -> tuple[dict, dict]:
    """An ssm or hybrid config at full width: the float32 gate (the
    kernel-path forward against the plain forward; cached serving against
    the plain serving run and the kernel-path forward), the bfloat16
    forward gate (:func:`forward_gate_bf16`) at full depth and over the
    first ``BF16_GATE_LAYERS`` (where, on the card, it must reject the
    planted fault), then a timed forward and a
    timed serving run in the config's own types with the same (cast)
    weights.  ``gate`` is (batch, forward length, prompt, new
    tokens); ``forward`` (batch, length); ``timed`` (batch, prompt, new
    tokens).  Returns the phase record and the cast weights."""
    import torch

    from repro_torch.launch import serve

    cfg32 = as_float32(cfg)
    params32 = serve.make_params(cfg32, device, seed=seed)
    fwd_gate = forward_gate(cfg32, params32, gate[0], gate[1], device)
    serve_rec = serve_gate(cfg32, params32, gate[0], gate[2], gate[3],
                           device, tol=fwd_gate["tol"])
    params = cast_params(params32, getattr(torch, cfg.param_dtype))
    del params32
    if device.type == "cuda":
        torch.cuda.empty_cache()
    fwd_bf16 = forward_gate_bf16(cfg, params, gate[0], gate[1], device)
    n_cut = min(BF16_GATE_LAYERS, cfg.n_layers)
    cut = forward_gate_bf16(*first_layers(cfg, params, n_cut), gate[0],
                            gate[1], device)
    check(device.type != "cuda" or bool(cut["planted_fault"]["rejected_by"]),
          f"{cfg.name}: the bf16 forward gate over the first {n_cut} layers "
          f"passes a planted fault (each step's own input dropped): "
          f"{cut['planted_fault']}")
    fwd = forward_timed(cfg, params, *forward, device)
    timed_rec = serve_timed(cfg, params, *timed, device)
    L = cfg.n_layers
    attn = cfg.family == "hybrid"
    expected = {"forward": {"ssd_scan": L, "flash_attention": L if attn
                            else 0},
                "serve": {"ssd_scan": 0,
                          "flash_attention": L * timed[2] if attn else 0}}
    runs = [("forward gate", fwd_gate, expected["forward"]),
            ("bf16 forward gate", fwd_bf16, expected["forward"]),
            (f"bf16 forward gate over {n_cut} layers", cut,
             {"ssd_scan": n_cut, "flash_attention": n_cut if attn else 0}),
            ("forward", fwd, expected["forward"]),
            ("serving", timed_rec, expected["serve"])]
    for what, rec, want in runs if device.type == "cuda" else ():
        for k, n in want.items():
            check(rec["launches"][k] == n,
                  f"{cfg.name} {what} launched {k} {rec['launches'][k]} "
                  f"times, expected {n}")
    return ({"phase": name, "arch": cfg.name, "family": cfg.family,
             "layers": L, "d_model": cfg.d_model,
             "ssd": [cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state],
             "heads": [cfg.n_heads, cfg.n_kv_heads] if attn else None,
             "window": cfg.local_window or None, "vocab": cfg.vocab,
             "gate": {"forward": fwd_gate, "forward_bf16": fwd_bf16,
                      "forward_bf16_first_layers": {"layers": n_cut, **cut},
                      "serve": serve_rec},
             "forward": fwd, "timed": timed_rec,
             "launches_expected": expected}, params)


def phase_profile_ssm(cfg, params, batch: int, seq_len: int, device,
                      top: int = 10) -> dict:
    """A warm teacher-forced forward and a warm decode step under
    ``torch.profiler``.  The decode step runs on a zeroed state: an SSD
    step costs the same at any fill."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache

    toks = serve.make_prompts(cfg, batch, seq_len, device, seed=2)
    cache = init_cache(cfg, batch, seq_len + 1, device=device)

    def run_forward():
        lm.forward(cfg, params, toks)
        _sync(device)

    def run_decode():
        decode_step(cfg, params, cache, toks[:, -1:], seq_len)
        _sync(device)

    run_forward()  # warm
    run_decode()
    return {"phase": "profile_ssm", "arch": cfg.name, "batch": batch,
            "seq_len": seq_len, "dtype": cfg.compute_dtype,
            "forward": profile_summary(run_forward, device, top),
            "decode_step": profile_summary(run_decode, device, top)}


def phase_quantized(cfg32, device, rows=(8, 4096), bits: int = 6) -> dict:
    """The quantized-serving flow at full width: every layer's FFN ``wi``
    as ``bits`` planes through ``bitplane_matmul`` at each row count."""
    from repro_torch.launch import quantized_serve, serve

    params = serve.make_params(cfg32, device, seed=0)
    t0 = time.perf_counter()
    res, counts = _counted(lambda: quantized_serve.run(
        cfg32, params, bits=bits, rows=rows))
    return {"phase": "quantized", "wall_s": time.perf_counter() - t0,
            **res, "worst_mean_rel_err": max(max(e) for e in
                                             res["mean_rel_err"].values()),
            "bound": quantized_serve.MAX_REL_ERR, "launches": counts,
            "variants": _variants()}


def phase_profile_serve(cfg, params, batch: int, prompt_len: int, device,
                        top: int = 10) -> dict:
    """A warm prefill and a warm decode step under ``torch.profiler``."""
    from repro_torch.launch import serve
    from repro_torch.serve.decode import decode_step, prefill
    from repro_torch.serve.kvcache import init_cache

    prompts = serve.make_prompts(cfg, batch, prompt_len, device, seed=2)
    cache = init_cache(cfg, batch, prompt_len + 1, device=device)
    tok = prompts[:, -1:]

    def run_prefill():
        prefill(cfg, params, cache, prompts)
        _sync(device)

    def run_decode():
        decode_step(cfg, params, cache, tok, prompt_len)
        _sync(device)

    run_prefill()  # warm
    run_decode()
    return {"phase": "profile_decode", "arch": cfg.name, "batch": batch,
            "prompt_len": prompt_len, "dtype": cfg.compute_dtype,
            "prefill": profile_summary(run_prefill, device, top),
            "decode_step": profile_summary(run_decode, device, top)}


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
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln] for s in build.sources()}
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_source_s": secs, "ptxas": ptxas})

    suites = full_suites()
    nets = [n for v in suites.values() for n in v]
    levels_net = fig9_workload()
    shapes = main_path_shapes(nets, levels_net)
    krec = kernel_parity(device, shapes, widest_grouped_level(nets, device))
    emit({"phase": "kernel_parity", **krec})
    lmrec = lm_kernel_parity(device)
    emit(lmrec)
    ssmrec = ssm_kernel_parity(device)
    emit(ssmrec)

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

    from repro_torch.configs.base import get_config

    srec, kratos_params = phase_serve(
        "serve", get_config("kratos-dd"), device, gate=(2, 128, 16),
        timed=(8, 512, 64))
    emit(srec)
    flash_launches = srec["timed"]["launches"]["flash_attention"]
    check(flash_launches == srec["flash_launches_expected"],
          f"kratos-dd serving launched flash_attention {flash_launches} "
          f"times, expected {srec['flash_launches_expected']}")
    check(srec["gate"]["launches"]["flash_attention"] > 0,
          "the kratos-dd gate run did not launch flash_attention")
    check_flash_variants(srec)
    emit(phase_profile_serve(get_config("kratos-dd"), kratos_params, 8, 512,
                             device))
    del kratos_params
    torch.cuda.empty_cache()

    grec, gemma_params = phase_serve(
        "serve_gemma2", get_config("gemma2-2b"), device, gate=(1, 4608, 4),
        timed=(2, 4608, 16))
    emit(grec)
    check(grec["timed"]["launches"]["flash_attention"]
          == grec["flash_launches_expected"],
          "gemma2-2b serving did not launch flash_attention once per layer "
          "and step")
    check_flash_variants(grec)
    emit(phase_profile_serve(get_config("gemma2-2b"), gemma_params, 2, 4608,
                             device))
    del gemma_params
    torch.cuda.empty_cache()

    qrec = phase_quantized(as_float32(get_config("kratos-dd")), device)
    emit(qrec)
    bit_launches = qrec["launches"]["bitplane_matmul"]
    check(bit_launches > 0, "the quantized flow did not launch "
                            "bitplane_matmul")
    n_layers = qrec["layers"]
    check(qrec["variants"]["bitplane_matmul"]
          == {"tensor_core": n_layers, "small_m": n_layers, "ffma": 0},
          f"the quantized flow's bitplane_matmul variants were "
          f"{qrec['variants']['bitplane_matmul']}, expected one "
          f"tensor_core (4096 rows) and one small_m (8 rows) call per layer")

    mrec, mamba_params = phase_ssm(
        "ssm_mamba2", get_config("mamba2-2.7b"), device,
        gate=(1, 512, 497, 16), forward=(2, 4096), timed=(8, 512, 32))
    emit(mrec)
    check_ssd_variants(mrec)
    emit(phase_profile_ssm(get_config("mamba2-2.7b"), mamba_params, 2, 4096,
                           device))
    del mamba_params
    torch.cuda.empty_cache()
    hrec, hymba_params = phase_ssm(
        "ssm_hymba", get_config("hymba-1.5b"), device,
        gate=(1, 512, 497, 16), forward=(2, 2048), timed=(8, 2048, 32))
    emit(hrec)
    check_ssd_variants(hrec)
    emit(phase_profile_ssm(get_config("hymba-1.5b"), hymba_params, 2, 2048,
                           device))
    del hymba_params
    torch.cuda.empty_cache()

    replaces = {"lut_eval6": "src/repro/kernels/lut_eval.py:90",
                "lut_eval": "src/repro/kernels/lut_eval.py:47",
                "flash_attention": "src/repro/kernels/flash_attention.py:75",
                "bitplane_matmul": "src/repro/kernels/bitplane_matmul.py:49",
                "ssd_scan": "src/repro/kernels/ssd_scan.py:63",
                "popcount_matmul": "src/repro/kernels/popcount_matmul.py:60"}
    sources = {"lut_eval6": KERNEL_SOURCE, "lut_eval": KERNEL_SOURCE,
               "flash_attention": FLASH_SOURCE,
               "bitplane_matmul": BITPLANE_SOURCE,
               "ssd_scan": SSD_SOURCE, "popcount_matmul": POPCOUNT_SOURCE}
    pop_main = ssmrec["popcount_matmul"]["main"]
    launches = {"lut_eval6": launches6,
                "lut_eval": lrec["launches"]["lut_eval"],
                "flash_attention": flash_launches,
                "bitplane_matmul": bit_launches,
                # the two models' timed forwards (64 + 32 SSD layers)
                "ssd_scan": sum(r["forward"]["launches"]["ssd_scan"]
                                for r in (mrec, hrec)),
                # no model path calls it: its one counted main call
                "popcount_matmul": pop_main["launches"]}
    flash_main = lmrec["flash_attention"]["main"][0]  # kratos-dd prefill
    bit_main = lmrec["bitplane_matmul"]["main"][1]    # [4096, 768] rows
    recs = {**{k: {**krec[k], "library_ms": None}
               for k in ("lut_eval6", "lut_eval")},
            "flash_attention": {
                **flash_main, "shape": [flash_main["q"], flash_main["kv"]],
                "max_abs_err": max(
                    flash_main["max_abs_err"],
                    *lmrec["flash_attention"]["max_abs_err"].values())},
            "bitplane_matmul": {
                **bit_main, "max_abs_err": max(
                    bit_main["max_abs_err"],
                    lmrec["bitplane_matmul"]["max_abs_err"])},
            "ssd_scan": {  # mamba2's layer shape, bfloat16
                **ssmrec["ssd_scan"]["main"][0], "max_abs_err": max(
                    ssmrec["ssd_scan"]["max_abs_err"].values())},
            "popcount_matmul": pop_main}
    # the main paths' calls per kernel variant: the timed bf16 serving run
    # and the float32 gate run (kratos-dd), the quantized flow, the SSM
    # forwards and the binary GEMM's main call
    variant_launches = {
        "lut_eval6": {"suite grouped": rec["variants"]["grouped"],
                      "suite per_circuit": rec["variants"]["per_circuit"]},
        "flash_attention": {
            "serve bf16": srec["timed"]["variants"]["flash_attention"],
            "gate float32": srec["gate"]["variants"]["flash_attention"]},
        "bitplane_matmul": {
            "quantized": qrec["variants"]["bitplane_matmul"]},
        "ssd_scan": {
            "forward bf16 mamba2": mrec["forward"]["variants"]["ssd_scan"],
            "forward bf16 hymba": hrec["forward"]["variants"]["ssd_scan"],
            "gate float32 mamba2":
                mrec["gate"]["forward"]["variants"]["ssd_scan"]},
        "popcount_matmul": {"main": pop_main["variants"]}}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k],
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "shape": r["shape"],
         **{key: r[key] for key in ("device_ms", "library_device_ms")
            if key in r},
         **({"variant": r["variant"],
             "pin_rows_bound_ms": r["pin_rows_bound_ms"],
             "op": {key: r["op"][key] for key in (
                 "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                 "bound_by")}} if "op" in r else {}),
         **({"variant_launches": variant_launches[k]}
            if k in variant_launches else {})}
        for k, r in recs.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
