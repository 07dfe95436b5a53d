"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the paper's CAD flow and its bit-parallel
functional evaluator, serving of the dense LMs, the forward and serving
of the Mamba-2 and Hymba families, serving of the MoE (and its int8 KV
cache), vision-language and encoder-decoder families, and training of
every family — at full size on the card, and
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
   among them (flash: mma, split, tf32x3; bitplane: tensor_core, small_m,
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
9. sweep: ``flow.sweep_architectures`` over the default 7-point arch
   grid through the torch timing program on the card, cold and warm
   (caller-owned packs and programs; the warm call also under
   ``torch.profiler``): its wall split, programs built, kernels launched
   and idle share; every record equal to the numpy sweep and the Python
   oracle, the ``b0`` / ``b2_f10`` / ``b2_f10_l6`` rows equal to the flow
   phase's baseline / DD5 / DD6 records; the frontier rows;
10. sweep_placed: the canonical baseline / DD5 / DD6 points under two
    wire-tier profiles (6 points, cut for time from the 7-point grid's
    14) on the Kratos suite, placed and anneal-refined, equal to the
    placed Python oracle, its zero-wire rows equal to the unplaced
    sweep's; the place / anneal / timing walls;
11. search: ``flow.search_design_space`` over the full 1,920-point grid
    (budget 6,000, eta 8, at least 8 survivors, rungs from the 2 smallest
    circuits; starting from the sweep's packs) with the torch backend
    and ``verify=True``, equal rung by rung to a numpy-backend rerun; the
    winners verified, and the winner's packs of the two smallest circuits
    proven equivalent by lane simulation through ``lut_eval6``;
12. placement_ensembles: the Kratos suite under baseline (DD5 cut for
    time) placed
    by the ensemble placer and refined by the multi-chain annealer on the
    card (``place_ir(backend="torch", refine=mode)``, 4 members and 4
    chains, for both refine modes): every relaxed member
    within 1e-12 of ``_smooth_numpy`` on the same start and legalized
    alike, every chain's best placement equal to the numpy chain's with
    ``_rng(chain=ch)`` (costs ``==`` in ``anneal``, within 1e-12
    relative in ``anneal_timing``), the final pick the host's over
    ``[seed] + chains``, legal, deterministic and never worse than the
    seed; the torch placement's wall per case, taken after the numpy
    chains' worker pool has drained, and each backend's largest case
    under ``torch.profiler``;
13. serve_flow: the flow server with both timing backends — 64 area +
    timing requests over the reference benchmark's pool at 8 and 32
    clients, cold and warm; the 17 circuits under DD5 with eval at 4096
    lane words (``lut_eval6`` level launches counted); a 6-edit stream
    on ``kratos_gemm(6, 6, 6)`` through the delta path with proofs on —
    every record equal to the serial flow, the backends' records
    identical, the lanes equal to ``evaluate_suite`` and the oracle;
14. per-level baseline: the Fig. 9 stress workload through ``lut_eval``,
    equal to the fused evaluator;
15. serve: ``kratos-dd`` at full width — a float32 gate run (kernel path
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
16. serve_gemma2: ``gemma2-2b`` at full width, the same gates with a
    prompt of 4608 tokens so that the local layers' window of 4096 bites,
    a timed bfloat16 run, and its profile_decode; then serve_chunked:
    ``gemma2-2b`` with ``chunked_local_attn`` at 1 x 8192 (two blocks of
    the window), the float32 kernel route (flash with the window on the
    13 local layers) against the plain route (``local_chunked_attention``
    there) in the logits of the first, boundary and last positions within
    5e-3, and a timed bfloat16 forward (26 ``mma`` flash calls); then
    serve_qwen and serve_gemma: ``qwen1.5-0.5b`` (QKV bias, a 151,936
    vocabulary) and ``gemma-2b`` (one kv head at D 256: flash at G 8)
    at full width and depth through the same gates, sized as
    serve_gemma2 (the flash variants checked as serve's), gemma-2b's
    flash prefill and decode calls timed in the LM kernel parity beside
    SDPA (``enable_gqa``);
17. quantized: the quantized-serving flow on ``kratos-dd`` — every
    layer's FFN ``wi`` as 6 bit-planes through ``bitplane_matmul`` at 8
    rows (the small_m variant) and 4096 rows (tensor_core);
18. ssm_mamba2: ``mamba2-2.7b`` at full width — a float32 gate (the
    kernel-path forward against the plain forward at 512 tokens; cached
    serving of a 497-token prompt and 16 new tokens against the plain
    serving run and the kernel-path forward, within 5e-3, identical
    greedy tokens; ``ssd_scan`` on its ffma variant), a bfloat16 forward
    gate at 512 tokens (the kernel path, on the mma variant, against the
    bfloat16 plain forward within ``max(5e-3, 4 x`` the plain path's
    disagreement with float32 activations``)``, argmax bounded alike), a
    timed bfloat16 forward (2 x 4096, 64 ``ssd_scan`` launches, all mma)
    and a timed bfloat16 serving run (8 x 512, 32 new tokens);
19. profile_ssm: a warm mamba2 forward and decode step under
    ``torch.profiler``;
20. ssm_hymba: ``hymba-1.5b`` at full width, the same gate, a timed
    forward at 2 x 2048 (the window of 1024 bites; 32 ``ssd_scan`` and 32
    ``flash_attention`` launches) and a timed serving run with 2048-token
    prompts (32 flash launches per step); then its profile_ssm;
21. serve_moe: ``deepseek-moe-16b`` at full width — the float32 and
    bfloat16 gates over its first 4 layers (the dense one and 3 MoE
    layers; full-depth float32 weights do not fit beside the bf16 ones)
    with every routing decision recorded (the share of (token, layer,
    choice) that agree, the smallest top-k margin; the bfloat16 gate
    replays the float32 run's choices, and takes a kernel token tied with
    the plain path's at its top logit), then a timed bfloat16 run at full
    depth (8 x 512, 32 new tokens: 28 ``mma`` + 868 ``split`` flash
    calls) and a profile of a prefill and a decode step with the
    dropless expert products' share;
22. serve_moe_int8: the same weights with the int8 KV cache — the
    float32 kernel route against the plain route over the same cache
    (within 5e-3, identical tokens) and the bfloat16 gate over 4 layers;
    at full depth the bf16 cache's tokens forced through the int8 cache
    (logit distance, token agreement, the caches' bytes) and a timed run;
    then moe_topk: tied router rows at deepseek's E 64, K 6 routed on the
    card, every choice the lowest index among equal probabilities;
23. serve_vlm: ``llava-next-34b`` at full width, 576 patch embeddings
    before a 64-token prompt — the gates over its first 2 layers, then a
    timed bfloat16 run at full depth (all 60 layers, 68.9 GB of weights;
    a run that does not fit on the card fails);
24. serve_encdec: ``whisper-small`` at full size with 1,500 frames —
    the float32 and bfloat16 gates, a teacher-forced bfloat16 forward
    gate (kernel vs plain, the encoder on ``mma``), and a timed run (8 x
    8, 128 new tokens; its serving encoder runs in float32 on ``tf32x3``,
    as the reference's does on float32 frames);
25. flash_backward_parity: the flash route under autograd
    (``FlashAttentionFn``: the kernel forward, the backward a recompute
    through the plain version) on the FLASH_CASES that take more than
    one query, at every head dimension, and gemma2-2b's attention (D 256,
    window 4096, softcap 50), float32 and bfloat16: the forward within
    2e-4 / 2e-2 of the plain version, dq, dk, dv equal bit for bit to
    autograd through it; at tinyllama-1.1b's training shape [4, 32, 2048,
    64] over 4 kv heads, bf16, the forward by both routes within 2e-2 of
    the plain version, and the kernel forward, the recompute backward and
    both together
    timed beside the plain forward, SDPA's forward and forward + backward
    (``enable_gqa`` and K / V repeated) and the forward's and a fused
    backward's bounds; then the training of every other family
    (``FAMILY_TRAIN``), train_deepseek, train_llava, train_whisper,
    train_mamba2 and train_hymba, each at full width: a float32 gate
    over the first 1-2 layers (the kernel route's loss, gradients and
    stepped parameters against the plain route's, its tolerance from the
    plain route's distance to float64; for mamba2-2.7b and hymba-1.5b,
    which train on the plain route alone, the card's plain step against
    the same step in float64 on the host), for the kernel-route families
    a bf16 gate over the same layers (gradients against the plain
    route's, the noise from float32), 3 bf16 steps over 2-4 layers
    (deepseek-moe-16b's dense layer and 3 MoE layers; whisper-small's at
    full depth through ``launch.train``, the SSMs' through ``fit``; every
    run's step donating its train state, as ``fit``'s does), each loss
    within 2e-2 of a float32 run's and, at every step of the plain bf16
    run, the kernel route's loss at that
    step's weights within ``max(1e-4, 4 x d'_s)`` of the plain route's
    (d'_s its distance there from float32); deepseek also one step with
    ``fp8_expert_gather``; peak memory (beside each run's with the step
    that held two train states, ``PURE_STEP_PEAKS``), step walls, flash
    calls per step and variant, and one flash call at the run's shapes
    timed (forward and recompute backward) beside SDPA;
26. train_tinyllama: ``tinyllama-1.1b`` at full width — a float32 gate
    over its first 4 layers (2 x 512 tokens, seed-0 weights: the kernel
    route's loss, every leaf's gradient and every parameter after one
    AdamW step against the plain path's within ``max(1e-4, 4 x d)``
    normwise, d the same quantity's distance between the plain path and
    a float64 plain run), a timed bf16 ``fit`` of 12 steps at full depth
    with remat (B 4 x S 2048, AdamW at the train launcher's defaults; per
    step the wall, tokens / s, peak memory, model-FLOPs share of the
    bf16 peak, and 22 + 22 ``mma`` flash launches; the losses finite and
    falling; one checkpoint, at the end), and a checkpoint check on a
    copy cut to 2 layers at the same width, batch and sequence (12
    steps saved at 6 and 12: the last restored bit for bit against the
    run's final state, then a fresh ``fit`` resumed from step 6 to 12,
    its losses beside the uninterrupted run's);
27. profile_train: one warm bf16 train step under ``torch.profiler``
    (device busy and idle share, top kernels, the flash forwards' and the
    recompute backward's shares) and one in-place AdamW update alone;
    then pipeline: ``tinyllama-1.1b`` at full width through
    ``parallel.pipeline_apply``, 2 stages x 11 layers, 4 microbatches of
    2 x 512 (88 ``mma`` flash calls), bit for bit equal to the stages
    applied to each microbatch in turn, timed against the sequential
    stack, and in float32 within 5e-3 (of the output's scale) of the
    batched stack; then mesh_train: ``tinyllama-1.1b`` through the mesh
    path (``launch.mesh``'s ``(data, model)`` DeviceMesh over the visible
    cards, up to 4 and even, ``(n // 2, 2)``; on one card ``(1, 1)`` over
    an NCCL group of one; more cards are one spawned rank each), parameters
    placed by ``param_specs``: a float32 gate over the first 4 layers at
    2 x 512 (the mesh step's loss, gradients and AdamW-stepped parameters
    within the training gate's ``max(1e-4, 4 x d)`` of the unsharded
    step's), then 3 bf16 steps at full depth, B 4 x S 2048, through
    ``launch.train`` (its checkpoint gathered and written by rank 0)
    beside 3 unsharded steps in bf16 and in float32: each loss within
    ``max(1e-4, 4 x d'_s)`` of the unsharded bf16 one (d'_s the bf16
    run's distance from the float32 run at that step), per-rank peak
    memory, step ms; every flash call the kernel's on the rank's local
    heads; then mesh_serve: ``deepseek-moe-16b`` at full width served
    through the mesh path (``serve.generate(..., mesh=)``, the weights
    placed by ``param_specs``, the cache by ``cache_specs``; the same
    cards and mesh shapes as mesh_train): a float32 gate over its first
    4 layers (the mesh's kernel route against its plain route and the
    unsharded run, within 5e-3, equal tokens), a bf16 plain-route prefill
    of 8 x 512 over a cache of 512 (its peak above the phase's base), and
    the timed bf16 run (8 x 512, 32 new tokens: 28 ``mma`` + 868
    ``split`` flash calls on the rank's local heads) beside the unsharded
    run, its tokens equal to it on one card; on more cards its logits,
    over the steps to the first differing token, within ``max(5e-3, 4 x
    d')`` of it (d' the unsharded plain route's distance from the
    unsharded run there); then dryrun: the records of
    every (arch x shape) cell
    with ``fits_one_card`` against the card's memory, and mamba2-2.7b's
    long_500k cell run (one decode step at position 524,287 from a zeroed
    cache), its peak memory beside the record's argument bytes, then the
    plain-route prefill of 8 x 1,024 tokens from an empty cache on the
    same weights (the recurrence a step per token and layer); and the
    traces (``launch.trace``, in processes of their own, each over a fake
    group of its mesh's size, every one of which must run) of
    deepseek-moe-16b train_4k and that cell on both production meshes,
    mesh_train's step on ``(2, 2)``, that cell's decode and that prefill
    on a mesh of one (the prefill's scans in closed form) and mesh_serve's
    plain prefill on the mesh it ran on, each of the last three within
    10 % of the peak the card measured (rank 0's), and their temporaries
    within 10 % of the card's (the peak of the bytes the tensors
    requested, less the step's arguments; the traces start after the
    per-level baseline, at the host's lowest priority, so that they do
    not share the host with the CAD phases);
28. summary: the ``profiler`` line (every device-time reading turned
    down, its session's records showing a loss or the reading below half
    of what the same call's CUDA events allow the device: where, and
    what it read; retried, then reported as not measured), the
    ``kernels`` line (all six kernels; for those with
    variants, each variant's calls on the main paths; ``lut_eval6``'s
    times and bound are its level variant's, the one the main paths
    launch, with the op's beside, and its launches include the search
    and serve_flow phases'; ``flash_attention``'s include the new
    families' timed serving runs, the training runs' and every mesh
    rank's, training and serving, with its training calls per step and
    times beside), the ``walls`` line (every phase line's ``wall_s``, the
    seconds since the line before, and the total), the card line, and as
    the last line ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each phase that drives the main
path and read just after; the parity phases' launches are not counted.
It exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
#: dense bfloat16 and tf32 tensor-core and float32 CUDA-core peaks (NVIDIA
#: H100 SXM data sheet, without sparsity)
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
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


class PhaseWalls:
    """The wall of every phase line :meth:`emit` prints: the seconds
    since the line before (the script's start for the first), as its
    ``wall_s`` (a phase's own timing of its work, where it kept one,
    moves to ``inner_wall_s``); :meth:`line` lists them all and the
    total."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.walls = []

    def emit(self, rec: dict) -> None:
        now = time.perf_counter()
        if "wall_s" in rec:
            rec["inner_wall_s"] = rec.pop("wall_s")
        rec["wall_s"] = now - self.last
        self.last = now
        self.walls.append([rec["phase"], rec["wall_s"]])
        emit(rec)

    def line(self) -> dict:
        return {"phase": "walls", "walls_s": self.walls,
                "total_s": time.perf_counter() - self.start}


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


#: profiler sessions :func:`device_ms` opens before it gives up on one
#: that records the device's work (on an H100, a session late in a long
#: run has come back with no device events, or part of them, while the
#: work ran)
PROFILE_TRIES = 3
#: a profiler reading below this share of the device time that the same
#: call's CUDA events allow is short: part of the work went unrecorded
PROFILE_FLOOR = 0.5
#: throwaway kernel launches that open every profiler window, their
#: records left out of the reading: a session late in a long run has
#: dropped the records of its first 15-17 kernels, whatever the calls
#: (``scripts/profiler_window.py``), and of its first 60 in another run
#: of the script
PROFILE_WARMUP_LAUNCHES = 256
#: the profiler range around the calls a reading counts
PROFILE_MARK = "chip_smoke.profiled_calls"
#: every short reading :func:`device_ms` turned down, with its call site
#: (the script prints them in its ``profiler`` line)
PROFILE_REJECTED: list = []


def profile_session(fn, calls: int, warmup: int = PROFILE_WARMUP_LAUNCHES,
                    pad_s: float = 0.0):
    """``calls`` back-to-back ``fn()`` under ``torch.profiler``: ``(the
    profiler, the device records of the calls by name, each with its
    ``key``, ``count`` and ``self_device_time_total`` in µs, the host's
    ms per call to launch them under the profiler, the device records the
    session kept of the launches that opened its window (None without
    them))``.  The window opens with a fill and ``warmup`` throwaway
    launches and a 100 ms gap, whose records are left out (the calls'
    are those starting after the range ``PROFILE_MARK`` around them
    opened, less 50 ms: a session's device records have stood up to 27 ms
    off the host's clock); ``pad_s`` holds it open that long before and
    after."""
    from types import SimpleNamespace

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        if warmup:
            scratch = torch.zeros(warmup, device="cuda")
            for i in range(warmup):
                scratch[i].add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.1)
        with record_function(PROFILE_MARK):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3 / calls
            torch.cuda.synchronize()
        time.sleep(pad_s)
    events = prof.events()
    opened = min(e.time_range.start for e in events if e.name == PROFILE_MARK
                 and e.device_type == DeviceType.CPU) - 5e4
    by_name, opening = {}, 0
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name == PROFILE_MARK
                or e.name.startswith("Activity Buffer")):
            continue
        if e.time_range.start < opened:
            opening += 1
            continue
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return (prof, [SimpleNamespace(key=k, count=n, self_device_time_total=us)
                   for k, (n, us) in by_name.items()], host_ms,
            opening if warmup else None)


def host_launch_ms(fn, calls: int) -> float:
    """The host's ms per call to launch ``calls`` back-to-back ``fn()``,
    outside the profiler (which slows the host)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def lost_records(dev: list, calls: int, opening: int | None) -> bool:
    """Whether a session's device records (``dev``, by name with their
    ``count``) show that it lost some of the calls': it kept none of the
    records of the launches that opened its window (``opening``; None:
    it opened with none), so the records it dropped from its start may
    reach into the calls'; or a kernel's count is no multiple of
    ``calls``, each of which launches the same kernels."""
    return opening == 0 or any(e.count % calls for e in dev)


def short_reading(ms: float | None, events_ms: float | None,
                  host_ms: float) -> bool:
    """Whether a profiler reading of ``ms`` per call (None: no device
    events) is below ``PROFILE_FLOOR`` x what the same call's CUDA events
    (``events_ms``; None: not held) allow the device: their time less
    the host's own time to launch the call (``host_ms``,
    :func:`host_launch_ms`), the most the device can idle waiting for
    launches.  A host-bound call, whose host time is ``PROFILE_FLOOR`` x
    its events time or more, is not held to it: the events allow its
    device almost any idle share, and their launch latency outweighs its
    work; :func:`lost_records` guards it."""
    if ms is None:
        return True
    if events_ms is None or host_ms >= PROFILE_FLOOR * events_ms:
        return False
    return ms < PROFILE_FLOOR * (events_ms - host_ms)


def device_ms(fn, calls: int = 20, events_ms: float | None = None
              ) -> tuple[float | None, list[dict]]:
    """Device time per ``fn()`` on the card: the summed duration of every
    kernel and copy that ``calls`` back-to-back calls ran, under
    ``torch.profiler``, over ``calls``; and the same per kernel name.
    Unlike :func:`time_ms` it leaves out the host's time between launches,
    which sets the pace of back-to-back calls that take the device only a
    few microseconds.  A session that records no device work, whose
    records show a loss (:func:`lost_records`), or that records less
    than the call's CUDA events (``events_ms``, :func:`time_ms`'s
    reading) allow (:func:`short_reading`), is run again, up to
    ``PROFILE_TRIES`` times, each such reading kept in
    ``PROFILE_REJECTED``; after that the time is ``None`` (not measured,
    and so is each kernel's), never a short one."""
    fn()
    host_ms = host_launch_ms(fn, calls)
    caller = sys._getframe(1)
    for attempt in range(PROFILE_TRIES):
        _, dev, _, opening = profile_session(fn, calls)
        by_name = [{"name": e.key[:80],
                    "ms": e.self_device_time_total / 1e3 / calls}
                   for e in dev]
        ms = sum(k["ms"] for k in by_name) if dev else None
        if not (lost_records(dev, calls, opening)
                or short_reading(ms, events_ms, host_ms)):
            return ms, by_name
        PROFILE_REJECTED.append({
            "at": f"{Path(caller.f_code.co_filename).name}:"
                  f"{caller.f_lineno}",
            "try": attempt, "ms": ms, "events_ms": events_ms,
            "host_ms": host_ms, "opening_records": opening,
            "device_records": len(dev)})
    return None, [{"name": k["name"], "ms": None} for k in by_name]


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
    ms6 = time_ms(lambda: ops.lut_eval6(ins, lo, hi))
    dev6, kern6 = device_ms(lambda: ops.lut_eval6(ins, lo, hi),
                            events_ms=ms6)
    vals = _level_buffer(rng, level["rows"], level["member_rows"], N6,
                         device)
    largs = (vals, level["ins"], level["tt_lo"], level["tt_hi"],
             level["out"])
    ms_l = time_ms(lambda: ops.lut_eval6_level(*largs))
    dev_l, kern_l = device_ms(lambda: ops.lut_eval6_level(*largs),
                              events_ms=ms_l)
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
        "ms": ms_l, "device_ms": dev_l, "kernels": kern_l,
        "plain_ms": time_ms(lambda: ops.lut_eval6_level(
            *largs, use_kernel=False), reps=3, inner=2),
        **level_rows_once_bound(level, N6),
        "pin_rows_bound_ms": pin_rows["bound_ms"],
        "pin_rows_bound_by": pin_rows["bound_by"], "sass": sass,
        "op": {
            "shape": [M6, 6, N6], "max_abs_err": err6,
            "ms": ms6, "device_ms": dev6, "kernels": kern6,
            "plain_ms": time_ms(lambda: ops.lut_eval6(ins, lo, hi,
                                                      use_kernel=False),
                                reps=3, inner=2),
            **lut_bound_ms(M6, 6, N6, 2), "vector_width": paths}}
    M5, K5 = main_shapes["lut_eval"]
    ins5 = _random_words(rng, (M5, K5, N6), device)
    tts = _random_words(rng, (M5,), device)
    ms5 = time_ms(lambda: ops.lut_eval(ins5, tts))
    dev5, kern5 = device_ms(lambda: ops.lut_eval(ins5, tts), events_ms=ms5)
    recs["lut_eval"] = {
        "shape": [M5, K5, N6], "max_abs_err": err,
        "ms": ms5, "device_ms": dev5, "kernels": kern5,
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
    (q.k and p.v) at the bf16 tensor-core peak, or for float32 the
    3 x 4 D of the three tf32 passes that keep float32 accuracy at the
    tf32 peak, against q read and o written once, and k and v read once
    for every key some query can see, over the HBM rate.  For float32 the
    CUDA-core figure (4 D FLOPs at the fp32 peak) is kept beside it under
    ``fp32_*``."""
    flops = 4 * B * Hq * visible_pairs(S, T, causal, window) * D
    nbytes = elem_bytes * (2 * B * Hq * S * D +
                           2 * B * Hkv * visible_keys(S, T, window) * D)
    if elem_bytes == 2:
        return _bound(flops, BF16_FLOPS, nbytes)
    fp32 = _bound(flops, FP32_FLOPS, nbytes)
    return {**_bound(3 * flops, TF32_FLOPS, nbytes),
            "fp32_flops": fp32["flops"], "fp32_bound_ms": fp32["bound_ms"],
            "fp32_bound_by": fp32["bound_by"]}


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

#: the label of the float32 serving call (whisper-small's encoder on
#: float32 frames), reported beside the bf16 one in the last JSON lines
FLASH_F32_MAIN = "whisper-small serving encoder fp32"
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
    # deepseek-moe-16b: D 128, G 1
    ("deepseek-moe-16b prefill", 8, 16, 16, 512, 512, 128, True,
     HUGE_WINDOW, None, "bfloat16", None),
    ("deepseek-moe-16b decode", 8, 16, 16, 1, 544, 128, True, HUGE_WINDOW,
     None, "bfloat16", 544),
    # llava-next-34b: G 7, 576 patches + a 64-token prompt
    ("llava-next-34b prefill", 1, 56, 8, 640, 640, 128, True, HUGE_WINDOW,
     None, "bfloat16", None),
    ("llava-next-34b decode", 1, 56, 8, 1, 656, 128, True, HUGE_WINDOW,
     None, "bfloat16", 656),
    # whisper-small: the encoder, non-causal over 1,500 frames (bf16 in the
    # teacher-forced forward, float32 in serving), and the decoder's decode
    ("whisper-small encoder", 8, 12, 12, 1500, 1500, 64, False, None, None,
     "bfloat16", None),
    (FLASH_F32_MAIN, 8, 12, 12, 1500, 1500, 64, False, None, None, "float32",
     None),
    ("whisper-small decode", 8, 12, 12, 1, 136, 64, True, HUGE_WINDOW, None,
     "bfloat16", 136),
    # gemma-2b: one kv head at D 256 (G 8), serve_gemma's prompt
    ("gemma-2b prefill", 2, 8, 1, 4608, 4608, 256, True, HUGE_WINDOW, None,
     "bfloat16", None),
    ("gemma-2b decode", 2, 8, 1, 1, 4616, 256, True, HUGE_WINDOW, None,
     "bfloat16", 4624),
    # gemma2-2b's local layers under chunked_local_attn: two blocks of the
    # window (serve_chunked)
    ("gemma2-2b chunked local prefill", 1, 8, 4, 8192, 8192, 256, True,
     4096, 50.0, "bfloat16", None),
    # tinyllama-1.1b's pipeline stages: one microbatch of 2 x 512, G 8
    ("tinyllama-1.1b pipeline stage", 2, 32, 4, 512, 512, 64, True, None,
     None, "bfloat16", None),
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


def sdpa_backend(sdpa) -> list[str]:
    """Names of the device kernels one SDPA call ``sdpa()`` ran (which
    backend)."""
    _, by_name = device_ms(sdpa, calls=1)
    return sorted(k["name"] for k in by_name)


def sdpa_call(q, k, v, causal: bool, window, softcap):
    """The one ``scaled_dot_product_attention`` call that computes what the
    flash kernel does on these inputs (grouped heads through its
    ``enable_gqa``; the queries at the tail of the keys), or None: it has
    no softcap.  Its ``is_causal`` aligns the mask top-left, which is the
    tail alignment only when S == T, and a single tail query sees every
    key; any other causal mask, and a window narrower than the keys, go
    in as a boolean mask."""
    import torch
    import torch.nn.functional as F

    if softcap is not None:
        return None
    S, T = q.shape[2], k.shape[2]
    kw = {"enable_gqa": q.shape[1] != k.shape[1]}
    if (window is None or window >= T) and (not causal or S in (1, T)):
        kw["is_causal"] = causal and S == T
    else:
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
        kpos = torch.arange(T, device=q.device)[None, :]
        mask = kpos > qpos - (T if window is None else window)
        kw["attn_mask"] = mask & (kpos <= qpos) if causal else mask
    return lambda: F.scaled_dot_product_attention(q, k, v, **kw)


def lm_kernel_parity(device) -> dict:
    """Both LM kernels against their plain versions on the card (every
    case within tolerance, else it raises), then each main-path shape
    timed: kernel, plain version, bound and library call."""
    import torch

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
        rec["device_ms"], rec["kernels"] = device_ms(
            lambda: ops.flash_attention(q, k, v, **kw), events_ms=rec["ms"])
        sdpa = sdpa_call(q, k, v, causal, window, softcap)
        if sdpa is not None:
            ok, rec["library_max_abs_err"] = _within(
                sdpa(), want, FLASH_TOL[dt], FLASH_TOL[dt])
            check(ok, f"SDPA on {label} does not compute the kernel's "
                      f"function (max abs err {rec['library_max_abs_err']})")
            rec["library_ms"] = time_ms(sdpa)
            rec["library_device_ms"] = device_ms(
                sdpa, events_ms=rec["library_ms"])[0]
            rec["library_kernels"] = sdpa_backend(sdpa)
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
        ms = time_ms(lambda: ops.bitplane_matmul(x, planes, scale))
        dev_ms, kernels = device_ms(
            lambda: ops.bitplane_matmul(x, planes, scale), events_ms=ms)
        lib_ms = time_ms(lambda: torch.matmul(x, w))
        bit_main.append({
            "shape": [M, K, N, B], "variant": bitplane_variant(M, B),
            "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "kernels": kernels,
            "plain_ms": time_ms(lambda: ops.bitplane_matmul(
                x, planes, scale, use_kernel=False)),
            "library_ms": lib_ms,
            "library_device_ms": device_ms(lambda: torch.matmul(x, w),
                                           events_ms=lib_ms)[0],
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
        ms = time_ms(lambda: ops.ssd_scan(*args))
        dev, kernels = device_ms(lambda: ops.ssd_scan(*args), events_ms=ms)
        return {"p_block": width, "max_abs_err": err, "ms": ms,
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
                lambda: ops.ssd_scan(*args), events_ms=rec["ms"])
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
        "library_equal": bool(torch.equal(lib.float(), got.float())),
        **popcount_bound_ms(M, N, W)}
    pop_main["library_device_ms"] = device_ms(
        lambda: torch.matmul(xs, ws.T), events_ms=pop_main["library_ms"])[0]
    pop_main["device_ms"], pop_main["kernels"] = device_ms(
        lambda: ops.popcount_matmul(x, w, "xnor", kb),
        events_ms=pop_main["ms"])
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
    equivalence gate; geomean ratios against the baseline per suite, and
    each circuit's critical path and area per arch (``records``, which
    the sweep phase holds its paper rows to)."""
    from repro_torch.core import flow

    t0 = time.perf_counter()
    res, counts = _counted(lambda: flow.run_suites(
        suites, ARCH_NAMES, seeds=seeds, check_equiv=True, device=device))
    wall = time.perf_counter() - t0
    ratios = {}
    records = {}
    for suite, rows in res.items():
        per = [flow.ratios_vs_baseline(r["per_arch"]) for r in rows]
        for r in rows:
            check(r["net"] not in records, f"circuit name {r['net']} twice")
            records[r["net"]] = {
                arch: {k: rec[k] for k in ("critical_path_ps", "area_mwta")}
                for arch, rec in r["per_arch"].items()}
            for arch, rec in r["per_arch"].items():
                check(rec["equivalent"], f"{r['net']}@{arch} not equivalent")
        ratios[suite] = {
            arch: {k: geomean(p[arch][k] for p in per)
                   for k in ("area_mwta", "critical_path_ps", "adp")}
            for arch in ARCH_NAMES[1:]}
    return {"phase": "flow", "wall_s": wall, "circuits":
            sum(len(v) for v in suites.values()), "archs": list(ARCH_NAMES),
            "seeds": list(seeds), "geomean_ratios_vs_baseline": ratios,
            "launches": counts, "records": records}


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


def profile_summary(run, device, top: int = 10,
                    ranges: tuple = ()) -> dict:
    """One call of ``run()`` (which ends in a device synchronisation)
    under ``torch.profiler``: its wall, device busy time and idle share,
    device time by kernel and copy (the copies and memsets also on their
    own, by name), the number of kernels launched, and the host operations
    that take the most time.  ``ranges`` names ``record_function`` ranges
    of the program (such as ``blocks.EXPERTS_RANGE``): the device time of
    the kernels each launched is reported with its share of the busy
    time."""
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
    # profiler's overhead, not the program's work, and a range's own
    # device-side annotation is no kernel
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in events if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("Activity Buffer")
                  and e.key not in ranges),
                 key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in dev)
    copies = [r for r in dev if r[0].startswith(("Memcpy", "Memset"))]
    rec = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
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
    if ranges:
        rec["ranges"] = {}
        for label in ranges:
            ev = [e for e in events if e.key == label
                  and e.device_type == DeviceType.CPU]
            ms = ev[0].device_time_total / 1e3 if ev else 0.0
            rec["ranges"][label] = {
                "calls": ev[0].count if ev else 0, "device_ms": ms,
                "share_of_busy": ms / busy if busy else None}
    return rec


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


#: the placed sweep's wire-tier profiles (ps): zero, which reproduces the
#: unplaced timing, and the routed hierarchy of ``benchmarks/place_sweep.py``
SWEEP_WIRE_PROFILES = ((0.0, 0.0, 0.0), (25.0, 40.0, 120.0))
#: the grid rows with the paper's three architectures' parameters
CANONICAL_ROWS = {"baseline": "b0", "dd5": "b2_f10", "dd6": "b2_f10_l6"}
#: the placed sweep runs on the Kratos suite alone, which keeps the whole
#: script near half its time limit (its oracle gate packs each circuit
#: afresh at every point: 42 packs here at 6 points, 98 at 14)
PLACED_SUITES = ("kratos",)
#: the design-space search's parameters (``benchmarks/search_frontier.py``'s
#: but eta 8 for its 4 and rungs from the 2 smallest circuits for its 3,
#: cut for time: 4 rungs in place of 5, 5,213 evaluations in place of
#: 9,626, the same winner; the first rung's packing of every structural
#: class sets the search's time)
SEARCH_PARAMS = {"budget": 6000, "eta": 8, "min_survivors": 8,
                 "min_circuits": 2}


def stable_payload(payload: dict) -> dict:
    """A search payload without its walls (the deterministic part)."""
    return {**payload, "rungs": [{k: v for k, v in r.items() if k != "walls"}
                                 for r in payload["rungs"]]}


def phase_sweep(suites: dict, device, flow_rec: dict, archs=None
                ) -> tuple[dict, dict]:
    """``flow.sweep_architectures`` over the default 7-point grid through
    the torch timing program: cold, then warm with caller-owned packs and
    programs, then warm under ``torch.profiler`` (device busy, idle share,
    kernels launched).  Every record equals the numpy sweep's and the
    Python oracle's, and the rows with the paper's parameters equal the
    flow phase's records.  Returns the record and what the placed phase
    reuses (the unplaced result and the packs)."""
    from repro_torch.core import flow, sweep, timing_vec
    from repro_torch.core.alm import arch_grid

    archs = arch_grid() if archs is None else archs
    packs, programs = {}, {}

    def run():
        res = flow.sweep_architectures(suites, archs=archs, backend="torch",
                                       packs=packs, programs=programs,
                                       device=device)
        _sync(device)
        return res

    built0 = timing_vec.read_compile_counts()["programs"]
    t0 = time.perf_counter()
    cold = run()
    t_cold = time.perf_counter() - t0
    built = timing_vec.read_compile_counts()["programs"] - built0
    t0 = time.perf_counter()
    warm = run()
    t_warm = time.perf_counter() - t0
    check(timing_vec.read_compile_counts()["programs"] == built0 + built,
          "the warm sweep built a timing program again")
    prof = profile_summary(run, device)
    t0 = time.perf_counter()
    plain = flow.sweep_architectures(suites, archs=archs, backend="numpy",
                                     packs=packs)
    t_numpy = time.perf_counter() - t0
    for res, what in ((cold, "cold"), (warm, "warm")):
        check(res.records == plain.records,
              f"the {what} torch sweep differs from the numpy sweep")
    t0 = time.perf_counter()
    check(sweep.oracle_parity(cold, suites, archs),
          "a sweep record differs from the Python oracle")
    t_oracle = time.perf_counter() - t0
    for g, net in enumerate(cold.circuits):
        for arch, row in CANONICAL_ROWS.items():
            got, want = cold.by_arch(row)[g], flow_rec["records"][net][arch]
            check(all(got[k] == want[k] for k in want),
                  f"{net}: sweep row {row} differs from the flow's {arch}")
    rec = {"phase": "sweep", "circuits": len(cold.circuits),
           "archs": cold.archs, "structural_classes": cold.n_classes,
           "wall_s": {"cold": t_cold, "warm": t_warm, "numpy": t_numpy,
                      "oracle_parity": t_oracle},
           "wall_split": {"cold": cold.wall, "warm": warm.wall,
                          "numpy": plain.wall},
           "programs_built": {"cold": built, "warm": 0},
           "profile_warm": {k: prof[k] for k in (
               "wall_ms", "device_busy_ms", "device_idle_share",
               "device_kernel_launches", "copy_ms", "device_ms_by_name")},
           "equal_numpy": True, "oracle_parity": True,
           "canonical_rows_equal_flow": dict(CANONICAL_ROWS),
           "frontier": flow.sweep_frontier(cold, baseline="b0")}
    return rec, {"result": cold, "packs": packs}


def placed_grid() -> list:
    """The placed sweep's points: the ``CANONICAL_ROWS`` (no bypass; full
    bypass at fan-in 10, without and with 6-LUT concurrency) under each
    of ``SWEEP_WIRE_PROFILES``, 6 points (cut from the 7-point grid's 14
    for time: its placed oracle took 82-93 s)."""
    from repro_torch.core.alm import arch_grid

    grid = arch_grid(addmux_fanin=(10,), wire_delays=SWEEP_WIRE_PROFILES)
    check(sorted({a.name.split("_w")[0] for a in grid})
          == sorted(CANONICAL_ROWS.values()) and len(grid) == 6,
          f"the placed grid is {[a.name for a in grid]}")
    return grid


def phase_sweep_placed(suites: dict, device, unplaced, packs: dict,
                       archs=None) -> dict:
    """The placed sweep over :func:`placed_grid`, anneal-refined
    placements, through the torch program: every record equal to the
    placed Python oracle, the zero-wire rows equal to the unplaced
    sweep's (``unplaced`` may cover more circuits than ``suites``)."""
    from repro_torch.core import flow, sweep

    archs = placed_grid() if archs is None else archs
    t0 = time.perf_counter()
    res = flow.sweep_architectures(suites, archs=archs, backend="torch",
                                   packs=packs, place=True, refine="anneal",
                                   device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(sweep.oracle_parity(res, suites, archs, place=True,
                              refine="anneal"),
          "a placed sweep record differs from the placed Python oracle")
    t_oracle = time.perf_counter() - t0
    zero = [a.name for a in archs
            if (a.t_wire_hop1, a.t_wire_hop2, a.t_wire_long) == (0, 0, 0)]
    for name in zero:
        flat = {r["net"]: r for r in unplaced.by_arch(name)}
        check(all(r == flat[r["net"]] for r in res.by_arch(name)),
              f"placed zero-wire row {name} differs from the unplaced one")
    return {"phase": "sweep_placed", "suites": list(suites),
            "circuits": len(res.circuits),
            "archs": res.archs, "structural_classes": res.n_classes,
            "wall_s": wall, "oracle_parity_s": t_oracle,
            "wall_split": res.wall, "oracle_parity": True,
            "zero_wire_rows_equal_unplaced": zero,
            "frontier": flow.sweep_frontier(res, baseline="b0")}


def phase_search(suites: dict, device, archs=None, params=None,
                 packs: dict | None = None) -> dict:
    """``flow.search_design_space`` over the full grid with the torch
    backend and ``verify=True``, then again with the numpy backend (its
    packs are cache hits): equal rungs, survivors, frontier and winner,
    the winners verified.  ``packs``: a pack store to start from (the
    sweep's), shared by both runs.  The winner's packs of the two smallest
    circuits are then proven equivalent by lane simulation on the fused
    evaluator (``lut_eval6`` launches counted)."""
    from repro_torch.core import flow, timing_vec
    from repro_torch.core.alm import full_arch_grid
    from repro_torch.core.equiv import check_pack_equivalence
    from repro_torch.core.search import net_size

    archs = full_arch_grid() if archs is None else archs
    params = SEARCH_PARAMS if params is None else params
    kw = dict(params, archs=archs)
    if packs is not None:
        kw["packs"] = packs
    built0 = timing_vec.read_compile_counts()["programs"]
    t0 = time.perf_counter()
    res, counts = _counted(lambda: flow.search_design_space(
        suites, backend="torch", device=device, verify=True, **kw))
    t_torch = time.perf_counter() - t0
    variants = _variants()["lut_eval6"]
    built = timing_vec.read_compile_counts()["programs"] - built0
    t0 = time.perf_counter()
    plain = flow.search_design_space(suites, backend="numpy", **kw)
    t_numpy = time.perf_counter() - t0
    check(res.survivor_trajectory() == plain.survivor_trajectory(),
          "search survivors differ between the torch and numpy backends")
    check((res.frontier, res.pareto, res.winner)
          == (plain.frontier, plain.pareto, plain.winner),
          "search frontier or winner differs between the backends")
    check(stable_payload(res.payload()) == stable_payload(plain.payload()),
          "search payloads differ between the backends")
    check(res.verify["oracle_match"] and res.verify["equivalent"],
          f"search winners failed verification: {res.verify}")
    winner = {a.name: a for a in archs}[res.winner]
    nets = sorted((n for ns in suites.values() for n in ns),
                  key=lambda n: (net_size(n), n.name))[:2]
    simulated = []
    for net in nets:
        rep, c = _counted(lambda: check_pack_equivalence(
            net, winner, method="simulate", use_fused=True, device=device))
        check(rep["equivalent"], f"{net.name}@{res.winner} not equivalent: "
                                 f"{rep['mismatches'][:1]}")
        simulated.append({"net": net.name, "signals": net.n_signals,
                          "lut_eval6_launches": c["lut_eval6"]})
    sim_launches = sum(r["lut_eval6_launches"] for r in simulated)
    if device.type == "cuda":
        check(sim_launches > 0, "the winner's simulated equivalence did not "
                                "launch lut_eval6")

    def rungs(r):
        return [{"n_archs": g["n_archs"], "n_classes": g["n_classes"],
                 "n_circuits": g["n_circuits"],
                 "n_survivors": len(g["survivors"]), "best": g["best"],
                 "walls": g["walls"]} for g in r.rungs]

    return {"phase": "search", "n_archs": len(archs), "params": params,
            "winner": res.winner,
            "budget_ledger": res.budget,
            "wall_s": {"torch": t_torch, "numpy": t_numpy},
            "walls": {"torch": res.walls, "numpy": plain.walls},
            "rungs": rungs(res), "final_survivors": res.rungs[-1]["survivors"],
            "frontier": res.frontier[:8], "pareto": res.pareto,
            "programs_built": built, "equal_backends": True,
            "verify": res.verify, "verify_launches": counts,
            "verify_variants": variants, "winner_simulated": simulated,
            "launches": {"lut_eval6": counts["lut_eval6"] + sim_launches}}


#: the relaxation's float64 tolerance against ``_smooth_numpy`` on the
#: same start (matmul sums in another order; 32 sweeps amplify ~20x)
RELAX_TOL = 1e-12


def _numpy_chains(ir, arch, seed_pl, mode: str):
    """The numpy form of the annealer's chains (each chain the canonical
    one with ``_rng(chain=ch)``) and its wall; the ensemble phase runs it
    in worker processes."""
    from repro_torch.core import anneal

    t0 = time.perf_counter()
    out = anneal._ensemble_chains(ir, arch, seed_pl, mode=mode,
                                  backend="numpy")
    return out, time.perf_counter() - t0


def _ensemble_case(ir, arch, seed_pl, numpy_chains: dict, device) -> dict:
    """One (circuit, arch) of the ensemble phase, every gate of it but
    determinism: the relaxed members against ``_smooth_numpy``, each
    refine mode's chains against the numpy chains (``numpy_chains[mode]``,
    a future of :func:`_numpy_chains`), the final pick against the host's
    pick over ``[seed] + chains``, legality and never worse than the seed
    (``seed_pl``, the torch ensemble's analytic placement).  The final
    placements go back under ``"final"`` for :func:`_time_case`."""
    from repro_torch.core import anneal, place

    W, H = place.grid_shape(ir.n_lbs, arch.grid_aspect)
    A = place.lb_connectivity(ir)
    pos0 = place._seed_rng(ir.net_digest, arch.placement_key(), 0) \
        .random((place.ENSEMBLES, ir.n_lbs, 2))
    relaxed = place._smooth_torch(A, pos0, device)
    relax_err = 0.0
    for e in range(place.ENSEMBLES):
        want = place._smooth_numpy(A, pos0[e])
        relax_err = max(relax_err, float(np.abs(relaxed[e] - want).max()))
        for a, b in zip(place._legalize(relaxed[e], W, H),
                        place._legalize(want, W, H)):
            check(np.array_equal(a, b), f"{ir.name}@{arch.name}: member {e} "
                                        f"legalizes differently")
    check(relax_err <= RELAX_TOL, f"{ir.name}@{arch.name}: relaxation off "
                                  f"by {relax_err} (> {RELAX_TOL})")
    rec = {"net": ir.name, "arch": arch.name, "lbs": ir.n_lbs,
           "relax_max_abs_err": relax_err,
           "seed_wirelength": seed_pl.wirelength(ir), "final": {}}
    for mode in anneal.REFINE_MODES:
        bc, bx, by = anneal._ensemble_chains(ir, arch, seed_pl, mode=mode,
                                             device=device)
        (nc, nx, ny), t_numpy = numpy_chains[mode].result()
        check(np.array_equal(bx, nx) and np.array_equal(by, ny),
              f"{ir.name}@{arch.name} {mode}: a chain's best placement "
              f"differs from the numpy chain's")
        cost_err = float(np.max(np.abs(bc - nc) / np.maximum(nc, 1.0)))
        check(cost_err == 0.0 if mode == "anneal" else cost_err <= 1e-12,
              f"{ir.name}@{arch.name} {mode}: chain costs off by "
              f"{cost_err} relative")
        final = place.placement_for(ir, arch, 0, cache=False,
                                    backend="torch", refine=mode,
                                    device=device)
        slots = set(zip(final.lb_x.tolist(), final.lb_y.tolist()))
        check(len(slots) == ir.n_lbs and final.grid_w * final.grid_h
              >= ir.n_lbs and (final.lb_x < W).all()
              and (final.lb_y < H).all(),
              f"{ir.name}@{arch.name} {mode}: placement not legal")
        # the refinement objective (the wirelength itself in "anneal",
        # the criticality-weighted one in "anneal_timing") never loses to
        # the seed, and the pick is the host's over [seed] + the chains
        p = anneal._problem(ir, arch, seed_pl, mode, None, None,
                            anneal._DEF_TIMING_WEIGHT,
                            anneal._DEF_CRIT_EXP)
        cands = [(anneal._wirecost(p, p["x0"], p["y0"]), p["x0"], p["y0"])]
        cands += [(anneal._wirecost(p, nx[c], ny[c]), nx[c], ny[c])
                  for c in range(nx.shape[0])]
        cost, px, py = min(cands, key=lambda t: t[0])
        check(np.array_equal(final.lb_x, px) and np.array_equal(
            final.lb_y, py), f"{ir.name}@{arch.name} {mode}: the final "
                             f"pick differs from the host's")
        check(anneal._wirecost(p, final.lb_x.astype(np.int64),
                               final.lb_y.astype(np.int64)) <= cands[0][0],
              f"{ir.name}@{arch.name} {mode}: worse than the seed")
        rec["final"][mode] = final
        rec[mode] = {"chain_costs": bc.tolist(), "cost_rel_err": cost_err,
                     "objective": cost, "seed_objective": cands[0][0],
                     "wirelength": final.wirelength(ir),
                     "numpy_chains_pool_s": t_numpy}
    return rec


def _time_case(ir, arch, rec: dict, device) -> dict:
    """The torch placement of one case, timed with the host to itself
    (after the numpy chains' pool has closed), once per refine mode, and
    equal to the gated placement of ``rec`` (determinism)."""
    from repro_torch.core import place
    from repro_torch.core.anneal import REFINE_MODES

    for mode in REFINE_MODES:
        t0 = time.perf_counter()
        again = place.placement_for(ir, arch, 0, cache=False,
                                    backend="torch", refine=mode,
                                    device=device)
        _sync(device)
        rec[mode]["torch_place_s"] = time.perf_counter() - t0
        final = rec["final"][mode]
        check(np.array_equal(again.lb_x, final.lb_x)
              and np.array_equal(again.lb_y, final.lb_y),
              f"{ir.name}@{arch.name} {mode}: not deterministic")
    del rec["final"]
    return rec


def phase_placement_ensembles(suites: dict, device, archs=("baseline",),
                              workers: int | None = None) -> dict:
    """The ensemble placer and the multi-chain annealer on the card
    (``place_ir(backend="torch", refine=mode)``: ``place.ENSEMBLES``
    members, ``anneal.CHAINS`` chains, default steps and moves, no
    cache) over every circuit of ``suites`` under ``archs``, gated case
    by case (:func:`_ensemble_case`).  The numpy chains the gates hold
    the batch to, independent of each other and of the card, run in
    ``workers`` processes (default: one per host core), largest case
    first, while the card works; their walls (``numpy_chains_pool_s``)
    are taken with every core busy and are the gate's cost, not the numpy
    path's.  Once the pool has closed, each case's torch placement is
    timed again with the host to itself and checked for determinism
    (:func:`_time_case`), and the largest case is placed by each backend
    in each refine mode under ``torch.profiler`` (wall, kernels
    launched, idle share) with its final wirelength."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.core import anneal, place
    from repro_torch.core.alm import ARCHS
    from repro_torch.core.anneal import REFINE_MODES
    from repro_torch.core.packing import pack

    nets = [n for ns in suites.values() for n in ns]
    irs = [(pack(n, ARCHS[a]).lower_ir(), ARCHS[a])
           for a in archs for n in nets]
    t0 = time.perf_counter()
    seeds = [place.place_ir(ir, arch, 0, backend="torch", device=device)
             for ir, arch in irs]
    workers = workers or os.cpu_count() or 1
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures: dict = {}
        for i in sorted(range(len(irs)), key=lambda i: -irs[i][0].n_lbs):
            for mode in REFINE_MODES:
                futures[i, mode] = pool.submit(_numpy_chains, *irs[i],
                                               seeds[i], mode)
        cases = [_ensemble_case(ir, arch, seeds[i],
                                {m: futures[i, m] for m in REFINE_MODES},
                                device)
                 for i, (ir, arch) in enumerate(irs)]
    t_gates = time.perf_counter() - t0
    cases = [_time_case(ir, arch, rec, device)
             for (ir, arch), rec in zip(irs, cases)]
    ir, arch = max(irs, key=lambda t: t[0].n_lbs)
    largest = {"net": ir.name, "arch": arch.name, "lbs": ir.n_lbs}
    for backend in ("torch", "numpy"):
        kw = {"device": device} if backend == "torch" else {}
        for mode in REFINE_MODES:
            out = []

            def run():
                out.append(place.place_ir(ir, arch, 0, backend=backend,
                                          refine=mode, **kw))
                _sync(device)

            prof = profile_summary(run, device)
            largest[f"{backend}/{mode}"] = {
                "wirelength": out[0].wirelength(ir),
                **{k: prof[k] for k in (
                    "wall_ms", "device_busy_ms", "device_idle_share",
                    "device_kernel_launches", "device_ms_by_name")}}
    per_mode = {mode: {k: sum(c[mode][k] for c in cases) for k in (
        "torch_place_s", "numpy_chains_pool_s", "wirelength")}
        for mode in REFINE_MODES}
    return {"phase": "placement_ensembles", "circuits": len(nets),
            "archs": list(archs), "ensembles": place.ENSEMBLES,
            "anneal_chains": anneal.CHAINS, "workers": workers,
            "wall_s": t_gates,
            "relax_tol": RELAX_TOL, "totals": per_mode,
            "largest": largest, "cases": cases}


def serve_pool(smoke: bool = False) -> list:
    """The flow server's request pool: the full mode of the reference's
    ``benchmarks/serve_latency.py`` (six circuits x baseline / DD5), or
    two small circuits for the CPU rehearsal."""
    from repro_torch.core.circuits import kratos_gemm, sha_like, vtr_mixed

    if smoke:
        nets = [kratos_gemm(m=4, n=4, width=5, sparsity=0.5),
                sha_like(rounds=1)]
    else:
        nets = [kratos_gemm(m=5, n=5, width=5, sparsity=0.5),
                kratos_gemm(m=6, n=6, width=6, sparsity=0.5),
                sha_like(rounds=1), sha_like(rounds=2),
                vtr_mixed(logic_nodes=150, adders=2),
                vtr_mixed(logic_nodes=300, adders=4)]
    return [(net, arch) for net in nets for arch in ("baseline", "dd5")]


def edit_stream(base_net, n_edits: int, seed: int = 0) -> list:
    """``n_edits`` single-LUT variants of ``base_net``, as the reference
    benchmark draws them: fanin rewires (structural, the dirty-set path)
    with every third a truth-table edit (the tt-only delta)."""
    import random

    from repro_torch.core.edits import (clone_netlist, edit_lut_tt,
                                        edit_rewire_fanin,
                                        safe_rewire_sources)

    rng = random.Random(seed + 1)
    out = []
    while len(out) < n_edits:
        li = rng.randrange(base_net.n_luts)
        new_net = clone_netlist(base_net)
        if len(out) % 3 == 2:
            tt = rng.getrandbits(1 << len(base_net.lut_inputs[li]))
            if tt == base_net.lut_tt[li]:
                continue
            edit_lut_tt(new_net, li, tt)
            kind = "lut_tt"
        else:
            srcs = safe_rewire_sources(base_net, li)
            if not srcs:
                continue
            src = rng.choice(srcs)
            pin = rng.randrange(len(base_net.lut_inputs[li]))
            if base_net.lut_inputs[li][pin] == src:
                continue
            edit_rewire_fanin(new_net, li, pin, src)
            kind = "rewire_fanin"
        out.append((new_net, kind))
    return out


_SERVE_WALLS = ("timing_s", "build_s", "lower_s", "eval_s")


def _serve_pass(reqs: list, n_clients: int, server_kwargs: dict):
    """One closed-loop pass: ``n_clients`` tasks drain ``reqs`` round
    robin (client ``c`` owns requests ``c, c + n, ...``).  Returns the
    results in request order and the pass's reading: throughput, p50 /
    p99 latency, batches, coalesced requests, and the wall split summed
    over its batches."""
    import asyncio

    from repro_torch.core.serve_flow import FlowServer

    async def main():
        server = FlowServer(**server_kwargs)
        results: list = [None] * len(reqs)

        async def client(ci: int):
            for j in range(ci, len(reqs), n_clients):
                results[j] = await server.submit(reqs[j])

        t0 = time.perf_counter()
        try:
            await asyncio.gather(*(client(c) for c in range(n_clients)))
        finally:
            await server.aclose()
        return results, time.perf_counter() - t0, dict(server.stats)

    results, wall, stats = asyncio.run(main())
    lat = np.array([r.walls["total_s"] for r in results]) * 1e3
    return results, {
        "wall_s": wall, "throughput_rps": len(reqs) / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "n_batches": stats["n_batches"], "n_jobs": stats["n_jobs"],
        "n_coalesced": stats["n_coalesced"],
        "wall_split": _wall_split(results)}


def _wall_split(results) -> dict:
    """The served requests' stage walls, summed over their batches."""
    batches = {r.batch["id"]: r.walls["stages"] for r in results}
    return {k: sum(b[k] for b in batches.values()) for k in _SERVE_WALLS}


def phase_serve_flow(device, pool=None, n_requests: int = 64,
                     client_counts=(8, 32), eval_nets=None,
                     n_lane_words: int = N_LANE_WORDS, edit_net=None,
                     n_edits: int = 6) -> dict:
    """The flow server (``flow.serve`` and ``FlowServer``) with both
    timing backends, in three passes:

    (a) coalescing: ``n_requests`` area + timing requests round robin
        over ``pool``, ``memoize=False``, at each client count, cold
        (caches cleared) then warm;
    (b) eval: ``eval_nets`` under DD5 with area, timing and eval at
        ``n_lane_words`` lane words, through ``flow.serve`` (counted:
        one ``lut_eval6_level`` launch per LUT level on the card);
    (c) an edit stream of ``n_edits`` on ``edit_net`` under DD5 with
        ``base_digest`` set and ``verify_deltas=True``.

    Every served record equals the serial ``pack_and_analyze(net, arch,
    seeds=(seed,))``, the two backends' records are identical, the eval
    lanes equal a direct plain-torch ``evaluate_suite`` (``use_kernel=
    False``) and the Python oracle on the two smallest circuits, and at least one edit takes the incremental
    path with no failed proof."""
    import asyncio

    from repro_torch.core import flow, plan
    from repro_torch.core.circuits import kratos_gemm
    from repro_torch.core.flow import _METRIC_KEYS, pack_and_analyze
    from repro_torch.core.serve_flow import FlowRequest, FlowServer

    pool = serve_pool() if pool is None else pool
    if eval_nets is None:
        eval_nets = [n for ns in full_suites().values() for n in ns]
    if edit_net is None:
        edit_net = kratos_gemm(m=6, n=6, width=6, sparsity=0.5)
    serial: dict = {}

    def check_serial(results, reqs, what):
        for req, res in zip(reqs, results):
            key = (req.net.content_digest(), req.arch)
            if key not in serial:
                serial[key] = pack_and_analyze(req.net, req.arch,
                                               seeds=(req.seed,))
            check(all(res.record[k] == serial[key][k]
                      for k in _METRIC_KEYS),
                  f"{what}: {req.net.name}@{req.arch} differs from the "
                  f"serial flow")

    reqs = [FlowRequest(*pool[j % len(pool)], analyses=("area", "timing"))
            for j in range(n_requests)]
    coalescing: dict = {}
    records: dict = {}
    for backend in ("torch", "numpy"):
        kw = {"timing_backend": backend, "memoize": False,
              "device": device}
        for n_cl in client_counts:
            for temp in ("cold", "warm"):
                if temp == "cold":
                    plan.clear_caches()
                results, reading = _serve_pass(reqs, n_cl, kw)
                check_serial(results, reqs, f"{backend}/{n_cl}/{temp}")
                coalescing[f"{backend}/clients{n_cl}/{temp}"] = reading
                records.setdefault(backend, [r.record for r in results])
    check(records["torch"] == records["numpy"],
          "the torch and numpy timing backends serve different records")

    lanes = [flow.random_lanes(n, n_lane_words, seed=0) for n in eval_nets]
    ereqs = [FlowRequest(n, "dd5", analyses=("area", "timing", "eval"),
                         n_lane_words=n_lane_words) for n in eval_nets]
    # the plain torch evaluator on the same card: the server's kernel
    # path is held to the plain version
    direct, _ = flow.evaluate_suite(eval_nets, lanes, n_lane_words,
                                    use_kernel=False, device=device)
    evals: dict = {}
    eval_launches = 0
    for backend in ("torch", "numpy"):
        plan.clear_caches()
        t0 = time.perf_counter()
        results, counts = _counted(lambda: flow.serve(
            ereqs, timing_backend=backend, device=device))
        variants = _variants()["lut_eval6"]
        _sync(device)
        wall = time.perf_counter() - t0
        check_serial(results, ereqs, f"eval/{backend}")
        for n, res, vals in zip(eval_nets, results, direct):
            for name, bus in n.pos.items():
                check(np.array_equal(res.analyses["eval"][name],
                                     vals[np.asarray(bus, dtype=np.int64)]),
                      f"eval/{backend}: {n.name} PO {name} differs from "
                      f"evaluate_suite")
        records[f"eval/{backend}"] = [r.record for r in results]
        if device.type == "cuda":
            check(counts["lut_eval6"] > 0,
                  f"eval/{backend}: the server did not launch lut_eval6")
        eval_launches += counts["lut_eval6"]
        evals[backend] = {"wall_s": wall, "n_batches": len(
            {r.batch["id"] for r in results}),
            "wall_split": _wall_split(results), "launches": counts,
            "variants": variants}
    check(records["eval/torch"] == records["eval/numpy"],
          "eval: the torch and numpy timing backends serve different "
          "records")
    smallest = sorted(range(len(eval_nets)),
                      key=lambda i: (eval_nets[i].n_signals,
                                     eval_nets[i].name))[:2]
    words = sorted({0, n_lane_words - 1})
    for i in smallest:
        check(flow.oracle_check(eval_nets[i], lanes[i], direct[i],
                                n_lane_words, words=words),
              f"eval: {eval_nets[i].name} differs from the Python oracle")

    stream = edit_stream(edit_net, n_edits)
    sreqs = [FlowRequest(n, "dd5", base_digest=edit_net.content_digest())
             for n, _ in stream]
    edit_recs: dict = {}
    for backend in ("torch", "numpy"):

        async def base_then_edits():
            server = FlowServer(timing_backend=backend, memoize=False,
                                verify_deltas=True, device=device)
            try:
                await server.submit(FlowRequest(edit_net, "dd5"))
                return [await server.submit(req) for req in sreqs]
            finally:
                await server.aclose()

        plan.clear_caches()
        results = asyncio.run(base_then_edits())
        check_serial(results, sreqs, f"edits/{backend}")
        recs = []
        for (_, kind), r in zip(stream, results):
            d = r.delta or {}
            recs.append({"kind": kind,
                         "latency_ms": r.walls["total_s"] * 1e3,
                         "delta_mode": d.get("mode"),
                         "repack_mode": (d.get("repack") or {}).get("mode"),
                         "verify_method": (d.get("verify") or {})
                         .get("method"),
                         "verify_ok": (d.get("verify") or {})
                         .get("equivalent")})
        n_inc = sum(r["repack_mode"] == "incremental" for r in recs)
        check(n_inc >= 1, f"edits/{backend}: no edit took the incremental "
                          f"path")
        check(all(r["verify_ok"] is not False for r in recs),
              f"edits/{backend}: a delta failed its proof")
        records[f"edits/{backend}"] = [r.record for r in results]
        edit_recs[backend] = {"edits": recs, "n_incremental": n_inc,
                              "p50_ms": float(np.percentile(
                                  [r["latency_ms"] for r in recs], 50))}
    check(records["edits/torch"] == records["edits/numpy"],
          "edits: the torch and numpy timing backends serve different "
          "records")
    return {"phase": "serve_flow",
            "pool": [[n.name, a] for n, a in pool],
            "n_requests": n_requests, "coalescing": coalescing,
            "eval": {"circuits": len(eval_nets), "arch": "dd5",
                     "n_lane_words": n_lane_words, **evals,
                     "oracle_checked": [eval_nets[i].name
                                        for i in smallest]},
            "edit_stream": {"circuit": edit_net.name, "arch": "dd5",
                            **edit_recs},
            "equal_serial": True, "equal_backends": True,
            "launches": {"lut_eval6": eval_launches}}


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
    greedy tokens.  An encdec model's frames or a vlm model's patches come
    with the prompts (``serve.make_inputs``).  A MoE model's
    routing is recorded on both paths (:func:`route_recorder`): the share
    of (token, layer, choice) that agree and the smallest top-k margin.
    Raises on any difference."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm

    prompts, extra = serve.make_inputs(cfg32, batch, prompt_len, device,
                                       seed=0)
    with route_recorder() as kroutes:
        (kern, counts) = _counted(lambda: serve.generate(
            cfg32, params32, prompts, max_new, keep_logits=True, **extra))
    variants = _variants()
    with route_recorder() as proutes:
        plain = serve.generate(cfg32, params32, prompts, max_new,
                               use_kernel=False, keep_logits=True, **extra)
    d_plain = float((kern["logits"] - plain["logits"]).abs().max())
    routing = routing_agreement(kroutes, proutes)
    check(d_plain <= tol, f"{cfg32.name}: kernel-path logits differ from "
                          f"the plain path by {d_plain} (tol {tol}; "
                          f"routing {routing})")
    check(torch.equal(kern["tokens"], plain["tokens"]),
          f"{cfg32.name}: greedy tokens differ between the kernel and plain "
          f"paths (routing {routing})")
    fed = torch.cat([prompts, kern["tokens"][:, :-1]], dim=1)
    hidden, _ = lm.forward(cfg32, params32, fed, return_hidden=True,
                           **extra)
    P = extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0
    tf = lm.unembed(cfg32, params32, hidden[:, P + prompt_len - 1:]).float()
    d_tf = float((kern["logits"] - tf).abs().max())
    check(d_tf <= tol, f"{cfg32.name}: cached logits differ from the "
                       f"teacher-forced forward by {d_tf} (tol {tol})")
    check(bool(torch.isfinite(kern["logits"]).all()),
          f"{cfg32.name}: non-finite logits")
    return {"batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            **({k: list(v.shape) for k, v in extra.items()}),
            "max_abs_logit_diff_vs_plain": d_plain,
            "max_abs_logit_diff_vs_forward": d_tf, "tol": tol,
            "tokens_identical": True, "launches": counts,
            "variants": variants, **({"routing": routing} if routing else {}),
            "first_row": kern["tokens"][0].tolist()}


def forced_logits(cfg, params, prompts, tokens, use_kernel: bool,
                  extra: dict | None = None):
    """Serving with the tokens forced (teacher forcing through the cache):
    prefill ``prompts [B, S]`` (with ``extra``: an encdec model's frames
    or a vlm model's P patches), then decode ``tokens [B, n]`` one by one
    from position ``S + P``.  Returns the float32 logits ``[B, n, V]`` of
    the prefill's last position and of the first n - 1 decode steps,
    aligned with ``serve.generate``'s when ``tokens`` are its own."""
    import torch

    from repro_torch.serve.decode import decode_step, prefill
    from repro_torch.serve.kvcache import init_cache

    extra = extra or {}
    B, S = prompts.shape
    n = tokens.shape[1]
    P = extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0
    enc = extra.get("encoder_feats")
    cache = init_cache(cfg, B, S + P + n, device=prompts.device,
                       encoder_len=None if enc is None else enc.shape[1])
    logits, cache = prefill(cfg, params, cache, prompts,
                            use_kernel=use_kernel, **extra)
    kept = [logits.float()]
    for i in range(n - 1):
        logits, cache = decode_step(cfg, params, cache, tokens[:, i:i + 1],
                                    S + P + i, use_kernel=use_kernel)
        kept.append(logits.float())
    return torch.cat(kept, dim=1)


def serve_gate_bf16(cfg, cfg32, params32, params, batch: int,
                    prompt_len: int, max_new: int, device) -> dict:
    """bfloat16 serving through the kernels (prefill on the mma variant,
    decode on the split variant) against the plain paths.

    The float32 plain path serves greedily; its tokens are then forced
    through the bfloat16 kernel path, the bfloat16 plain path (the
    reference's masked attention) and the float32 plain path on the
    bfloat16-rounded weights, so all logits sit on the same tokens.  A
    MoE model's routing is forced alike (:func:`route_recorder`'s replay
    of the float32 run's choices): a bfloat16 rounding flips a top-k
    choice whose margin is smaller, and one flipped choice moves the
    token's logits by far more than the rounding (PERF.md).  The
    choices each bfloat16 path would have made, and the smallest margin,
    are reported under ``routing``.  Two
    bounds, each ``max(SERVE_TOL, NOISE_MARGIN x d)`` with d measured in
    this run (as :func:`forward_gate` calibrates the SSM gates):

    - the kernel path against the float32 run, d the bfloat16 plain
      path's own disagreement with it (weights and activations rounded);
    - the kernel path against the bfloat16 plain path (the same weights,
      the same precision), d the bfloat16 plain path's disagreement with
      float32 activations on the same rounded weights: the rounding of
      activations alone, which is all the two bfloat16 paths can differ
      by.  At every forced position the kernel path's greedy token must
      also be a greedy token of the plain path (its argmax, or a token
      tied with it: bfloat16 logits over a large vocabulary can tie
      exactly, and argmax then picks the lowest index).

    Also reported: the share of greedy tokens that agree with float32."""
    import torch

    from repro_torch.launch import serve

    prompts, extra = serve.make_inputs(cfg32, batch, prompt_len, device,
                                       seed=0)
    with route_recorder() as routes32:
        ref32 = serve.generate(cfg32, params32, prompts, max_new,
                               use_kernel=False, keep_logits=True, **extra)
    replay = routes32 or None
    forced = ref32["tokens"]
    rounded32 = cast_params(params, torch.float32)
    with route_recorder(replay):
        act32 = forced_logits(cfg32, rounded32, prompts, forced, False,
                              extra)
    del rounded32
    with route_recorder(replay) as kroutes:
        kern, counts = _counted(lambda: forced_logits(cfg, params, prompts,
                                                      forced, True, extra))
    variants = _variants()
    with route_recorder(replay) as proutes:
        plain = forced_logits(cfg, params, prompts, forced, False, extra)
    routing = routing_agreement(kroutes, proutes)
    if routing:
        routing["replayed"] = "the float32 plain run's choices"
        routing["kernel_agree_share_vs_float32"] = routing_agreement(
            kroutes, routes32)["agree_share"]
    d_plain = float((plain - ref32["logits"]).abs().max())
    d = float((kern - ref32["logits"]).abs().max())
    tol = max(SERVE_TOL, NOISE_MARGIN * d_plain)
    d_act = float((plain - act32).abs().max())
    d_same = float((kern - plain).abs().max())
    tol_same = max(SERVE_TOL, NOISE_MARGIN * d_act)
    top, top_plain = kern.argmax(-1), plain.argmax(-1)
    # the kernel's greedy token must be a greedy token of the plain path:
    # where the plain path's top logits tie (bf16 rounds them together),
    # argmax's lowest-index pick is not the only one
    hits = plain.gather(-1, top[..., None])[..., 0] == plain.amax(-1)
    agree = float(hits.float().mean())
    flips_act = int((top_plain != act32.argmax(-1)).sum())
    gap2 = plain.topk(2, dim=-1).values
    gap2 = gap2[..., 0] - gap2[..., 1]
    where = (~hits).nonzero().tolist()
    disagree = [{"position": w, "plain_top2_gap": float(gap2[tuple(w)]),
                 "plain_token_as_float32_activations": bool(
                     top_plain[tuple(w)] == act32[tuple(w)].argmax()),
                 "kernel_vs_plain_logit_diff": float(
                     (kern[tuple(w)] - plain[tuple(w)]).abs().max())}
                for w in where[:8]]
    check(_finite(kern), f"{cfg.name}: non-finite bf16 logits")
    check(d <= tol, f"{cfg.name}: bf16 kernel-path logits differ from the "
                    f"float32 run by {d} (tol {tol}; routing {routing})")
    check(d_same <= tol_same,
          f"{cfg.name}: bf16 kernel-path logits differ from the bf16 plain "
          f"path by {d_same} (tol {tol_same}; routing {routing})")
    check(agree == 1.0, f"{cfg.name}: bf16 kernel-path greedy tokens agree "
                        f"with the bf16 plain path at {agree} of positions "
                        f"(routing {routing}; {disagree}; the plain path's "
                        f"argmax differs from float32 activations' at "
                        f"{flips_act}; smallest plain top-2 gap "
                        f"{float(gap2.min())}; tol {tol_same}, d {d_same})")
    return {"batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            "dtype": cfg.compute_dtype,
            "max_abs_logit_diff_vs_float32": d,
            "plain_bf16_vs_float32": d_plain, "tol": tol,
            "max_abs_logit_diff_vs_plain_bf16": d_same,
            "plain_bf16_vs_float32_activations": d_act,
            "tol_vs_plain_bf16": tol_same,
            "logit_scale": float(ref32["logits"].abs().max()),
            "greedy_agreement_vs_plain_bf16": agree,
            "argmax_flips_plain_vs_float32_activations": flips_act,
            "min_plain_top2_gap": float(gap2.min()),
            "plain_top2_ties": int((gap2 == 0).sum()),
            "greedy_accepted_by_tie": int((hits & (top != top_plain)).sum()),
            "greedy_agreement_vs_float32": float(
                (top == ref32["logits"].argmax(-1)).float().mean()),
            "launches": counts, "variants": variants,
            **({"routing": routing} if routing else {})}


def serve_timed(cfg, params, batch: int, prompt_len: int, max_new: int,
                device) -> dict:
    """One warm-up, then the timed serving run with its launches counted
    and the device's peak memory over it."""
    import torch

    from repro_torch.launch import serve

    prompts, extra = serve.make_inputs(cfg, batch, prompt_len, device,
                                       seed=1)
    serve.generate(cfg, params, prompts, 2, **extra)  # warm
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res, counts = _counted(lambda: serve.generate(cfg, params, prompts,
                                                  max_new, **extra))
    return {"batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            **({k: list(v.shape) for k, v in extra.items()}),
            "dtype": cfg.compute_dtype, "prefill_ms": res["prefill_ms"],
            "decode_ms_per_step": res["decode_ms_per_step"],
            "tok_per_s": res["tok_per_s"],
            "decode_tok_per_s": res["decode_tok_per_s"],
            "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
            "launches": counts, "variants": _variants()}


def check_flash_variants(rec: dict) -> None:
    """A dense serving phase's flash calls went through every variant its
    path has: the float32 gate through ``tf32x3``; the timed bfloat16 run's
    prefill (one call per layer) through ``mma`` and each decode step's
    through ``split``."""
    layers, steps = rec["layers"], rec["timed"]["max_new"] - 1
    gate = rec["gate"]["variants"]["flash_attention"]
    timed = rec["timed"]["variants"]["flash_attention"]
    check(gate["tf32x3"] == rec["gate"]["launches"]["flash_attention"] > 0,
          f"{rec['arch']}: the float32 gate's flash variants were {gate}")
    check(timed == {"mma": layers, "split": layers * steps, "tf32x3": 0},
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


#: the serving phases of the dense configs that run nowhere else on the
#: card, sized as serve_gemma2: (phase, arch), the gate's and the timed
#: run's (batch, prompt, new tokens)
SERVE_MORE = (("serve_qwen", "qwen1.5-0.5b"), ("serve_gemma", "gemma-2b"))
SERVE_MORE_GATE, SERVE_MORE_TIMED = (1, 4608, 4), (2, 4608, 16)


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

    toks = serve.make_inputs(cfg32, batch, seq_len, device, seed=3)[0]
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

    toks = serve.make_inputs(cfg, batch, seq_len, device, seed=3)[0]
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

    toks = serve.make_inputs(cfg, batch, seq_len, device, seed=4)[0]

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

    toks = serve.make_inputs(cfg, batch, seq_len, device, seed=2)[0]
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
                        top: int = 10, ranges: tuple = ()) -> dict:
    """A warm prefill and a warm decode step under ``torch.profiler``
    (``ranges``: the program's named ranges to report, see
    :func:`profile_summary`)."""
    from repro_torch.launch import serve
    from repro_torch.serve.decode import decode_step, prefill
    from repro_torch.serve.kvcache import init_cache

    prompts, extra = serve.make_inputs(cfg, batch, prompt_len, device,
                                       seed=2)
    P = extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0
    enc = extra.get("encoder_feats")
    cache = init_cache(cfg, batch, P + prompt_len + 1, device=device,
                       encoder_len=None if enc is None else enc.shape[1])
    tok = prompts[:, -1:]

    def run_prefill():
        prefill(cfg, params, cache, prompts, **extra)
        _sync(device)

    def run_decode():
        decode_step(cfg, params, cache, tok, P + prompt_len)
        _sync(device)

    run_prefill()  # warm
    run_decode()
    return {"phase": "profile_decode", "arch": cfg.name, "batch": batch,
            "prompt_len": prompt_len, "dtype": cfg.compute_dtype,
            "prefill": profile_summary(run_prefill, device, top, ranges),
            "decode_step": profile_summary(run_decode, device, top, ranges)}


# ---------------------------------------------------------------------------
# the MoE, vision-language and encoder-decoder families; the int8 KV cache
# ---------------------------------------------------------------------------

#: the new families' serving runs: gates (batch, prompt, new tokens),
#: timed runs (batch, prompt, new tokens), whisper's teacher-forced
#: forward gate (batch, tokens)
MOE_GATE, MOE_TIMED = (2, 128, 16), (8, 512, 32)
VLM_GATE, VLM_TIMED = (1, 64, 16), (1, 64, 16)
ENCDEC_GATE, ENCDEC_FORWARD, ENCDEC_TIMED = (2, 8, 16), (2, 24), (8, 8, 128)
#: depth of the float32 gates where full-width float32 weights do not fit
#: on the card beside the bf16 ones: deepseek-moe-16b's dense layer and 3
#: MoE layers (65.6 GB float32 at full depth), llava-next-34b's first 2
#: layers (137.6 GB)
MOE_GATE_LAYERS = 4
VLM_GATE_LAYERS = 2


@contextlib.contextmanager
def route_recorder(replay: list | None = None):
    """Inside the ``with``, every routing decision of the MoE blocks
    (``blocks._moe_route``) is recorded: per call, each token's k chosen
    experts (sorted), the margin by which the k-th choice beat the next
    (a float difference below it can flip the choice) and the choices as
    made.  With ``replay`` (another run's records, call by call) the
    choices are replaced by that run's, with the gates the router's own
    ``blocks._moe_gates`` makes of them; the records keep the choices
    this run would have made.  Yields the list of records."""
    from repro_torch.models import blocks

    route = blocks._moe_route
    calls = []

    def recording(cfg, p, ht):
        probs, gates, onehot = route(cfg, p, ht)
        K = cfg.top_k
        vals = blocks.topk_lowest_index(probs, min(K + 1, cfg.n_experts))[0]
        margin = (vals[..., K - 1] - vals[..., K]) if K < cfg.n_experts \
            else None
        idx = onehot.argmax(-1)   # the router's own choices, in its order
        calls.append((idx.sort(-1).values.reshape(-1, K), margin, idx))
        if replay is not None:
            forced = replay[len(calls) - 1][2]
            gates, onehot = blocks._moe_gates(probs, forced,
                                              cfg.n_experts)
        return probs, gates, onehot

    blocks._moe_route = recording
    try:
        yield calls
    finally:
        blocks._moe_route = route


def routing_agreement(a: list, b: list) -> dict | None:
    """Two runs' routing records (:func:`route_recorder`) compared: the
    share of (token, layer, choice) entries that agree and the smallest
    top-k margin either run saw.  None when neither run routed."""
    if not a and not b:
        return None
    check(len(a) == len(b) and all(x[0].shape == y[0].shape
                                   for x, y in zip(a, b)),
          "the two runs routed a different number of tokens")
    agree = sum(int((x[0] == y[0]).sum()) for x, y in zip(a, b))
    total = sum(x[0].numel() for x in a)
    margins = [float(r[1].min()) for run in (a, b) for r in run
               if r[1] is not None]
    return {"routing_calls": len(a), "choices": total,
            "agree_share": agree / total,
            "min_topk_margin": min(margins) if margins else None}


def params_bytes(params: dict, dtype_bytes: int = 2) -> int:
    """The bytes of a weight tree's leaves at ``dtype_bytes`` each."""
    from repro_torch import tree

    return sum(t.numel() * dtype_bytes for t in tree.leaves(params))


def cut_depth(cfg, n: int):
    """``cfg`` with ``n`` decoder layers (a MoE model keeps its dense
    layers among them)."""
    return dataclasses.replace(cfg, n_layers=min(n, cfg.n_layers))


def check_timed_variants(name: str, run: dict, want: dict) -> None:
    """A timed run's flash calls per variant and in all, as expected."""
    got = run["variants"]["flash_attention"]
    check(got == {**{"mma": 0, "split": 0, "tf32x3": 0}, **want}
          and run["launches"]["flash_attention"] == sum(want.values()),
          f"{name}: flash variants {got} "
          f"({run['launches']['flash_attention']} launches), expected "
          f"{want}")


def phase_serve_moe(cfg, device, gate: tuple, timed: tuple,
                    seed: int = 0) -> tuple[dict, dict]:
    """deepseek-moe-16b at full width: the float32 gate and the bfloat16
    gate (:func:`serve_gate`, :func:`serve_gate_bf16`, routing recorded)
    over the first ``MOE_GATE_LAYERS`` layers (the dense layer, then MoE
    layers), then a timed bfloat16 run at full depth on weights drawn in
    bfloat16.  Returns the record and the state the int8 phase reuses:
    the cut float32 weights and the full bf16 weights."""
    import torch

    from repro_torch.launch import serve

    cut = cut_depth(cfg, MOE_GATE_LAYERS)
    cut32 = as_float32(cut)
    params32 = serve.make_params(cut32, device, seed=seed)
    gate_rec = serve_gate(cut32, params32, *gate, device)
    cut_bf16 = cast_params(params32, getattr(torch, cfg.param_dtype))
    bf16_rec = serve_gate_bf16(cut, cut32, params32, cut_bf16, *gate,
                               device)
    del cut_bf16
    params = serve.make_params(cfg, device, seed=seed)
    timed_rec = serve_timed(cfg, params, *timed, device)
    L = cfg.n_layers
    rec = {"phase": "serve_moe", "arch": cfg.name, "layers": L,
           "dense_layers": cfg.n_dense_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
           "experts": [cfg.n_experts, cfg.top_k, cfg.n_shared_experts,
                       cfg.d_ff_expert], "vocab": cfg.vocab,
           "weights_gb": params_bytes(params) / 1e9,
           "gate_layers": cut.n_layers, "gate": gate_rec,
           "gate_bf16": bf16_rec, "timed": timed_rec,
           "flash_launches_expected": L * timed[2]}
    if device.type == "cuda":
        check_flash_variants({**rec, "gate": gate_rec})
    return rec, {"cut32": cut32, "params32": params32, "params": params}


def int8_gate(cfg32, params32, batch: int, prompt_len: int, max_new: int,
              device, tol: float = SERVE_TOL) -> dict:
    """Float32 serving from the int8 cache, the kernel route against the
    plain route over the same cache: the plain route serves greedily;
    then, position by position, both routes take the same step (the
    prefill from the empty cache, each decode step from a copy of the
    plain route's cache) on the plain route's tokens.  So the two read the
    same codes but for the rows the step writes itself (a float32
    difference in a projection can move one of those codes by 1; the
    prefill's share of moved codes is reported).  Logits within ``tol``
    and every greedy token equal; raises otherwise."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.serve.decode import decode_step, prefill
    from repro_torch.serve.kvcache import init_cache

    prompts, _ = serve.make_inputs(cfg32, batch, prompt_len, device, seed=0)
    tokens = serve.generate(cfg32, params32, prompts, max_new,
                            use_kernel=False)["tokens"]
    cache = init_cache(cfg32, batch, prompt_len + max_new, device=device)
    kcache = {k: v.clone() for k, v in cache.items()}
    with route_recorder() as kroutes:
        (kern, _), counts = _counted(lambda: prefill(cfg32, params32, kcache,
                                                     prompts))
    variants = _variants()["flash_attention"]
    with route_recorder() as proutes:
        plain, _ = prefill(cfg32, params32, cache, prompts, use_kernel=False)
    moved = {n: float((kcache[n] != cache[n]).float().mean())
             for n in ("k", "v")}
    biggest = max(int((kcache[n].int() - cache[n].int()).abs().max())
                  for n in ("k", "v"))
    del kcache
    kern, plain = [kern.float()], [plain.float()]
    for i in range(max_new - 1):
        tok, pos = tokens[:, i:i + 1], prompt_len + i
        kc = {k: v.clone() for k, v in cache.items()}
        with route_recorder() as kr:
            (k_logits, _), c = _counted(lambda: decode_step(
                cfg32, params32, kc, tok, pos))
        v = _variants()["flash_attention"]
        with route_recorder() as pr:
            p_logits, _ = decode_step(cfg32, params32, cache, tok, pos,
                                      use_kernel=False)
        del kc
        kroutes += kr
        proutes += pr
        counts = {n: counts[n] + c[n] for n in counts}
        variants = {n: variants[n] + v[n] for n in variants}
        kern.append(k_logits.float())
        plain.append(p_logits.float())
    kern, plain = torch.cat(kern, dim=1), torch.cat(plain, dim=1)
    d = float((kern - plain).abs().max())
    routing = routing_agreement(kroutes, proutes)
    check(_finite(kern), f"{cfg32.name}: non-finite int8-cache logits")
    check(d <= tol, f"{cfg32.name}: int8-cache kernel-route logits differ "
                    f"from the plain route by {d} (tol {tol}; routing "
                    f"{routing}; prefill codes moved {moved})")
    check(torch.equal(kern.argmax(-1), plain.argmax(-1)),
          f"{cfg32.name}: int8-cache greedy tokens differ between the "
          f"routes (routing {routing})")
    return {"batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            "max_abs_logit_diff_vs_plain": d, "tol": tol,
            "logit_scale": float(plain.abs().max()),
            "prefill_codes_moved_share": moved,
            "prefill_codes_max_abs_move": biggest,
            "tokens_identical": True, "launches": counts,
            "variants": {"flash_attention": variants},
            **({"routing": routing} if routing else {})}


def phase_serve_moe_int8(cfg, state: dict, device, gate: tuple,
                         timed: tuple) -> dict:
    """The same weights with ``kv_cache_dtype="int8"``.  Gates: the
    float32 kernel route against the plain route over the same int8 cache
    (:func:`int8_gate`) and the bfloat16 gate (:func:`serve_gate_bf16`:
    each route over its own int8 cache), both over the first
    ``MOE_GATE_LAYERS`` layers.  At full depth
    in bfloat16, reported with no limit (the reference sets none): the
    bf16-cache run's tokens forced through the int8 cache, their logits'
    distance from the bf16 cache's and the share of greedy tokens that
    agree; the two caches' bytes; a timed int8 run."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.serve.kvcache import init_cache

    def int8(c):
        return dataclasses.replace(c, kv_cache_dtype="int8")

    cut32, params32, params = state["cut32"], state["params32"], \
        state["params"]
    gate_rec = int8_gate(int8(cut32), params32, *gate, device)
    cut = dataclasses.replace(cut32, param_dtype=cfg.param_dtype,
                              compute_dtype=cfg.compute_dtype)
    cut_bf16 = cast_params(params32, getattr(torch, cfg.param_dtype))
    bf16_rec = serve_gate_bf16(int8(cut), int8(cut32), params32, cut_bf16,
                               *gate, device)
    del cut_bf16
    B, S, n = timed
    prompts, _ = serve.make_inputs(cfg, B, S, device, seed=1)
    base = serve.generate(cfg, params, prompts, n, keep_logits=True)
    forced = forced_logits(int8(cfg), params, prompts, base["tokens"], True)
    diff = forced - base["logits"]
    nbytes = {}
    for name, c in (("bf16", cfg), ("int8", int8(cfg))):
        cache = init_cache(c, B, S + n, device=device)
        nbytes[name] = sum(t.numel() * t.element_size()
                           for t in cache.values())
        del cache
    vs_bf16 = {"max_abs_logit_diff": float(diff.abs().max()),
               "rms_logit_diff": float(diff.pow(2).mean().sqrt()),
               "logit_scale": float(base["logits"].abs().max()),
               "greedy_agreement": float((forced.argmax(-1) ==
                                          base["tokens"]).float().mean()),
               "cache_bytes": nbytes,
               "cache_bytes_ratio": nbytes["int8"] / nbytes["bf16"]}
    check(_finite(forced), f"{cfg.name}: non-finite int8-cache logits")
    timed_rec = serve_timed(int8(cfg), params, *timed, device)
    L = cfg.n_layers
    rec = {"phase": "serve_moe_int8", "arch": cfg.name, "layers": L,
           "gate_layers": cut32.n_layers, "gate": gate_rec,
           "gate_bf16": bf16_rec, "vs_bf16_cache": vs_bf16,
           "timed": timed_rec, "flash_launches_expected": L * timed[2]}
    if device.type == "cuda":
        check_flash_variants(rec)
    return rec


def phase_serve_vlm(cfg, device, gate: tuple, timed: tuple,
                    seed: int = 0) -> dict:
    """llava-next-34b at full width: the float32 and bfloat16 gates over
    its first ``VLM_GATE_LAYERS`` layers (576 patch embeddings before the
    prompt), then a timed bfloat16 run at full depth on weights drawn in
    bfloat16 (the card's free memory before them and their bytes are
    reported; a run that does not fit fails)."""
    import torch

    from repro_torch.launch import serve

    cut = cut_depth(cfg, VLM_GATE_LAYERS)
    cut32 = as_float32(cut)
    params32 = serve.make_params(cut32, device, seed=seed)
    gate_rec = serve_gate(cut32, params32, *gate, device)
    cut_bf16 = cast_params(params32, getattr(torch, cfg.param_dtype))
    bf16_rec = serve_gate_bf16(cut, cut32, params32, cut_bf16, *gate,
                               device)
    del params32, cut_bf16
    free = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(device)[0]
    params = serve.make_params(cfg, device, seed=seed)
    timed_rec = serve_timed(cfg, params, *timed, device)
    rec = {"phase": "serve_vlm", "arch": cfg.name, "layers": cfg.n_layers,
           "free_gb_before_weights": None if free is None else free / 1e9,
           "weights_gb": params_bytes(params) / 1e9,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.hd, "patches": cfg.n_patches, "vocab": cfg.vocab,
           "gate_layers": cut.n_layers, "gate": gate_rec,
           "gate_bf16": bf16_rec, "timed": timed_rec,
           "flash_launches_expected": cfg.n_layers * timed[2]}
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
        check_flash_variants(rec)
    return rec


def forward_gate_inputs_bf16(cfg, params, batch: int, seq_len: int,
                             device) -> dict:
    """The bfloat16 teacher-forced forward (with an encdec model's frames
    or a vlm model's patches) through the kernels against the bfloat16
    plain forward, within ``max(SERVE_TOL, NOISE_MARGIN x d')`` in the
    largest logit, d' the plain forward's disagreement with float32
    activations on the same bfloat16 weights (the rounding of activations
    alone); the share of argmax positions that agree is reported."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm

    toks, extra = serve.make_inputs(cfg, batch, seq_len, device, seed=3)
    kern, counts = _counted(lambda: lm.forward(cfg, params, toks,
                                               **extra)[0].float())
    variants = _variants()
    plain = lm.forward(cfg, params, toks, use_kernel=False,
                       **extra)[0].float()
    act32 = lm.forward(as_float32(cfg), cast_params(params, torch.float32),
                       toks, use_kernel=False, **extra)[0].float()
    d_act = float((plain - act32).abs().max())
    d = float((kern - plain).abs().max())
    tol = max(SERVE_TOL, NOISE_MARGIN * d_act)
    check(_finite(kern), f"{cfg.name}: non-finite bf16 forward logits")
    check(d <= tol, f"{cfg.name}: bf16 kernel-path forward differs from the "
                    f"bf16 plain forward by {d} (tol {tol})")
    return {"batch": batch, "seq_len": seq_len, "dtype": cfg.compute_dtype,
            **({k: list(v.shape) for k, v in extra.items()}),
            "max_abs_logit_diff_vs_plain_bf16": d,
            "plain_bf16_vs_float32_activations": d_act, "tol": tol,
            "logit_scale": float(plain.abs().max()),
            "argmax_agreement_vs_plain_bf16": float(
                (kern.argmax(-1) == plain.argmax(-1)).float().mean()),
            "launches": counts, "variants": variants}


def phase_serve_encdec(cfg, device, gate: tuple, forward: tuple,
                       timed: tuple, seed: int = 0) -> dict:
    """whisper-small at full size: the float32 gate and the bfloat16 gate
    over all 12 + 12 layers with 1,500 frames, the teacher-forced
    bfloat16 forward gate (:func:`forward_gate_inputs_bf16`), then a timed
    bfloat16 run.  As in the reference, serving does not cast the float32
    frames, so its encoder runs in float32 (flash ``tf32x3``); the forward
    casts them (``mma``)."""
    import torch

    from repro_torch.kernels.flash_attention import variant as flash_variant
    from repro_torch.launch import serve

    cfg32 = as_float32(cfg)
    params32 = serve.make_params(cfg32, device, seed=seed)
    gate_rec = serve_gate(cfg32, params32, *gate, device)
    params = cast_params(params32, getattr(torch, cfg.param_dtype))
    bf16_rec = serve_gate_bf16(cfg, cfg32, params32, params, *gate, device)
    del params32
    fwd_rec = forward_gate_inputs_bf16(cfg, params, *forward, device)
    timed_rec = serve_timed(cfg, params, *timed, device)
    L, Le = cfg.n_layers, cfg.n_encoder_layers
    steps = timed[2] - 1
    rec = {"phase": "serve_encdec", "arch": cfg.name, "layers": L,
           "encoder_layers": Le, "encoder_seq": cfg.encoder_seq,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "head_dim": cfg.hd, "vocab": cfg.vocab, "gate": gate_rec,
           "gate_bf16": bf16_rec, "forward_bf16": fwd_rec,
           "timed": timed_rec,
           "flash_launches_expected": Le + L * timed[2]}
    if device.type == "cuda":
        gate_v = gate_rec["variants"]["flash_attention"]
        check(gate_v["tf32x3"] == gate_rec["launches"]["flash_attention"] > 0,
              f"{cfg.name}: the float32 gate's flash variants were {gate_v}")
        G = cfg.n_heads // cfg.n_kv_heads
        want = {"mma": 0, "split": L * steps, "tf32x3": Le}
        want[flash_variant(torch.bfloat16, timed[1], G)] += L
        check_timed_variants(cfg.name, timed_rec, want)
        want = {"mma": Le, "split": 0, "tf32x3": 0}
        want[flash_variant(torch.bfloat16, forward[1], G)] += L
        check_timed_variants(f"{cfg.name} forward", fwd_rec, want)
    return rec


# ---------------------------------------------------------------------------
# training: the flash route under autograd, the train step, checkpoints
# ---------------------------------------------------------------------------

#: FLASH_CASES whose queries are more than one token (the calls a training
#: forward makes are of this kind) at every head dimension, and gemma2-2b's
#: own attention (D 256, its window of 4096 over 4608 keys, softcap 50):
#: (label, B, Hq, Hkv, S, T, D, causal, window, softcap)
FLASH_GRAD_CASES = [(*c[:6], D, *c[6:]) for c in FLASH_CASES if c[4] > 1
                    for D in FLASH_DIMS] + [
    ("gemma2-2b local", 1, 8, 4, 4608, 4608, 256, True, 4096, 50.0)]
#: tinyllama-1.1b's attention in the training run: [B, Hq, S, D] over Hkv
#: kv heads
TRAIN_ATTN = (4, 32, 4, 2048, 2048, 64)
#: the training phase: the float32 gate's (layers, batch, seq), the timed
#: run's (steps, batch, seq), the step whose checkpoint the resumed run
#: starts from, and AdamW at the train launcher's defaults
TRAIN_GATE = (4, 2, 512)
TRAIN_TIMED = (12, 4, 2048)
TRAIN_SAVE_AT = 6
#: the depth of the copy the checkpoint check trains and resumes (at the
#: timed run's width, batch and sequence): the full depth's 13.2 GB of
#: AdamW state took most of the phase's time to write and read
TRAIN_RESUME_LAYERS = 2
TRAIN_OPT = {"lr": 3e-3, "warmup_steps": 5}
#: the float32 gate's floor, the North star's grads tolerance
TRAIN_TOL = 1e-4
#: :func:`time_ms`'s repetitions for a call of a second or more
HEAVY_REPS = dict(reps=3, inner=2, warmup=1)


def flash_grad_parity(device, cases=FLASH_GRAD_CASES,
                      dtypes=("float32", "bfloat16"), seed: int = 0) -> dict:
    """The flash route under autograd (``FlashAttentionFn``: the kernel
    forward on the card) against the plain version: the output within
    ``FLASH_TOL``, and dq, dk, dv for the same q, k, v and upstream
    gradient equal, bit for bit, to autograd through the plain version
    (the backward is that recompute).  Raises on the first difference."""
    import torch

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device).manual_seed(seed)
    worst = {}
    for dt in dtypes:
        worst[dt] = 0.0
        for label, B, Hq, Hkv, S, T, D, causal, window, softcap in cases:
            q, k, v = [t.detach().requires_grad_() for t in _attn_inputs(
                gen, B, Hq, Hkv, S, T, D, _dtype(dt), device)]
            g = torch.randn((B, Hq, S, D), generator=gen, device=device,
                            dtype=torch.float32).to(_dtype(dt))
            kw = dict(causal=causal, window=window, softcap=softcap)
            out = ops.flash_attention(q, k, v, **kw)
            check(type(out.grad_fn).__name__ == "FlashAttentionFnBackward",
                  f"flash {label}: not routed through FlashAttentionFn")
            plain = ref.flash_attention_ref(q, k, v, **kw)
            ok, err = _within(out.detach(), plain.detach(), FLASH_TOL[dt],
                              FLASH_TOL[dt])
            check(ok, f"flash {label} D={D} {dt}: the autograd route's "
                      f"forward differs from the plain version ({err})")
            got = torch.autograd.grad(out, (q, k, v), g)
            want = torch.autograd.grad(plain, (q, k, v), g)
            for name, a, b in zip("qkv", got, want):
                check(torch.equal(a, b),
                      f"flash {label} D={D} {dt}: d{name} differs from "
                      f"autograd through the plain version")
            worst[dt] = max(worst[dt], err)
    return {"max_abs_err": worst, "cases": len(cases) * len(dtypes)}


def flash_backward_bound_ms(B, Hq, Hkv, S, T, D, elem_bytes,
                            causal: bool = True) -> dict:
    """Least time for a fused attention backward: 10 D FLOPs per visible
    pair (the scores recomputed, dV, dP, dQ and dK: five products) at the
    bf16 peak, against q, o, dO and the logsumexp read, k and v read, and
    dq, dk, dv written once."""
    pairs = visible_pairs(S, T, causal, None)
    nbytes = elem_bytes * (3 * B * Hq * S * D + 2 * B * Hkv * T * D
                           + B * Hq * S * D + 2 * B * Hkv * T * D) \
        + 4 * B * Hq * S
    return _bound(10 * B * Hq * pairs * D, BF16_FLOPS, nbytes)


def train_shape_inputs(device, shape=TRAIN_ATTN, seed: int = 2):
    """bf16 ``(q, k, v, g)`` at the training run's attention shape, as the
    model hands them over (:func:`_attn_inputs`), with an upstream
    gradient ``g`` of the output's shape."""
    import torch

    B, Hq, Hkv, S, T, D = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = _attn_inputs(gen, B, Hq, Hkv, S, T, D, torch.bfloat16, device)
    g = torch.randn((B, Hq, S, D), generator=gen, device=device,
                    dtype=torch.float32).to(torch.bfloat16)
    return q, k, v, g


def train_forward_parity(q, k, v) -> float:
    """The flash forward at the training run's shape (causal, the full
    window), by both routes the training step takes — the kernel under
    ``no_grad`` and ``FlashAttentionFn`` on inputs that need a gradient —
    against the plain version on the same inputs, within ``FLASH_TOL``
    of their type.  Returns the larger max-abs error; raises on a miss."""
    import torch

    from repro_torch.kernels import ops, ref

    kw = dict(causal=True, window=HUGE_WINDOW, softcap=None)
    tol = FLASH_TOL[str(q.dtype).removeprefix("torch.")]
    with torch.no_grad():
        plain = ref.flash_attention_ref(q, k, v, **kw)
        kern = ops.flash_attention(q, k, v, **kw)
    qd, kd, vd = [t.detach().requires_grad_() for t in (q, k, v)]
    routed = ops.flash_attention(qd, kd, vd, **kw)
    check(type(routed.grad_fn).__name__ == "FlashAttentionFnBackward",
          "flash at the training shape: not routed through FlashAttentionFn")
    worst = 0.0
    for how, out in (("kernel", kern), ("autograd route", routed.detach())):
        ok, err = _within(out, plain, tol, tol)
        check(ok, f"flash at the training shape {list(q.shape)} over "
                  f"{k.shape[1]} kv heads: the {how}'s forward differs from "
                  f"the plain version ({err})")
        worst = max(worst, err)
    return worst


def phase_flash_backward(device, shape=TRAIN_ATTN) -> dict:
    """``flash_backward_parity``: :func:`flash_grad_parity`, then at the
    training run's attention shape (bf16) the forward held to the plain
    version by both routes (:func:`train_forward_parity`) and timed:
    :func:`train_attention_timing` (the kernel forward, the recomputing
    backward, SDPA with ``enable_gqa``, the bounds), and beside it the
    plain forward, forward + backward through the autograd route, and
    SDPA on K / V repeated to the query heads.  The training shape's
    error joins the bf16 ``max_abs_err``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    t0 = time.perf_counter()
    parity = flash_grad_parity(device)
    parity_s = time.perf_counter() - t0
    B, Hq, Hkv, S, T, D = shape
    rec = train_attention_timing(B, Hq, Hkv, S, D, True, device)
    q, k, v, g = train_shape_inputs(device, shape)
    train_err = max(rec["max_abs_err"], train_forward_parity(q, k, v))
    parity["max_abs_err"]["bfloat16"] = max(parity["max_abs_err"]["bfloat16"],
                                            train_err)
    qd, kd, vd = [t.detach().requires_grad_() for t in (q, k, v)]
    kw = dict(causal=True, window=HUGE_WINDOW, softcap=None)
    G = Hq // Hkv
    kr, vr = (t.repeat_interleave(G, dim=1) for t in (kd, vd))

    def plain_fwd():
        with torch.no_grad():
            return ref.flash_attention_ref(q, k, v, **kw)

    def route_fwd_bwd():
        return torch.autograd.grad(ops.flash_attention(qd, kd, vd, **kw),
                                   (qd, kd, vd), g)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, kr, vr, is_causal=True)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qd, kr, vr, is_causal=True)
        return torch.autograd.grad(out, (qd, kr, vr), g)

    rec.update(shape={"q": [B, Hq, S, D], "kv": [B, Hkv, T, D]},
               variant="mma", max_abs_err=train_err,
               tol=FLASH_TOL["bfloat16"])
    if device.type == "cuda":
        rec.update(plain_ms=time_ms(plain_fwd, **HEAVY_REPS),
                   route_forward_backward_ms=time_ms(route_fwd_bwd,
                                                     **HEAVY_REPS),
                   repeat_kv={"library_forward_ms": time_ms(sdpa_fwd),
                              "library_forward_backward_ms": time_ms(
                                  sdpa_fwd_bwd, **HEAVY_REPS)})
        rec["library_ms"] = min(rec["library_forward_ms"],
                                rec["repeat_kv"]["library_forward_ms"])
    return {"phase": "flash_backward_parity", **parity,
            "parity_wall_s": parity_s, "train_shape": rec}


def train_model_flops(cfg, batch: int, seq: int) -> int:
    """Model FLOPs of one training step (no recompute counted): 6 per
    parameter and token for every weight but the input embedding (a
    gather), and causal attention's 6 L (Hq D) S per token (its two
    products forward and four backward over half the pairs)."""
    d, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    attn = d * cfg.n_heads * cfg.hd * 2 + d * cfg.n_kv_heads * cfg.hd * 2
    ffn = d * (F_ if cfg.act == "gelu_mlp" else 2 * F_) + F_ * d
    n = L * (attn + ffn) + d * cfg.vocab  # the unembedding
    tokens = batch * seq
    return 6 * n * tokens + 6 * L * cfg.n_heads * cfg.hd * seq * tokens


def _rel(a, b) -> float:
    """``||a - b|| / ||b||`` (float64 norms), ``a`` moved to ``b``'s
    device."""
    a, b = a.to(b.device).double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _float64(cfg):
    return dataclasses.replace(cfg, param_dtype="float64",
                               compute_dtype="float64")


def _gate_setup(cfg, device, layers: int, batch: int, seq: int,
                seed: int = 0, float32: bool = True):
    """``(cut config, weights, host batch, TrainConfig)`` of a train-step
    gate: the config cut to its first ``layers`` decoder layers
    (:func:`cut_depth`: a MoE model keeps its dense layers, an encdec
    model every encoder layer) in float32 (``float32``, else in its own
    types), seed-0 weights drawn at that depth on ``device``, one
    ``batch_for_step`` batch, AdamW at the train launcher's defaults."""
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch import serve
    from repro_torch.train import optimizer
    from repro_torch.train import step as tstep

    cut = cut_depth(cfg, layers)
    cut = as_float32(cut) if float32 else cut
    params = serve.make_params(cut, device, seed=seed)
    host = batch_for_step(cut, seq, batch, 0, seed=seed)
    tcfg = tstep.TrainConfig(opt=optimizer.OptConfig(
        decay_steps=TRAIN_TIMED[0], **TRAIN_OPT))
    return cut, params, host, tcfg


def _fresh_adamw(params) -> dict:
    """A fresh AdamW state for ``params``: ``optimizer.adamw_init``'s
    zeros; for plain tensors as zero scalars broadcast to each leaf's
    shape (the same numbers, none of the memory: a full-width gate holds
    several runs' results on the card at once)."""
    import torch

    from repro_torch import tree
    from repro_torch.parallel.api import is_distributed
    from repro_torch.train import optimizer

    leaves = tree.leaves(params)
    if any(is_distributed(p) for p in leaves):
        return optimizer.adamw_init(params)

    def zeros(p):
        return torch.zeros((), dtype=torch.float32,
                           device=p.device).expand(p.shape)

    return {"mu": tree.map(zeros, params), "nu": tree.map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device)}


def gate_step(cfg, tcfg, params, data, use_kernel: bool):
    """One train step of a gate at ``params``: ``(loss, gradients,
    parameters after one AdamW update from a fresh state)``."""
    from repro_torch.train import optimizer
    from repro_torch.train import step as tstep

    (_, (loss, _)), grads = tstep.value_and_grad(
        tstep.make_loss_fn(cfg, tcfg, use_kernel), params, data)
    new, _, _ = optimizer.adamw_update(tcfg.opt, grads,
                                       _fresh_adamw(params), params)
    return loss, grads, new


def _sign_flips(a, b) -> float:
    """The share of entries whose sign differs between ``a`` and ``b``."""
    import torch

    return float((torch.sign(a.to(b.device).float())
                  != torch.sign(b.float())).float().mean())


def _step_distances(a, b) -> dict:
    """Two gate runs' results (loss, flattened gradients, stepped
    parameter leaves) compared: the loss's relative distance, each
    leaf's normwise one (:func:`_rel`, ``b`` the reference) and each
    gradient leaf's share of entries of the other sign."""
    (la, ga, pa), (lb, gb, pb) = a, b
    return {"loss": abs(la - lb) / abs(lb),
            "grads": {"/".join(path): _rel(x, y)
                      for (path, x), (_, y) in zip(ga, gb)},
            "post": {"/".join(path): _rel(x, y)
                     for (path, _), x, y in zip(ga, pa, pb)},
            "sign_flips": {"/".join(path): _sign_flips(x, y)
                           for (path, x), (_, y) in zip(ga, gb)}}


def step_gate(name: str, runs, subject: str, baseline: str,
              noise: tuple, hold_post: bool = True) -> dict:
    """The rule of every train-step gate.  ``runs``: ``(label, fn)``
    pairs run in order, each ``fn()`` giving one step's ``(loss,
    gradients, stepped parameters)`` (:func:`gate_step`); the
    ``subject`` run's launches, kernel variants and flash heads are
    counted.  The subject's loss, every gradient leaf and (with
    ``hold_post``) every stepped parameter leaf must lie within
    ``max(TRAIN_TOL, NOISE_MARGIN x d)`` of the ``baseline`` run's,
    normwise, d the same quantity's distance between the two ``noise``
    runs (a step and the same step in a wider type); without
    ``hold_post`` the stepped parameters are reported only.  Beside each
    stepped parameter, the share of its gradient's entries whose sign
    the subject and the noise runs flip (AdamW's first step moves each
    weight by about the learning rate times that sign).  A run's
    results are reduced to these distances, and dropped, as soon as no
    comparison still needs them.  Raises on a miss."""
    import torch

    from repro_torch import tree
    from repro_torch.kernels import ops

    pairs = {"subject": (subject, baseline), "noise": tuple(noise)}
    held, dist, losses, counted = {}, {}, {}, {}
    for label, fn in runs:
        if label == subject:
            (loss, grads, new), launches = _counted(fn)
            counted = {"launches": launches, "variants": _variants(),
                       "flash_heads": ops.flash_head_counts()}
        else:
            loss, grads, new = fn()
        losses[label] = float(loss)
        held[label] = (losses[label], tree.flatten_with_path(grads),
                       tree.leaves(new))
        del grads, new
        for key, (a, b) in pairs.items():
            if key not in dist and a in held and b in held:
                dist[key] = _step_distances(held[a], held[b])
        needed = {x for k, p in pairs.items() if k not in dist for x in p}
        for done in [k for k in held if k not in needed]:
            del held[done]
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    s_key = f"{subject}_vs_{baseline}"
    n_key = f"{noise[0]}_vs_{noise[1]}"

    def rows(what: str) -> dict:
        return {path: {s_key: e, n_key: dist["noise"][what][path],
                       "tol": max(TRAIN_TOL,
                                  NOISE_MARGIN * dist["noise"][what][path])}
                for path, e in dist["subject"][what].items()}

    grads, post = rows("grads"), rows("post")
    for path, r in post.items():
        r["grad_sign_flips"] = {key: dist[k]["sign_flips"][path]
                                for k, key in (("subject", s_key),
                                               ("noise", n_key))}
    worst = max(r[s_key] / r["tol"] for r in grads.values())
    worst_post = max(r[s_key] / r["tol"] for r in post.values())
    d_loss, e_loss = dist["noise"]["loss"], dist["subject"]["loss"]
    tol_loss = max(TRAIN_TOL, NOISE_MARGIN * d_loss)
    over = {f"{what} {p}": r for what, t in (("grad", grads), ("post", post))
            for p, r in t.items() if r[s_key] > r["tol"]}
    check(e_loss <= tol_loss and worst <= 1.0
          and (worst_post <= 1.0 or not hold_post),
          f"{name}: loss {e_loss} (tol {tol_loss}), worst gradient at "
          f"{worst} and worst stepped parameter at {worst_post} of its "
          f"tolerance: {over}")
    return {"loss": {**losses, s_key: e_loss, n_key: d_loss,
                     "tol": tol_loss},
            "grads": grads, "worst_grad_share_of_tol": worst,
            "post_step_params": post,
            "worst_post_step_share_of_tol": worst_post,
            "post_step_held": hold_post, **counted}


def train_gate(cfg, device, layers: int, batch: int, seq: int,
               seed: int = 0) -> dict:
    """The float32 gate of the training path over the config's first
    ``layers`` layers (:func:`_gate_setup`): :func:`step_gate` with the
    kernel route (flash ``tf32x3`` under autograd) as the subject, the
    plain route as its baseline, and the plain route in float64 on the
    same weights and batch for the noise: the loss, every gradient and
    every parameter after one AdamW step.  Raises on a miss."""
    import torch

    from repro_torch.data.pipeline import to_device

    cut, params, host, tcfg = _gate_setup(cfg, device, layers, batch, seq,
                                          seed)
    data = to_device(host, device)
    rec = step_gate(f"{cfg.name} train gate", [
        ("float64", lambda: gate_step(_float64(cut), tcfg, cast_params(
            params, torch.float64), data, False)),
        ("plain", lambda: gate_step(cut, tcfg, params, data, False)),
        ("kernel", lambda: gate_step(cut, tcfg, params, data, True))],
        "kernel", "plain", ("plain", "float64"))
    return {"layers": layers, "batch": batch, "seq_len": seq, **rec}


def train_gate_bf16(cfg, device, layers: int, batch: int, seq: int,
                    seed: int = 0) -> dict:
    """The bf16 gate of the training path over the config's first
    ``layers`` layers, in its own types (:func:`_gate_setup`):
    :func:`step_gate` with the kernel route (flash ``mma`` under
    autograd) as the subject, the plain route as its baseline, and for
    the noise the plain route against the same step in float32 on the
    same bf16 weights (the rounding of activations and gradients alone):
    the loss and every gradient.  The parameters after one AdamW step
    are reported, not held: that step moves each weight by about the
    learning rate times its gradient's sign, so where a gradient entry
    is within the bf16 noise of 0 its sign is noise too, and in a
    zero-initialised norm of 1,536 entries one such flip moves the leaf
    by 2 / sqrt(1536), about 5 %.  Raises on a miss."""
    import torch

    from repro_torch.data.pipeline import to_device

    cut, params, host, tcfg = _gate_setup(cfg, device, layers, batch, seq,
                                          seed, float32=False)
    data = to_device(host, device)
    rec = step_gate(f"{cfg.name} bf16 train gate", [
        ("float32", lambda: gate_step(as_float32(cut), tcfg, cast_params(
            params, torch.float32), data, False)),
        ("plain_bf16", lambda: gate_step(cut, tcfg, params, data, False)),
        ("kernel_bf16", lambda: gate_step(cut, tcfg, params, data, True))],
        "kernel_bf16", "plain_bf16", ("plain_bf16", "float32"),
        hold_post=False)
    return {"layers": layers, "batch": batch, "seq_len": seq,
            "dtype": cut.compute_dtype, **rec}


def host_gate(cfg, device, layers: int, batch: int, seq: int,
              seed: int = 0) -> dict:
    """The float32 gate of a family that trains on the plain route alone
    (ssm, hybrid: the SSD kernel has no backward, so the kernel and plain
    routes are one): :func:`step_gate` with the card's float32 plain step
    as the subject and the same step in float64 on the host CPU (the same
    weights and batch) as its baseline, the noise the host's own float32
    step against its float64 one.  Raises on a miss."""
    import torch

    from repro_torch import tree
    from repro_torch.data.pipeline import to_device

    cut, params, host, tcfg = _gate_setup(cfg, device, layers, batch, seq,
                                          seed)
    cpu = torch.device("cpu")
    on_host = tree.map(lambda t: t.to(cpu), params)
    rec = step_gate(f"{cfg.name} host gate", [
        ("host_float64", lambda: gate_step(
            _float64(cut), tcfg, cast_params(on_host, torch.float64),
            to_device(host, cpu), False)),
        ("host_float32", lambda: gate_step(cut, tcfg, on_host,
                                           to_device(host, cpu), False)),
        ("card", lambda: gate_step(cut, tcfg, params,
                                   to_device(host, device), False))],
        "card", "host_float64", ("host_float32", "host_float64"))
    return {"layers": layers, "batch": batch, "seq_len": seq, **rec}


def _state_leaves(res: dict) -> list:
    from repro_torch import tree

    return tree.leaves((res["params"], res["opt_state"]))


def _train_setup(cfg, device, steps: int, batch: int, seq: int,
                 seed: int = 0, **train_kw):
    """``(tcfg, fresh params, FitConfig maker)`` of the training phase:
    AdamW at the train launcher's defaults (``train_kw``: more
    ``TrainConfig`` fields), seed-0 weights in the config's own types,
    the synthetic stream."""
    from repro_torch.launch import serve
    from repro_torch.train import optimizer
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import FitConfig

    tcfg = tstep.TrainConfig(opt=optimizer.OptConfig(
        decay_steps=max(steps, 10), **TRAIN_OPT), **train_kw)

    def fresh():
        return serve.make_params(cfg, device, seed=seed)

    def fitc(n: int, d, every: int) -> FitConfig:
        return FitConfig(steps=n, ckpt_every=every, ckpt_dir=str(d),
                         seq_len=seq, global_batch=batch, seed=seed)

    return tcfg, fresh, fitc


def train_timed(cfg, device, steps: int, batch: int, seq: int, workdir,
                save_at: int) -> tuple[dict, dict]:
    """``fit`` for ``steps`` steps from seed-0 weights in the config's own
    types, checkpointing into ``workdir`` every ``save_at`` steps and at
    the end (what :func:`train_resume` reads): each step's wall (``fit``'s:
    host clock to the loss on the host, which waits for the device, the
    saves left out), tokens / s, peak device memory, model-FLOPs share of
    the bf16 peak, loss and flash launches, read by a hook.  The losses
    must be finite and the last three's mean below the first.  Returns the
    record and the run's final state."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.train.loop import fit

    tcfg, fresh, fitc = _train_setup(cfg, device, steps, batch, seq)
    cuda = device.type == "cuda"
    per_step = []

    def hook(s, m):
        row = {"step": s, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]),
               "flash_calls_so_far": ops.flash_attention.launches}
        if cuda:
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
            torch.cuda.reset_peak_memory_stats(device)
        per_step.append(row)

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    whole = fit(cfg, fresh(), fitc(steps, workdir, save_at), tcfg,
                hooks=[hook])
    counts, variants = ops.launch_counts(), _variants()
    flops = train_model_flops(cfg, batch, seq)
    before = 0
    for row, wall in zip(per_step, whole["step_s"]):
        n = row.pop("flash_calls_so_far")
        row["flash_launches"], before = n - before, n
        row["wall_ms"] = wall * 1e3
        row["tok_per_s"] = batch * seq / wall
        row["model_flops_share_of_bf16_peak"] = flops / wall / BF16_FLOPS
    losses = whole["losses"]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{cfg.name} training: losses {losses}")
    check(float(np.mean(losses[-3:])) < losses[0],
          f"{cfg.name} training: the last three losses {losses[-3:]} do "
          f"not fall below the first {losses[0]}")
    wall = float(np.median(whole["step_s"][1:] or whole["step_s"]))
    return ({"steps": steps, "batch": batch, "seq_len": seq,
             "dtype": cfg.compute_dtype, "remat": cfg.remat,
             "opt": dataclasses.asdict(tcfg.opt),
             "model_flops_per_step": flops, "losses": losses,
             "median_wall_ms_after_first": wall * 1e3,
             "tok_per_s": batch * seq / wall,
             "model_flops_share_of_bf16_peak": flops / wall / BF16_FLOPS,
             "per_step": per_step, "launches": counts, "variants": variants,
             "peak_bytes": (max(r["max_memory_allocated"] for r in per_step)
                            if cuda else None)},
            whole)


def train_resume(cfg, device, steps: int, batch: int, seq: int, workdir,
                 save_at: int, whole: dict) -> dict:
    """The checkpoint check on the timed run's directory (its saves at
    ``save_at`` and at ``steps``): the last checkpoint restored and held
    to the state that ``fit`` returned (``whole``, taken by the call), bit
    for bit; that checkpoint removed, a fresh ``fit`` (new weights as the
    template) resumed from the directory to ``steps``, which must start at
    ``save_at``; its losses beside the uninterrupted run's."""
    import shutil

    import torch

    from repro_torch import tree
    from repro_torch.checkpoint import ckpt
    from repro_torch.train.loop import fit

    tcfg, fresh, fitc = _train_setup(cfg, device, steps, batch, seq)
    workdir = str(workdir)
    check(ckpt.latest_step(workdir) == steps,
          f"the timed run left no checkpoint at step {steps}")
    saved = (whole.pop("params"), whole.pop("opt_state"))
    uninterrupted = whole["losses"]
    t0 = time.perf_counter()
    restored, at = ckpt.restore(workdir, saved)
    walls = {"restore_s": time.perf_counter() - t0}
    same = [torch.equal(a, b) and a.dtype == b.dtype
            for a, b in zip(tree.leaves(restored), tree.leaves(saved))]
    check(at == steps and all(same),
          f"the step-{steps} checkpoint restores {sum(same)} of "
          f"{len(same)} leaves bit for bit")
    del saved, restored
    if device.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(f"{workdir}/step_{steps:08d}")
    check(ckpt.latest_step(workdir) == save_at,
          f"the timed run left no checkpoint at step {save_at}")
    t0 = time.perf_counter()
    resumed = fit(cfg, fresh(), fitc(steps, workdir, steps), tcfg)
    walls["resumed_fit_s"] = time.perf_counter() - t0
    walls["its_steps_s"] = sum(resumed["step_s"])
    shutil.rmtree(workdir)
    check(resumed["final_step"] == steps
          and len(resumed["losses"]) == steps - save_at,
          f"the resumed fit ran {len(resumed['losses'])} steps to "
          f"{resumed['final_step']}")
    return {"saved_at": save_at, "restored_at": steps,
            "leaves_restored_bitwise": len(same), "walls": walls,
            "resumed_losses": resumed["losses"],
            "uninterrupted_losses": uninterrupted[save_at:],
            "resumed_equal_bitwise":
                resumed["losses"] == uninterrupted[save_at:]}


def resume_check(cfg, device, steps: int, batch: int, seq: int, workdir,
                 save_at: int, layers: int = None) -> dict:
    """:func:`train_resume` on a copy of the config cut to its first
    ``layers`` layers (``TRAIN_RESUME_LAYERS``): a ``fit`` of its own
    from seed-0 weights, ``steps`` steps at the timed run's batch and
    sequence, saving every ``save_at`` steps; then the bitwise restore
    and the resumed ``fit``."""
    from repro_torch.train.loop import fit

    cut = cut_depth(cfg, layers or TRAIN_RESUME_LAYERS)
    tcfg, fresh, fitc = _train_setup(cut, device, steps, batch, seq)
    whole = fit(cut, fresh(), fitc(steps, workdir, save_at), tcfg)
    return {"layers": cut.n_layers,
            **train_resume(cut, device, steps, batch, seq, workdir,
                           save_at, whole)}


def phase_train(name: str, cfg, device, workdir, gate=TRAIN_GATE,
                timed=TRAIN_TIMED, save_at: int = TRAIN_SAVE_AT
                ) -> tuple[dict, dict]:
    """The training path at full width: :func:`train_gate`, the timed run
    (:func:`train_timed`, its one checkpoint at the end) at full depth,
    its last state's step under the profiler
    (:func:`phase_profile_train`), then the checkpoint check on a copy
    cut in depth (:func:`resume_check`).  On
    the card every flash call of a step is the kernel's: L forwards and L
    remat recomputes (the config's ``remat``), ``mma`` in bf16, ``tf32x3``
    in the float32 gate.  Returns the phase record and the profile's."""
    import torch

    from pathlib import Path as _Path

    walls = {}
    t0 = time.perf_counter()
    gate_rec = train_gate(cfg, device, *gate)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    walls["gate_s"] = time.perf_counter() - t0
    workdir = _Path(workdir)
    t0 = time.perf_counter()
    timed_rec, whole = train_timed(cfg, device, *timed,
                                   workdir=workdir / "run", save_at=timed[0])
    walls["timed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = phase_profile_train(cfg, whole, timed[1], timed[2], device)
    del whole
    shutil.rmtree(workdir / "run", ignore_errors=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    walls["profile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timed_rec["checkpoint"] = resume_check(
        cfg, device, *timed, workdir=workdir / "resume", save_at=save_at)
    walls["resume_s"] = time.perf_counter() - t0
    L, per = cfg.n_layers, (2 if cfg.remat else 1)
    expected = {"gate": per * gate[0], "per_step": per * L,
                "timed": per * L * timed[0]}
    if device.type == "cuda":
        check(gate_rec["variants"]["flash_attention"]
              == {"mma": 0, "split": 0, "tf32x3": expected["gate"]},
              f"{cfg.name} train gate's flash variants were "
              f"{gate_rec['variants']['flash_attention']}, expected "
              f"{expected['gate']} tf32x3")
        bad = [r["flash_launches"] for r in timed_rec["per_step"]
               if r["flash_launches"] != expected["per_step"]]
        check(not bad, f"{cfg.name} training launched flash {bad} times in "
                       f"a step, expected {expected['per_step']}")
        check(timed_rec["variants"]["flash_attention"]
              == {"mma": expected["timed"], "split": 0, "tf32x3": 0},
              f"{cfg.name} training's flash variants were "
              f"{timed_rec['variants']['flash_attention']}")
    return ({"phase": name, "arch": cfg.name, "layers": L,
             "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
             "head_dim": cfg.hd, "vocab": cfg.vocab, "gate": gate_rec,
             "timed": timed_rec, "flash_launches_expected": expected,
             "peaks": beside_pure_step(name, {
                 "timed": (L, timed_rec["peak_bytes"])}),
             "walls": walls}, prof)


def phase_profile_train(cfg, state: dict, batch: int, seq: int, device,
                        top: int = 12) -> dict:
    """One warm train step (bf16, the timed run's state) under
    ``torch.profiler``: device busy and idle share, the top kernels, the
    share of the device time in the flash kernel's forwards and in the
    attention backward's recompute (``FlashAttentionFnBackward``); then
    one eager AdamW update alone, in place as ``fit``'s step runs it,
    its kernels and device time.  The steps donate, as ``fit``'s do:
    ``state`` is updated in place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree
    from repro_torch.data.pipeline import batch_for_step, to_device
    from repro_torch.train import optimizer
    from repro_torch.train import step as tstep

    tcfg = tstep.TrainConfig(opt=optimizer.OptConfig(
        decay_steps=TRAIN_TIMED[0], **TRAIN_OPT))
    train_step, _ = tstep.make_train_step(cfg, tcfg, donate=True)
    data = to_device(batch_for_step(cfg, seq, batch, TRAIN_TIMED[0]), device)
    params, opt_state = state["params"], state["opt_state"]

    def one_step():
        out = train_step(params, opt_state, data)
        float(out[2]["loss"])  # waits for the device
        _sync(device)

    one_step()  # warm
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one_step()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    flash_fwd = sum(e.self_device_time_total for e in dev
                    if "flash" in e.key) / 1e3
    # the autograd node itself (the engine's evaluate_function event
    # around it would count its kernels twice)
    bwd = [e for e in events if e.device_type == DeviceType.CPU
           and e.key == "FlashAttentionFnBackward"]
    recompute = sum(e.device_time_total for e in bwd) / 1e3
    by_name = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in dev), key=lambda r: -r[1])
    grads = tree.map(lambda p: p.detach().clone(), params)  # stand-ins

    def update():
        optimizer.adamw_update(tcfg.opt, grads, opt_state, params,
                               in_place=True)
        _sync(device)

    update()
    opt_rec = profile_summary(update, device, top=5)
    return {"phase": "profile_train", "arch": cfg.name, "batch": batch,
            "seq_len": seq, "dtype": cfg.compute_dtype,
            "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "device_kernel_launches": sum(e.count for e in dev),
            "flash_forward_device_ms": flash_fwd,
            "flash_forward_share": flash_fwd / busy if busy else None,
            "attention_backward_recompute_device_ms": recompute,
            "attention_backward_recompute_calls": sum(e.count for e in bwd),
            "attention_backward_recompute_share":
                recompute / busy if busy else None,
            "device_ms_by_name": [{"name": k[:80], "ms": ms, "count": c}
                                  for k, ms, c in by_name[:top]],
            "optimizer": {"leaves": len(tree.leaves(params)),
                          "wall_ms": opt_rec["wall_ms"],
                          "device_busy_ms": opt_rec["device_busy_ms"],
                          "kernels": opt_rec["device_kernel_launches"],
                          "top": opt_rec["device_ms_by_name"]}}


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# training of the MoE, vlm, encdec, ssm and hybrid families
# ---------------------------------------------------------------------------

#: each family's training phase: (phase, the gates' (layers, batch,
#: seq), the bf16 run's (layers, steps, batch, seq)); a vlm sequence is
#: the config's 576 patches and then these tokens, an encdec one these
#: tokens over its 1,500 frames.  deepseek-moe-16b's run keeps its dense
#: layer and 3 MoE layers, which fit the card in float32 since the step
#: donates its train state (the old and new AdamW states side by side did
#: not fit at that depth)
FAMILY_TRAIN = {
    "deepseek-moe-16b": ("train_deepseek", (2, 2, 256), (4, 3, 2, 1024)),
    "llava-next-34b": ("train_llava", (1, 1, 512), (2, 3, 2, 1024)),
    "whisper-small": ("train_whisper", (2, 2, 128), (12, 3, 8, 128)),
    "mamba2-2.7b": ("train_mamba2", (2, 1, 128), (2, 3, 2, 256)),
    "hymba-1.5b": ("train_hymba", (2, 1, 128), (2, 3, 2, 256)),
}
#: a plain-route family's bf16 losses against its float32 ones, relative:
#: the bf16 tolerance of the reference's own kernel tests
PLAIN_BF16_TOL = 2e-2


#: each training run's peak device memory (``max_memory_allocated``) with
#: the train step that built a new train state beside the old one, before
#: it donated: ``{phase: {run: (decoder layers, bytes)}}``, read by
#: ``chip_smoke.py`` itself on an NVIDIA H100 80GB HBM3 at 700 W (the
#: mesh phase's on a ``(1, 1)`` mesh, rank 0; deepseek-moe-16b's at its
#: dense layer and 2 MoE layers, since 3 did not fit)
PURE_STEP_PEAKS = {
    "train_deepseek": {"bf16": (3, 52180161536),
                       "plain_bf16": (3, 52180163072),
                       "float32": (3, 55945148928), "fp8": (3, 52180161536)},
    "train_llava": {"bf16": (2, 60622805504), "plain_bf16": (2, 60622543360),
                    "float32": (2, 70272002560)},
    "train_whisper": {"bf16": (12, 7443549696), "plain_bf16": (12, 6888955392),
                      "float32": (12, 8041114624)},
    "train_mamba2": {"bf16": (2, 7318109696), "float32": (2, 7798617088)},
    "train_hymba": {"bf16": (2, 4225125888), "float32": (2, 4710035456)},
    "train_tinyllama": {"timed": (22, 34590948352)},
    "mesh_train": {"mesh": (22, 36789906432), "unsharded": (22, 34589809664)}}


def beside_pure_step(phase: str, peaks: dict) -> dict:
    """Each run's peak (``{run: (layers, bytes)}``; bytes None off the
    card) beside the same run's with the non-donating step
    (``PURE_STEP_PEAKS``), and their ratio where the depths agree."""
    out = {}
    for run, (layers, got) in peaks.items():
        was_layers, was = PURE_STEP_PEAKS.get(phase, {}).get(
            run, (None, None))
        out[run] = {"layers": layers, "peak_bytes": got,
                    "pure_step_layers": was_layers,
                    "pure_step_peak_bytes": was,
                    "share_of_pure_step": (
                        got / was if got and was and layers == was_layers
                        else None)}
    return out


def _median_ms(walls) -> float:
    return float(np.median(walls[1:] or walls)) * 1e3


def family_timed(cfg, device, steps: int, batch: int, seq: int, workdir,
                 arch: str | None = None, smoke: bool = False,
                 **train_kw) -> dict:
    """``steps`` bf16 train steps at the config's own types from seed-0
    weights, on the route the train launcher picks (``launch.train``'s
    ``PLAIN_PATH_FAMILIES`` on the plain route, the rest on the kernel
    route): through the launcher itself when ``arch`` is given (its group
    of one and ``(1, 1)`` mesh, ``fit`` and its checkpoint under
    ``workdir``), through ``fit`` on the plain route, else step by step
    through ``train.step`` (what ``fit`` runs, without the checkpoint it
    writes at the end: 20-odd GB of AdamW state at these MoE and vlm
    depths).  ``train_kw``: more ``TrainConfig`` fields.  Then the same
    steps on the plain route in bf16 (for a kernel-route run) and in
    float32, on the same weights.

    Every loss must be finite and within ``PLAIN_BF16_TOL`` of the
    float32 run's, relative.  A kernel-route family is also held at every
    step of the plain bf16 run, at the weights and batch that step's loss
    was taken at: the kernel route's loss there (``at_plain_weights``)
    within ``max(TRAIN_TOL, NOISE_MARGIN x d'_s)`` of the plain route's,
    d'_s the plain route's distance there from the same loss in float32.
    The two runs' losses step by step are reported against that rule
    (``share_of_noise_bound``), not held to it: after the first AdamW
    step, which moves each weight by about the learning rate times its
    gradient's sign, the two bf16 runs stand at different weights.  Peak
    memory and the median step wall after the first of each run; the
    first run's launches, variants and flash calls per step."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    from repro_torch.train import step as tstep
    from repro_torch.train.loop import fit

    kernel = cfg.family not in train_launch.PLAIN_PATH_FAMILIES
    tcfg, fresh, fitc = _train_setup(cfg, device, steps, batch, seq,
                                     **train_kw)
    cumulative, per_step = [], []
    _reset_peak(device)
    ops.reset_launch_counts()
    if arch is not None:
        via = "launch.train"
        res = train_launch.main(
            ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
             "--seq-len", str(seq), "--ckpt-dir", str(workdir),
             "--device", str(device)] + (["--smoke"] if smoke else []))
        losses, walls = res["losses"], res["step_s"]
        del res
    elif not kernel:
        via = "fit"
        res = fit(cfg, fresh(), fitc(steps, workdir, steps), tcfg,
                  hooks=[lambda s, m: cumulative.append(
                      ops.launch_counts()["flash_attention"])],
                  use_kernel=False)
        losses, walls = res["losses"], res["step_s"]
        del res
        per_step = [b - a for a, b in zip([0] + cumulative, cumulative)]
    else:
        via = "train.step"
        losses, walls = _unsharded_steps(cfg, tcfg, fresh(), device, steps,
                                         batch, seq, flash_calls=per_step)
    shutil.rmtree(workdir, ignore_errors=True)
    counts, variants = ops.launch_counts(), _variants()
    heads, peak = ops.flash_head_counts(), _peak(device)
    _reset_peak(device)
    plain = plain_walls = plain_peak = None
    same = {"kernel_bf16": [], "float32": []}
    if kernel:
        kernel_loss = tstep.make_loss_fn(cfg, tcfg, True)
        loss32 = tstep.make_loss_fn(as_float32(cfg), tcfg, False)

        def at_plain_weights(params, data):
            with torch.no_grad():
                same["kernel_bf16"].append(
                    float(kernel_loss(params, data)[1][0]))
                same["float32"].append(float(loss32(
                    cast_params(params, torch.float32), data)[1][0]))

        plain, plain_walls = _unsharded_steps(cfg, tcfg, fresh(), device,
                                              steps, batch, seq, False,
                                              probe=at_plain_weights)
        plain_peak = _peak(device)
        _reset_peak(device)
    losses32, walls32 = _unsharded_steps(
        as_float32(cfg), tcfg, cast_params(fresh(), torch.float32), device,
        steps, batch, seq, False)
    peak32 = _peak(device)
    _reset_peak(device)
    rec = {"steps": steps, "batch": batch, "seq_len": seq,
           "layers": cfg.n_layers, "dtype": cfg.compute_dtype,
           "remat": cfg.remat, "route": "kernel" if kernel else "plain",
           "via": via, **train_kw, "losses": losses,
           "float32_losses": losses32}
    rel32 = [abs(a - b) / abs(b) for a, b in zip(losses, losses32)]
    ok = len(losses) == steps and all(math.isfinite(x) for x in losses) \
        and all(r <= PLAIN_BF16_TOL for r in rel32)
    rec.update(rel_vs_float32=rel32, tol=PLAIN_BF16_TOL)
    if kernel:
        noise = [abs(a - b) / abs(b) for a, b in zip(plain, losses32)]
        bound = [max(TRAIN_TOL, NOISE_MARGIN * d) for d in noise]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
        d_same = [abs(a - b) / abs(b) for a, b in zip(plain,
                                                       same["float32"])]
        at = {**same, "rel_kernel_vs_plain_bf16": [
                  abs(a - b) / abs(b)
                  for a, b in zip(same["kernel_bf16"], plain)],
              "plain_bf16_vs_float32": d_same,
              "tol": [max(TRAIN_TOL, NOISE_MARGIN * d) for d in d_same]}
        at["over"] = [s_ for s_, (e, t) in enumerate(zip(
            at["rel_kernel_vs_plain_bf16"], at["tol"])) if e > t]
        ok = ok and len(at["tol"]) == steps and not at["over"]
        rec.update(plain_bf16_losses=plain, plain_bf16_vs_float32=noise,
                   rel_vs_plain_bf16=rel, at_plain_weights=at,
                   share_of_noise_bound=[r / b for r, b in zip(rel, bound)])
    at = rec.get("at_plain_weights", {})
    check(ok, f"{cfg.name} bf16 training ({rec['route']} route): losses "
              f"{losses}, float32 {losses32}, relative {rel32} (tol "
              f"{PLAIN_BF16_TOL}); the kernel route at the plain run's "
              f"weights {at.get('rel_kernel_vs_plain_bf16')} of the plain "
              f"route's loss (tol {at.get('tol')}, over at steps "
              f"{at.get('over')})")
    rec.update(
        step_ms=[w * 1e3 for w in walls],
        median_step_ms_after_first=_median_ms(walls),
        plain_bf16_median_step_ms_after_first=(
            _median_ms(plain_walls) if kernel else None),
        float32_median_step_ms_after_first=_median_ms(walls32),
        peak_bytes=peak, plain_bf16_peak_bytes=plain_peak,
        float32_peak_bytes=peak32, launches=counts, variants=variants,
        flash_heads=heads, flash_launches_per_step=per_step or None)
    return rec


def train_attention_timing(B: int, Hq: int, Hkv: int, S: int, D: int,
                           causal: bool, device, seed: int = 2) -> dict:
    """One flash call of a bf16 training step, the queries over keys of
    their own length (``[B, Hq, S, D]`` over ``Hkv`` kv heads): the
    kernel forward, held within ``FLASH_TOL`` of the plain version, and
    the recomputing backward that ``FlashAttentionFn.backward`` runs, in
    ms (CUDA events) and device ms (the profiler; None where its
    sessions record no device work), beside their bounds and SDPA's
    forward and forward + backward on the same inputs (``enable_gqa`` for
    grouped heads).  Off the card only the parity."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    q, k, v, g = train_shape_inputs(device, (B, Hq, Hkv, S, S, D), seed)
    kw = dict(causal=causal, window=HUGE_WINDOW if causal else None,
              softcap=None)
    with torch.no_grad():
        ok, err = _within(ops.flash_attention(q, k, v, **kw),
                          ref.flash_attention_ref(q, k, v, **kw),
                          FLASH_TOL["bfloat16"], FLASH_TOL["bfloat16"])
    check(ok, f"flash at the training shape {[B, Hq, S, D]} over {Hkv} kv "
              f"heads (causal {causal}) differs from the plain version "
              f"({err})")
    rec = {"q": [B, Hq, S, D], "kv": [B, Hkv, S, D], "causal": causal,
           "dtype": "bfloat16", "max_abs_err": err,
           **flash_bound_ms(B, Hq, Hkv, S, S, D, 2, causal, kw["window"]),
           "backward_bound": flash_backward_bound_ms(B, Hq, Hkv, S, S, D, 2,
                                                     causal)}
    if device.type != "cuda":
        return rec
    qd, kd, vd = [t.detach().requires_grad_() for t in (q, k, v)]
    gqa = {"enable_gqa": True} if Hq != Hkv else {}

    def kernel_fwd():
        with torch.no_grad():
            return ops.flash_attention(q, k, v, **kw)

    def recompute_bwd():
        with torch.enable_grad():
            out = ref.flash_attention_ref(qd, kd, vd, **kw)
            return torch.autograd.grad(out, (qd, kd, vd), g)

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  **gqa)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qd, kd, vd, is_causal=causal,
                                             **gqa)
        return torch.autograd.grad(out, (qd, kd, vd), g)

    for key, fn, kw_ in (("forward", kernel_fwd, {}),
                         ("recompute_backward", recompute_bwd, HEAVY_REPS),
                         ("library_forward", sdpa_fwd, {}),
                         ("library_forward_backward", sdpa_fwd_bwd,
                          HEAVY_REPS)):
        rec[f"{key}_ms"] = time_ms(fn, **kw_)
        rec[f"{key}_device_ms"], kernels = device_ms(
            fn, calls=2 if kw_ else 5, events_ms=rec[f"{key}_ms"])
    rec["library_kernels"] = sorted(k_["name"] for k_ in kernels)
    return rec


def phase_train_family(arch: str, device, gate: tuple, run: tuple,
                       workdir, smoke: bool = False) -> dict:
    """A family's training path at full width (``smoke``: the config's
    smoke width): its gates over the first ``gate[0]`` layers
    (:func:`train_gate` and :func:`train_gate_bf16` on a kernel-route
    family, :func:`host_gate` on ssm and hybrid), the bf16 run over the
    first ``run[0]`` layers
    (:func:`family_timed`; an encdec model's through the train launcher
    at full depth; a MoE model's also one step with
    ``fp8_expert_gather``), and the flash call at the run's attention
    shapes timed (:func:`train_attention_timing`).  On the card every
    flash call of a kernel-route step is the kernel's, ``mma`` in bf16
    and ``tf32x3`` in float32: two a layer with remat (the forward and
    the recompute), an encdec model's encoder layers included; a
    plain-route family launches no kernel."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import PLAIN_PATH_FAMILIES

    cfg = get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    kernel = cfg.family not in PLAIN_PATH_FAMILIES
    workdir = Path(workdir)
    walls = {}
    t0 = time.perf_counter()
    gate_rec = (train_gate if kernel else host_gate)(cfg, device, *gate)
    gate_bf16 = train_gate_bf16(cfg, device, *gate) if kernel else None
    walls["gate_s"] = time.perf_counter() - t0
    layers, steps, batch, seq = run
    rcfg = cut_depth(cfg, layers)
    launcher = cfg.family == "encdec"
    check(not launcher or rcfg.n_layers == cfg.n_layers,
          f"{cfg.name}: the launcher trains at full depth")
    t0 = time.perf_counter()
    timed = family_timed(rcfg, device, steps, batch, seq, workdir / "run",
                         arch=arch if launcher else None, smoke=smoke)
    walls["timed_s"] = time.perf_counter() - t0
    fp8 = None
    if cfg.is_moe:
        t0 = time.perf_counter()
        fp8 = family_timed(rcfg, device, 1, batch, seq, workdir / "fp8",
                           fp8_expert_gather=True)
        walls["fp8_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    attention = []
    if kernel:
        P = cfg.n_patches if cfg.family == "vlm" else 0
        shapes = [("decoder", cfg.n_heads, P + seq, True)]
        if launcher:
            shapes.append(("encoder", cfg.n_heads, cfg.encoder_seq, False))
        for where, H, S, causal in shapes:
            attention.append({"where": where, **train_attention_timing(
                batch, H, cfg.n_kv_heads, S, cfg.hd, causal, device)})
    walls["attention_s"] = time.perf_counter() - t0
    per = 2 if cfg.remat else 1

    def attn_layers(c) -> int:
        return c.n_layers + (c.n_encoder_layers if launcher else 0)

    expected = {"gate": per * attn_layers(cut_depth(cfg, gate[0])),
                "per_step": per * attn_layers(rcfg)} if kernel else {
        "gate": 0, "per_step": 0}
    if device.type == "cuda":
        none = {"mma": 0, "split": 0, "tf32x3": 0}
        check(gate_rec["variants"]["flash_attention"]
              == {**none, "tf32x3": expected["gate"]}
              and gate_rec["launches"]["ssd_scan"] == 0,
              f"{cfg.name} gate: flash variants "
              f"{gate_rec['variants']['flash_attention']}, "
              f"{gate_rec['launches']['ssd_scan']} ssd_scan launches; "
              f"expected {expected['gate']} tf32x3 and none")
        if gate_bf16 is not None:
            check(gate_bf16["variants"]["flash_attention"]
                  == {**none, "mma": expected["gate"]},
                  f"{cfg.name} bf16 gate: flash variants "
                  f"{gate_bf16['variants']['flash_attention']}, expected "
                  f"{expected['gate']} mma")
        for what, r in (("bf16 run", timed), ("fp8 step", fp8)):
            if r is None:
                continue
            n = r["steps"] * expected["per_step"]
            bad = [c for c in r["flash_launches_per_step"] or []
                   if c != expected["per_step"]]
            check(not bad and r["variants"]["flash_attention"]
                  == {**none, "mma": n} and r["launches"]["ssd_scan"] == 0,
                  f"{cfg.name} {what}: flash variants "
                  f"{r['variants']['flash_attention']} (per step "
                  f"{r['flash_launches_per_step']}), "
                  f"{r['launches']['ssd_scan']} ssd_scan launches; "
                  f"expected {expected['per_step']} mma a step and no "
                  f"ssd_scan")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    n = rcfg.n_layers
    return {"phase": FAMILY_TRAIN[arch][0], "arch": cfg.name,
            "family": cfg.family, "route": "kernel" if kernel else "plain",
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
            "vocab": cfg.vocab, "gate": gate_rec, "gate_bf16": gate_bf16,
            "timed": timed, "fp8_step": fp8, "attention": attention,
            "flash_launches_expected": expected,
            "peaks": beside_pure_step(FAMILY_TRAIN[arch][0], {
                "bf16": (n, timed["peak_bytes"]),
                "plain_bf16": (n, timed["plain_bf16_peak_bytes"]),
                "float32": (n, timed["float32_peak_bytes"]),
                **({"fp8": (n, fp8["peak_bytes"])} if fp8 else {})}),
            "walls": walls}


# ---------------------------------------------------------------------------
# MoE routing ties, chunked local attention, the pipeline, the dry run
# ---------------------------------------------------------------------------

#: rows of tied router logits (deepseek-moe-16b's E 64, K 6) beside rows
#: drawn from four levels, where ties fall everywhere
TOPK_RANDOM_ROWS = 60


def tied_router_rows(E: int) -> np.ndarray:
    """Router logits ``[R, E]`` (E >= 64) with ties: across the k-th
    place for k = 6 (four distinct leaders, then five equal values
    scattered over the indices), inside the k (three equal leaders),
    every expert equal, and ``TOPK_RANDOM_ROWS`` rows of values from four
    levels."""
    rng = np.random.default_rng(0)
    boundary = np.zeros(E, np.float32)
    boundary[[5, 17, 33, 2]] = [4.0, 3.5, 3.0, 2.5]
    boundary[[60, 3, 40, 10, 20]] = 2.0
    inside = np.zeros(E, np.float32)
    inside[[50, 7, 30]] = 3.0
    inside[[1, 9, 12]] = [2.0, 1.5, 1.0]
    levels = rng.integers(0, 4, (TOPK_RANDOM_ROWS, E)).astype(np.float32)
    return np.concatenate([boundary[None], inside[None],
                           np.zeros((1, E), np.float32), levels * 0.5])


def lowest_index_topk(probs: np.ndarray, K: int) -> np.ndarray:
    """The k largest per row, the lowest index first among equal values
    (``jax.lax.top_k``'s order), on the host."""
    return np.argsort(-probs, axis=-1, kind="stable")[..., :K]


def phase_moe_topk(cfg, device) -> dict:
    """``blocks._moe_route`` on tied rows on the device: one-hot hidden
    rows pick router rows whose logits tie (each logit is then one weight
    exactly), and the chosen experts must equal the lowest-index rule
    applied to the probabilities the router formed; ``torch.topk``'s own
    order on the same probabilities is read beside."""
    import torch

    from repro_torch.models import blocks

    E, K = cfg.n_experts, cfg.top_k
    logits = tied_router_rows(E)
    R = logits.shape[0]
    check(R <= cfg.d_model, "more tied rows than hidden dimensions")
    router = np.zeros((cfg.d_model, E), np.float32)
    router[:R] = logits
    ht = np.zeros((R, cfg.d_model), np.float32)
    ht[np.arange(R), np.arange(R)] = 1.0
    t0 = time.perf_counter()
    probs, gates, onehot = blocks._moe_route(
        cfg, {"router": torch.from_numpy(router).to(device)},
        torch.from_numpy(ht).to(device))
    got = onehot.argmax(-1).cpu().numpy()
    p = probs.cpu().numpy()
    want = lowest_index_topk(p, K)
    srt = -np.sort(-p, axis=-1)
    across = int((srt[:, K - 1] == srt[:, K]).sum())
    inside = int((srt[:, :K - 1] == srt[:, 1:K]).any(-1).sum())
    check(across > 0 and inside > 0,
          f"the tied rows lost their ties on the device ({across} across "
          f"the k-th place, {inside} inside the k)")
    bad = int((got != want).any(-1).sum())
    check(bad == 0, f"_moe_route broke ties otherwise than the lowest "
                    f"index in {bad} of {R} rows")
    gsum = gates.sum(-1).cpu().numpy()
    check(bool(np.all(np.abs(gsum - 1) < 1e-6)),
          "the tied rows' gates do not sum to 1")
    topk = torch.topk(probs, K, dim=-1).indices.cpu().numpy()
    return {"phase": "moe_topk", "arch": cfg.name, "experts": [E, K],
            "rows": R, "rows_tied_across_k": across,
            "rows_tied_inside_k": inside, "rows_differing": bad,
            "torch_topk_rows_differing": int(
                (np.sort(topk, -1) != np.sort(want, -1)).any(-1).sum()),
            "wall_s": time.perf_counter() - t0}


#: gemma2-2b's chunked forward: (batch, sequence); 8192 = two blocks of
#: its 4096 window, so its 13 local layers take the block-local path
CHUNKED_FORWARD = (1, 8192)


def sample_positions(S: int, window: int, n: int = 32) -> list:
    """Positions whose logits the chunked gate compares: the first ``n``
    (block 0, the first-block rule), ``n`` across the first block
    boundary, and the last ``n``."""
    at = list(range(min(n, S))) + list(range(max(0, window - n // 2),
                                             min(S, window + n // 2))) \
        + list(range(max(0, S - n), S))
    return sorted(set(at))


@contextlib.contextmanager
def call_recorder(module, name: str, what):
    """Inside the ``with``, every call of ``module.name`` appends
    ``what(*args, **kwargs)`` to the yielded list."""
    fn = getattr(module, name)
    seen = []

    def recorded(*args, **kwargs):
        seen.append(what(*args, **kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, recorded)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def chunked_gate(cfg32, params32, batch: int, seq_len: int,
                 device) -> dict:
    """Float32 teacher-forced forward with ``chunked_local_attn``: the
    kernel route (every attention through the flash kernel, the local
    layers with their window; the windows recorded per call) against the
    plain route (the local layers through ``local_chunked_attention``,
    the global ones the masked attention); the logits at
    :func:`sample_positions` within ``SERVE_TOL``, the hidden states
    beside."""
    from repro_torch.launch import serve
    from repro_torch.models import blocks, layers, lm

    toks = serve.make_inputs(cfg32, batch, seq_len, device, seed=3)[0]
    with call_recorder(blocks, "attention",
                       lambda *a, **k: k.get("window")) as windows:
        kern, counts = _counted(lambda: lm.forward(
            cfg32, params32, toks, return_hidden=True)[0])
    variants = _variants()
    with call_recorder(layers, "local_chunked_attention",
                       lambda *a, **k: a[3]) as chunked:
        plain = lm.forward(cfg32, params32, toks, return_hidden=True,
                           use_kernel=False)[0]
    n_local = sum(w == cfg32.local_window for _, _, ws in lm.stacks(cfg32)
                  for w in ws)
    check(chunked == [cfg32.local_window] * n_local,
          f"{cfg32.name}: {len(chunked)} block-local calls on the plain "
          f"route, expected {n_local}")
    check(windows.count(cfg32.local_window) == n_local,
          f"{cfg32.name}: the kernel route's attention windows were "
          f"{sorted(set(windows))}")
    pos = sample_positions(seq_len, cfg32.local_window)
    lk = lm.unembed(cfg32, params32, kern[:, pos]).float()
    lp = lm.unembed(cfg32, params32, plain[:, pos]).float()
    d = float((lk - lp).abs().max())
    check(d <= SERVE_TOL, f"{cfg32.name}: chunked kernel-route logits "
                          f"differ from the plain route by {d} "
                          f"(tol {SERVE_TOL})")
    check(_finite(kern) and _finite(lk), f"{cfg32.name}: non-finite output")
    hd = float((kern - plain).abs().max())
    return {"batch": batch, "seq_len": seq_len, "positions": len(pos),
            "max_abs_logit_diff_vs_plain": d, "tol": SERVE_TOL,
            "logit_scale": float(lp.abs().max()),
            "max_abs_hidden_diff": hd,
            "hidden_scale": float(plain.abs().max()),
            "block_local_calls_plain": len(chunked),
            "attention_windows_kernel": {str(w): windows.count(w)
                                     for w in sorted(set(windows),
                                                     key=str)},
            "launches": counts, "variants": variants}


def phase_serve_chunked(cfg, device, forward: tuple = CHUNKED_FORWARD,
                        seed: int = 0) -> dict:
    """gemma2-2b at full width with ``chunked_local_attn``: the float32
    gate (:func:`chunked_gate`), then a timed bfloat16 forward on the
    kernel route with its flash launches per variant."""
    import torch

    from repro_torch.launch import serve

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, chunked_local_attn=True)
    cfg32 = as_float32(cfg)
    params32 = serve.make_params(cfg32, device, seed=seed)
    gate = chunked_gate(cfg32, params32, *forward, device)
    params = cast_params(params32, getattr(torch, cfg.param_dtype))
    del params32
    if device.type == "cuda":
        torch.cuda.empty_cache()
    timed = forward_timed(cfg, params, *forward, device)
    del params
    L = cfg.n_layers
    if device.type == "cuda":
        check(gate["variants"]["flash_attention"]["tf32x3"] == L,
              f"the chunked float32 gate's flash variants were "
              f"{gate['variants']['flash_attention']}")
        check_timed_variants("chunked gemma2-2b", timed, {"mma": L})
    return {"phase": "serve_chunked", "arch": cfg.name, "layers": L,
            "window": cfg.local_window, "pattern": cfg.layer_pattern,
            "attn_softcap": cfg.attn_softcap, "gate": gate,
            "timed": timed, "wall_s": time.perf_counter() - t0}


#: tinyllama-1.1b's pipeline: (stages, microbatches, microbatch rows,
#: sequence)
PIPELINE = (2, 4, 2, 512)


def _stage_fn(cfg, per_stage: int, positions):
    """One pipeline stage: ``per_stage`` dense layers (attention through
    the flash kernel, then the FFN), on a stage's stacked weights."""
    from repro_torch.models import blocks

    def stage(p, h):
        for i in range(per_stage):
            pi = {k: v[i] for k, v in p.items()}
            a, _ = blocks.attn_block(cfg, pi, h, positions)
            h = h + a
            h = h + blocks.ffn_block(cfg, pi, h)
        return h

    return stage


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def pipeline_run(cfg, params, shape: tuple, device) -> dict:
    """The pipelined stack against the stages applied to each microbatch
    in turn (bit for bit) and against the batched sequential stack (its
    distance), with the walls of all three."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel import pipeline

    n_st, n_mb, mb, Sq = shape
    L = cfg.n_layers
    check(L % n_st == 0, f"{L} layers do not split into {n_st} stages")
    stacked = {k: v.reshape((n_st, L // n_st) + v.shape[1:])
               for k, v in params["blocks"].items()}
    toks = serve.make_inputs(cfg, n_mb * mb, Sq, device, seed=5)[0]
    with torch.no_grad():
        x = lm.embed_tokens(cfg, params, toks).reshape(
            n_mb, mb, Sq, cfg.d_model)
        pos = torch.arange(Sq, device=device)[None].expand(mb, Sq)
        stage = _stage_fn(cfg, L // n_st, pos)
        pipeline.pipeline_apply(stage, stacked, x, n_st)  # warm
        (y, ms), counts = _counted(lambda: _timed(
            lambda: pipeline.pipeline_apply(stage, stacked, x, n_st),
            device))
        variants = _variants()

        def per_microbatch():
            outs = []
            for xm in x:
                for s in range(n_st):
                    xm = stage(pipeline.stage_params(stacked, s), xm)
                outs.append(xm)
            return torch.stack(outs)

        want, seq_ms = _timed(per_microbatch, device)
        same = bool(torch.equal(y, want))
        check(same, f"{cfg.name}: the pipelined output differs from the "
                    "stages applied to each microbatch in turn (max abs "
                    f"{float((y.float() - want.float()).abs().max())})")
        pos2 = torch.arange(Sq, device=device)[None].expand(n_mb * mb, Sq)
        batched, batched_ms = _timed(lambda: _stage_fn(cfg, L, pos2)(
            params["blocks"], x.reshape(n_mb * mb, Sq, cfg.d_model)),
            device)
        batched = batched.reshape(y.shape)
    d = float((y.float() - batched.float()).abs().max())
    check(_finite(y), f"{cfg.name}: non-finite pipeline output")
    return {"dtype": cfg.compute_dtype, "ms": ms,
            "sequential_per_microbatch_ms": seq_ms,
            "sequential_batched_ms": batched_ms,
            "bitwise_equal_per_microbatch": same,
            "max_abs_diff_vs_batched": d,
            "scale": float(batched.float().abs().max()),
            "launches": counts, "variants": variants}


def phase_pipeline(cfg, device, shape: tuple = PIPELINE,
                   seed: int = 0) -> dict:
    """tinyllama-1.1b at full width through ``parallel.pipeline``:
    ``shape[0]`` stages of its layers, in bfloat16 (bit for bit against
    per-microbatch execution, timed against the sequential stack), then
    in float32, where the pipelined output must lie within ``SERVE_TOL``
    of the batched sequential stack, taken against the output's scale
    (the float32 rounding of a sum grows with its terms)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.parallel import pipeline

    t0 = time.perf_counter()
    params = serve.make_params(cfg, device, seed=seed)
    bf16 = pipeline_run(cfg, params, shape, device)
    del params
    cfg32 = as_float32(cfg)
    params32 = serve.make_params(cfg32, device, seed=seed)
    f32 = pipeline_run(cfg32, params32, shape, device)
    del params32
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tol = SERVE_TOL * max(1.0, f32["scale"])
    check(f32["max_abs_diff_vs_batched"] <= tol,
          f"{cfg.name}: the float32 pipeline differs from the batched "
          f"sequential stack by {f32['max_abs_diff_vs_batched']} "
          f"(tol {tol})")
    n_st, n_mb = shape[0], shape[1]
    want = n_mb * cfg.n_layers
    if device.type == "cuda":
        check_timed_variants("pipeline tinyllama-1.1b", bf16,
                             {"mma": want})
    return {"phase": "pipeline", "arch": cfg.name, "layers": cfg.n_layers,
            "stages": n_st, "microbatches": n_mb,
            "microbatch_rows": shape[2], "seq_len": shape[3],
            "bubble_fraction": pipeline.bubble_fraction(n_mb, n_st),
            "bf16": bf16, "float32": {**f32, "tol": tol},
            "flash_launches_expected": want,
            "wall_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# training across a device mesh
# ---------------------------------------------------------------------------

#: the mesh phase: its float32 gate (layers, batch, sequence) and its timed
#: bf16 run through ``launch.train`` (steps, batch, sequence), the
#: training phase's shape; at most this many cards
MESH_GATE = (4, 2, 512)
MESH_TIMED = (3, 4, 2048)
MESH_MAX_CARDS = 4
#: each spawned rank's time limit, seconds
MESH_RANK_TIMEOUT = 600


def mesh_shape(cards: int) -> tuple[int, int]:
    """The phase's ``(data, model)`` mesh on ``cards`` visible cards: up to
    ``MESH_MAX_CARDS``, rounded down to an even count, as ``(n // 2, 2)``;
    ``(1, 1)`` on one card."""
    n = min(cards, MESH_MAX_CARDS)
    if n < 2:
        return (1, 1)
    n -= n % 2
    return (n // 2, 2)


def _gathered(tree_):
    """A tree's DTensor leaves gathered whole on this rank."""
    from repro_torch import tree
    from repro_torch.parallel.api import plain

    return tree.map(plain, tree_)


def mesh_gate(cfg, mesh, device, layers: int, batch: int, seq: int,
              seed: int = 0) -> dict:
    """The float32 gate of the mesh step over the config's first
    ``layers`` layers (:func:`_gate_setup`): :func:`step_gate` with the
    mesh step (kernel route, parameters placed by ``param_specs``, the
    batch by ``batch_specs``, under the activation rules; gathered whole)
    as the subject, the unsharded kernel-route step as its baseline, and
    the plain path against float64 for the noise (:func:`train_gate`'s
    rule): the loss, every gradient and every parameter after one AdamW
    step.  Raises on a miss."""
    import torch

    from repro_torch.data.pipeline import to_device
    from repro_torch.parallel import sharding
    from repro_torch.parallel.api import sharding_rules

    cut, params, host, tcfg = _gate_setup(cfg, device, layers, batch, seq,
                                          seed)
    data = to_device(host, device)

    def on_mesh():
        dparams = sharding.distribute(
            params, sharding.param_specs(cut, mesh, params), mesh)
        with sharding_rules(sharding.activation_rules(cut, mesh)):
            return _gathered(gate_step(cut, tcfg, dparams,
                                       to_device(host, device, mesh), True))

    rec = step_gate(f"{cfg.name} mesh gate", [
        ("float64", lambda: gate_step(_float64(cut), tcfg, cast_params(
            params, torch.float64), data, False)),
        ("plain", lambda: gate_step(cut, tcfg, params, data, False)),
        ("unsharded", lambda: gate_step(cut, tcfg, params, data, True)),
        ("mesh", on_mesh)],
        "mesh", "unsharded", ("plain", "float64"))
    return {"layers": layers, "batch": batch, "seq_len": seq, **rec}


def _peak(device):
    import torch

    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def _requested(device, which: str = "current") -> int:
    """The bytes the program's tensors on the card hold (``current``) or
    held at most since the last reset (``peak``), as requested: without
    the allocator's rounding into blocks, which a trace does not model."""
    import torch

    return torch.cuda.memory_stats(device)[f"requested_bytes.all.{which}"]


def _reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _unsharded_steps(cfg, tcfg, params, device, steps: int, batch: int,
                     seq: int, use_kernel: bool = True,
                     flash_calls: list | None = None,
                     probe=None) -> tuple[list, list]:
    """``steps`` train steps of ``train.step`` as ``fit`` runs them
    (donating: ``params`` and the optimizer state are updated in place)
    on plain tensors from ``params`` on the route ``use_kernel`` picks,
    each timed as ``fit`` times a step (the batch's upload to the loss on
    the host), no checkpoint: ``(losses, walls in s)``.  ``flash_calls``
    gets each step's flash launches; ``probe(params, batch)`` is called
    before each step (outside its wall and its launches) with the
    weights and batch the step's loss is taken at."""
    from repro_torch.data.pipeline import batch_for_step, to_device
    from repro_torch.kernels import ops
    from repro_torch.train import step as tstep

    step_fn, opt_init = tstep.make_train_step(cfg, tcfg, use_kernel,
                                              donate=True)
    opt = opt_init(params)
    losses, walls = [], []
    for s in range(steps):
        if probe is not None:
            probe(params, to_device(batch_for_step(cfg, seq, batch, s),
                                    device))
        before = ops.launch_counts()["flash_attention"]
        t1 = time.perf_counter()
        data = to_device(batch_for_step(cfg, seq, batch, s), device)
        params, opt, m = step_fn(params, opt, data)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t1)
        if flash_calls is not None:
            flash_calls.append(ops.launch_counts()["flash_attention"]
                               - before)
    return losses, walls


def mesh_timed(arch: str, smoke: bool, mesh, device, steps: int,
               batch: int, seq: int, workdir) -> dict:
    """``steps`` bf16 steps through ``launch.train``'s mesh path (seed-0
    weights placed by ``param_specs``, AdamW at the launcher's defaults,
    its final checkpoint gathered and written by rank 0), then the same
    steps unsharded in bf16 and in float32 (:func:`_unsharded_steps`).
    Every mesh loss must be finite and, step by step, within
    ``max(TRAIN_TOL, NOISE_MARGIN x d'_s)`` of the unsharded bf16 run's,
    d'_s that run's distance from the float32 run at step s (the bf16
    noise, which the updates carry forward).  Per-rank peak memory and
    the median step wall after the first of each bf16 run."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch

    cfg = get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    mp = mesh.size(mesh.mesh_dim_names.index("model"))
    argv = ["--arch", arch, "--steps", str(steps), "--seq-len", str(seq),
            "--batch", str(batch), "--model-parallel", str(mp),
            "--ckpt-dir", str(workdir), "--device", str(device)]
    _reset_peak(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_launch.main(argv + (["--smoke"] if smoke else []))
    fit_s = time.perf_counter() - t0
    counts, variants = ops.launch_counts(), _variants()
    heads = ops.flash_head_counts()
    mesh_peak = _peak(device)
    mesh_losses, mesh_walls = res["losses"], res["step_s"]
    del res
    _reset_peak(device)
    tcfg, fresh, _ = _train_setup(cfg, device, steps, batch, seq)
    losses, walls = _unsharded_steps(cfg, tcfg, fresh(), device, steps,
                                     batch, seq)
    plain_peak = _peak(device)
    _reset_peak(device)
    t0 = time.perf_counter()
    losses32, _ = _unsharded_steps(as_float32(cfg), tcfg,
                                   cast_params(fresh(), torch.float32),
                                   device, steps, batch, seq)
    float32_s = time.perf_counter() - t0
    _reset_peak(device)
    noise = [abs(a - b) / abs(b) for a, b in zip(losses, losses32)]
    tol = [max(TRAIN_TOL, NOISE_MARGIN * d) for d in noise]
    rel = [abs(a - b) / abs(b) for a, b in zip(mesh_losses, losses)]
    check(len(mesh_losses) == steps
          and all(math.isfinite(x) for x in mesh_losses)
          and all(r <= t for r, t in zip(rel, tol)),
          f"{cfg.name} mesh training: losses {mesh_losses} against the "
          f"unsharded {losses} (relative {rel}, tol {tol})")

    def median_ms(ws):
        return float(np.median(ws[1:] or ws)) * 1e3

    return {"steps": steps, "batch": batch, "seq_len": seq,
            "dtype": cfg.compute_dtype, "remat": cfg.remat,
            "losses": mesh_losses, "unsharded_losses": losses,
            "float32_losses": losses32, "bf16_vs_float32": noise,
            "rel_vs_unsharded": rel, "tol": tol,
            "step_ms": [w * 1e3 for w in mesh_walls],
            "unsharded_step_ms": [w * 1e3 for w in walls],
            "median_step_ms_after_first": median_ms(mesh_walls),
            "unsharded_median_step_ms_after_first": median_ms(walls),
            "peak_bytes": mesh_peak, "unsharded_peak_bytes": plain_peak,
            "fit_with_checkpoint_s": fit_s, "float32_run_s": float32_s,
            "launches": counts, "variants": variants,
            "flash_heads": heads}


def mesh_train_rank(arch: str, device, mp: int, gate=MESH_GATE,
                    timed=MESH_TIMED, workdir=None, smoke: bool = False
                    ) -> dict:
    """One rank's part of the mesh phase, in a process group that is
    formed already: the ``("data", "model")`` mesh with ``mp`` on model,
    :func:`mesh_gate`, then :func:`mesh_timed`."""
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    mesh = make_host_mesh(mp, device)
    t0 = time.perf_counter()
    gate_rec = mesh_gate(cfg, mesh, device, *gate)
    gate_s = time.perf_counter() - t0
    own = workdir is None
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_")
                   if own else workdir)
    try:
        t0 = time.perf_counter()
        timed_rec = mesh_timed(arch, smoke, mesh, device, *timed,
                               workdir=workdir / "run")
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "gate": gate_rec, "timed": timed_rec,
            "walls": {"gate_s": gate_s,
                      "timed_s": time.perf_counter() - t0}}


def _mesh_rank_main(rank: int, world: int, init: str, workdir: str,
                    what: str = "train") -> int:
    """A spawned rank of a mesh phase (``--mesh-rank``; ``what``: the
    training phase, or ``serve``): its card, an NCCL group over ``init``,
    the checkpoint directory every rank shares, its record as the last
    output line."""
    import torch
    import torch.distributed as dist

    device = torch.device(f"cuda:{rank}")
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=init, rank=rank,
                            world_size=world, device_id=device)
    try:
        if what == "serve":
            rec = mesh_serve_rank(MESH_SERVE_ARCH, device,
                                  mesh_shape(world)[1])
        else:
            rec = mesh_train_rank("tinyllama-1.1b", device,
                                  mesh_shape(world)[1],
                                  workdir=Path(workdir))
    finally:
        dist.destroy_process_group()
    emit(rec)
    return 0


def _spawn_mesh_ranks(world: int, what: str = "train") -> list:
    """A mesh phase (``what``, as :func:`_mesh_rank_main` takes it) in
    ``world`` processes, one per card, joined by an NCCL group over a
    ``file://`` store; every rank's record.  Raises (after stopping every
    rank) if any fails or the time limit passes."""
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    init = f"file://{workdir / 'store'}"
    procs, outs = [], []
    try:
        for r in range(world):
            out = open(workdir / f"rank{r}.out", "w+")
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--mesh-rank", str(r), str(world), init,
                 str(workdir / "ckpt"), what],
                stdout=out, stderr=subprocess.STDOUT, cwd=str(ROOT)))
        deadline = time.monotonic() + MESH_RANK_TIMEOUT
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.5)
        recs = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.poll() is None:
                p.kill()
            p.wait()
            out.seek(0)
            text = out.read()
            check(p.returncode == 0,
                  f"mesh rank {r} of {world} exited {p.returncode}: "
                  f"{text[-3000:]}")
            recs.append(json.loads(text.strip().splitlines()[-1]))
        return recs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out in outs:
            out.close()
        shutil.rmtree(workdir, ignore_errors=True)


def phase_mesh_train(device, gate=MESH_GATE, timed=MESH_TIMED) -> dict:
    """tinyllama-1.1b at full width and depth through the mesh path on
    the visible cards (:func:`mesh_shape`): on one card a ``(1, 1)`` mesh
    over an NCCL group of one, in this process; on more, one spawned
    process per card.  A group that cannot form, or NCCL failing, raises:
    nothing falls back to gloo or the host.  Every flash call of the mesh
    runs must be the kernel's on each rank's local heads: 2 L a step
    (forward and remat recompute), ``mma`` in bf16, ``tf32x3`` in the
    float32 gate."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import close_group, init_group

    t0 = time.perf_counter()
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    shape = mesh_shape(cards)
    world = shape[0] * shape[1]
    if world == 1:
        init_group(device)
        try:
            recs = [mesh_train_rank("tinyllama-1.1b", device, 1, gate,
                                    timed)]
        finally:
            close_group()
    else:
        torch.cuda.empty_cache()
        recs = _spawn_mesh_ranks(world)
    cfg = get_config("tinyllama-1.1b")
    L, mp = cfg.n_layers, shape[1]
    heads = f"{cfg.n_heads // mp}/{cfg.n_kv_heads // mp}"
    want = {"gate": {"mma": 0, "split": 0, "tf32x3": 2 * gate[0]},
            "timed": {"mma": 2 * L * timed[0], "split": 0, "tf32x3": 0}}
    for r in recs:
        for what in ("gate", "timed"):
            check(r[what]["variants"]["flash_attention"] == want[what]
                  and r[what]["flash_heads"] == {
                      heads: want[what]["mma"] + want[what]["tf32x3"]},
                  f"mesh rank {r['rank']} {what}: flash variants "
                  f"{r[what]['variants']['flash_attention']} on heads "
                  f"{r[what]['flash_heads']}, expected {want[what]} on "
                  f"{heads}")
    lead = recs[0]
    return {"phase": "mesh_train", "arch": cfg.name, "layers": L,
            "cards": world, "mesh": list(shape),
            "local_heads": heads, "gate": lead["gate"],
            "timed": lead["timed"],
            "per_rank_peak_bytes": [r["timed"]["peak_bytes"] for r in recs],
            "peaks": beside_pure_step("mesh_train", {
                "mesh": (L, lead["timed"]["peak_bytes"]),
                "unsharded": (L, lead["timed"]["unsharded_peak_bytes"])}),
            "per_rank_launches": [r["timed"]["launches"]["flash_attention"]
                                  for r in recs],
            "flash_variants_expected": want,
            "wall_s": time.perf_counter() - t0}


#: the mesh serving phase's model: deepseek-moe-16b at full width, with
#: serve_moe's gate and timed sizes
MESH_SERVE_ARCH = "deepseek-moe-16b"


def _mesh_params(cfg, params, mesh, own: bool):
    """``params`` placed on ``mesh`` by ``param_specs``
    (``serve.place_params``: on a mesh of one the same storages, no copy);
    with ``own`` each rank's shards copied out, so that the whole
    tensors can be freed."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree
    from repro_torch.launch import serve

    placed = serve.place_params(cfg, params, mesh)
    if not own:
        return placed
    return tree.map(lambda t: DTensor.from_local(
        t.to_local().clone(), t.device_mesh, t.placements, run_check=False,
        shape=t.shape, stride=t.stride()), placed)


def _max_diff(a, b) -> float:
    return float((a - b).abs().max())


def _agreed_diff(tokens, logits, ref_tokens, ref_logits) -> tuple:
    """Two greedy runs' largest logit difference over the steps up to
    the first token that differs in any row (the steps whose inputs were
    the same on both runs), and that step (None where none differs)."""
    differ = (tokens != ref_tokens).any(dim=0).nonzero()
    first = int(differ[0]) if len(differ) else None
    agreed = slice(None) if first is None else slice(0, first + 1)
    return _max_diff(logits[:, agreed], ref_logits[:, agreed]), first


def mesh_serve_rank(arch: str, device, mp: int, gate=MOE_GATE,
                    timed=MOE_TIMED, gate_layers: int = MOE_GATE_LAYERS,
                    smoke: bool = False) -> dict:
    """One rank's part of the mesh serving phase, in a process group that
    is formed already: the ``("data", "model")`` mesh with ``mp`` on
    model; a float32 gate over the first ``gate_layers`` layers (the
    mesh's kernel route against its plain route and against the
    unsharded kernel route, ``serve_gate``'s tolerance, equal tokens);
    then at full depth in bf16 the timed unsharded run (on more than one
    rank also the unsharded plain route's, whose distance from it over
    the steps their tokens agree is the arithmetic's own noise d'; then
    the whole weights are freed), a plain-route prefill of ``timed``'s
    batch over a cache of its prompt length (the dry run's prefill cell;
    its peak above the phase's base and its temporaries are what the
    trace is held to), and the timed mesh run (``serve.generate(..., mesh=)``;
    a mesh of one serves from the same weights): on a mesh of one its
    tokens equal the unsharded run's and its logits lie within
    ``SERVE_TOL``; on more ranks, where bf16 partial sums meet in another
    order, its logits over the steps to the first differing token lie
    within ``max(SERVE_TOL, NOISE_MARGIN x d')``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding
    from repro_torch.parallel.api import sharding_rules
    from repro_torch.serve.decode import prefill
    from repro_torch.serve.kvcache import init_cache

    cfg = get_config(arch)
    cfg = cfg.smoke() if smoke else cfg
    mesh = make_host_mesh(mp, device)
    world = dist.get_world_size()
    own = world > 1
    cuda = device.type == "cuda"
    t0 = time.perf_counter()

    cut32 = as_float32(cut_depth(cfg, gate_layers))
    params32 = serve.make_params(cut32, device, seed=0)
    placed32 = _mesh_params(cut32, params32, mesh, own)
    B, S, new = gate
    prompts, extra = serve.make_inputs(cut32, B, S, device, seed=0)
    kern, counts = _counted(lambda: serve.generate(
        cut32, placed32, prompts, new, keep_logits=True, mesh=mesh,
        **extra))
    variants = _variants()
    plain_mesh = serve.generate(cut32, placed32, prompts, new,
                                use_kernel=False, keep_logits=True,
                                mesh=mesh, **extra)
    one = serve.generate(cut32, params32, prompts, new, keep_logits=True,
                         **extra)
    d_plain = _max_diff(kern["logits"], plain_mesh["logits"])
    d_one = _max_diff(kern["logits"], one["logits"])
    check(d_plain <= SERVE_TOL
          and torch.equal(kern["tokens"], plain_mesh["tokens"]),
          f"{cut32.name} mesh serving gate: the kernel route's logits "
          f"differ from the plain route's by {d_plain} (tol {SERVE_TOL}) "
          f"or its tokens do")
    check(d_one <= SERVE_TOL and torch.equal(kern["tokens"], one["tokens"]),
          f"{cut32.name} mesh serving gate: the mesh's logits differ from "
          f"the unsharded run's by {d_one} (tol {SERVE_TOL}) or its tokens "
          f"do")
    gate_rec = {"layers": cut32.n_layers, "batch": B, "prompt_len": S,
                "max_new": new, "max_abs_logit_diff_vs_plain": d_plain,
                "max_abs_logit_diff_vs_unsharded": d_one, "tol": SERVE_TOL,
                "tokens_identical": True, "launches": counts,
                "variants": variants}
    del params32, placed32, kern, plain_mesh, one
    gate_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    _reset_peak(device)
    base = torch.cuda.memory_allocated(device) if cuda else None
    base_req = _requested(device) if cuda else None
    params = serve.make_params(cfg, device, seed=0)
    setup_peak = _peak(device) - base if cuda else None
    placed = _mesh_params(cfg, params, mesh, own)
    B, S, new = timed
    prompts, extra = serve.make_inputs(cfg, B, S, device, seed=1)

    serve.generate(cfg, params, prompts, 2, **extra)   # warm
    _reset_peak(device)
    one, one_counts = _counted(lambda: serve.generate(
        cfg, params, prompts, new, keep_logits=True, **extra))
    one_peak = _peak(device)
    # kept on the host: the card then holds the steps' own bytes alone
    one_tokens, one_logits = one["tokens"].cpu(), one["logits"].cpu()
    unsharded = {k: one[k] for k in ("prefill_ms", "decode_ms_per_step",
                                     "tok_per_s", "decode_tok_per_s")}
    del one
    noise = None
    if own:
        # what two bf16 runs of the same function differ by on one card
        # when only the order of their arithmetic differs (the unsharded
        # plain route against the kernel route), routing flips included:
        # the mesh run is held to it; then the whole weights are freed
        plain_one = serve.generate(cfg, params, prompts, new,
                                   use_kernel=False, keep_logits=True,
                                   **extra)
        noise = _agreed_diff(plain_one["tokens"].cpu(),
                             plain_one["logits"].cpu(), one_tokens,
                             one_logits)
        del plain_one, params

    # the dry run's prefill cell on this mesh: the plain route over a
    # cache of S positions, the peak above the phase's base (on more than
    # one rank, with the rank's shards of the weights alone)
    _reset_peak(device)
    cache = init_cache(cfg, B, S, device=device, mesh=mesh)
    toks = sharding.distribute(
        {"t": prompts}, sharding.batch_specs(None, mesh, {"t": prompts}),
        mesh)["t"]
    held = _requested(device) - base_req if cuda else None
    g = min(cfg.moe_group_size, B * S)
    with sharding_rules(sharding.activation_rules(cfg, mesh,
                                                  n_moe_groups=B * S // g)):
        (logits, _), prefill_ms = _timed(lambda: prefill(
            cfg, placed, cache, toks, use_kernel=False), device)
    check(_finite(logits.full_tensor()),
          f"{cfg.name}: the mesh's plain-route prefill gave non-finite "
          f"logits")
    prefill_rec = {"batch": B, "prompt_len": S, "cache_len": S,
                   "route": "plain", "ms": prefill_ms,
                   "peak_bytes": _peak(device) - base if cuda else None,
                   "argument_bytes": held,
                   "temp_bytes": (_requested(device, "peak") - base_req
                                  - held if cuda else None),
                   "base_bytes": base,
                   "setup_peak_bytes": setup_peak}
    del cache, logits, toks

    serve.generate(cfg, placed, prompts, 2, mesh=mesh, **extra)   # warm
    _reset_peak(device)
    res, mcounts = _counted(lambda: serve.generate(
        cfg, placed, prompts, new, keep_logits=True, mesh=mesh, **extra))
    mvariants, heads = _variants(), ops.flash_head_counts()
    mesh_peak = _peak(device)
    tokens, logits = res["tokens"].cpu(), res["logits"].cpu()
    d = _max_diff(logits, one_logits)
    same = bool(torch.equal(tokens, one_tokens))
    d_agreed, first = _agreed_diff(tokens, logits, one_tokens, one_logits)
    check(_finite(logits), f"{cfg.name}: non-finite mesh logits")
    if world == 1:
        tol = SERVE_TOL
        check(d <= tol and same,
              f"{cfg.name} on a mesh of one: logits {d} from the unsharded "
              f"run's (tol {tol}), tokens equal: {same}")
    else:
        tol = max(SERVE_TOL, NOISE_MARGIN * noise[0])
        check(d_agreed <= tol,
              f"{cfg.name} on {tuple(mesh.shape)}: logits {d_agreed} from "
              f"the unsharded run's over the steps to the first differing "
              f"token ({first}), tol {tol} from the unsharded routes' "
              f"{noise[0]} (to their step {noise[1]})")
    timed_rec = {"batch": B, "prompt_len": S, "max_new": new,
                 "dtype": cfg.compute_dtype,
                 **{k: res[k] for k in ("prefill_ms", "decode_ms_per_step",
                                        "tok_per_s", "decode_tok_per_s")},
                 "peak_bytes": mesh_peak, "unsharded": {
                     **unsharded, "peak_bytes": one_peak,
                     "launches": one_counts},
                 "max_abs_logit_diff_vs_unsharded": d,
                 "tokens_identical": same, "first_differing_step": first,
                 "max_abs_logit_diff_while_tokens_agree": d_agreed,
                 "unsharded_plain_vs_kernel_while_tokens_agree": (
                     None if noise is None else noise[0]),
                 "unsharded_routes_first_differing_step": (
                     None if noise is None else noise[1]),
                 "tol": tol,
                 "launches": mcounts, "variants": mvariants,
                 "flash_heads": heads}
    return {"rank": dist.get_rank(), "world": world,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "gate": gate_rec, "prefill_plain": prefill_rec,
            "timed": timed_rec,
            "walls": {"gate_s": gate_s,
                      "timed_s": time.perf_counter() - t1}}


def phase_mesh_serve(device, gate=MOE_GATE, timed=MOE_TIMED,
                     gate_layers: int = MOE_GATE_LAYERS) -> dict:
    """deepseek-moe-16b at full width (28 layers, 64 experts) served
    through the mesh path on the visible cards (:func:`mesh_shape`): on
    one card a ``(1, 1)`` mesh over an NCCL group of one, in this process
    (the gate, and the mesh's tokens equal to the unsharded run's with
    the logits within the gate); on more, one spawned process per card
    (each rank's logits held to its unsharded run's over the steps to
    the first differing token: :func:`mesh_serve_rank`).  Every
    flash call is the kernel's on the rank's local heads: ``tf32x3`` in
    the float32 gate, one ``mma`` per layer at the prefill and one
    ``split`` per layer and decode step."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import close_group, init_group

    t0 = time.perf_counter()
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    shape = mesh_shape(cards)
    world = shape[0] * shape[1]
    if world == 1:
        init_group(device)
        try:
            recs = [mesh_serve_rank(MESH_SERVE_ARCH, device, 1, gate, timed,
                                    gate_layers)]
        finally:
            close_group()
    else:
        torch.cuda.empty_cache()
        recs = _spawn_mesh_ranks(world, "serve")
    cfg = get_config(MESH_SERVE_ARCH)
    L, mp = cfg.n_layers, shape[1]
    want = {"gate": {"mma": 0, "split": 0, "tf32x3": gate_layers * gate[2]},
            "timed": {"mma": L, "split": L * (timed[2] - 1), "tf32x3": 0}}
    heads = f"{cfg.n_heads // mp}/{cfg.n_kv_heads // mp}"
    if device.type == "cuda":
        for r in recs:
            for what in ("gate", "timed"):
                check(r[what]["variants"]["flash_attention"] == want[what],
                      f"mesh serving rank {r['rank']} {what}: flash "
                      f"variants {r[what]['variants']['flash_attention']}, "
                      f"expected {want[what]}")
            check(r["timed"]["flash_heads"] == {
                heads: sum(want["timed"].values())},
                  f"mesh serving rank {r['rank']}: flash heads "
                  f"{r['timed']['flash_heads']}, expected {heads}")
    lead = recs[0]
    return {"phase": "mesh_serve", "arch": cfg.name, "layers": L,
            "experts": [cfg.n_experts, cfg.top_k], "cards": world,
            "mesh": list(shape), "local_heads": heads, "gate": lead["gate"],
            "prefill_plain": lead["prefill_plain"], "timed": lead["timed"],
            "per_rank_peak_bytes": [r["timed"]["peak_bytes"] for r in recs],
            "per_rank_unsharded_peak_bytes": [
                r["timed"]["unsharded"]["peak_bytes"] for r in recs],
            "per_rank_tokens_identical": [r["timed"]["tokens_identical"]
                                          for r in recs],
            "per_rank_diff_while_tokens_agree": [
                r["timed"]["max_abs_logit_diff_while_tokens_agree"]
                for r in recs],
            "per_rank_launches": [r["timed"]["launches"]["flash_attention"]
                                  for r in recs],
            "flash_variants_expected": want,
            "wall_s": time.perf_counter() - t0}


#: the dry-run cell run on the card: one decode step of mamba2-2.7b at
#: long_500k from a zeroed cache
DRYRUN_CELL = ("mamba2-2.7b", "long_500k")


#: the SSM prefill the dry-run phase runs on the card after that decode
#: step, on the same weights from an empty cache: (batch, prompt).  Its
#: plain route runs the recurrence a step per token and layer (~5
#: launches each, 65,536 steps at full depth), its trace in closed form
DRYRUN_PREFILL = (8, 1024)


#: the cells the dry-run phase traces (``launch.trace``: the real step on
#: ``meta`` tensors over a fake group of the mesh's size, plain route) on
#: both production meshes; whisper-small's train step, whose model axis
#: does not divide its 12 heads, is one torch 2.11 refused on ``(16, 16)``
#: before the port placed its gradients itself (``parallel.api``)
TRACE_CELLS = (("deepseek-moe-16b", "train_4k"), DRYRUN_CELL,
               ("whisper-small", "train_4k"))
#: each trace process's time limit, seconds
TRACE_TIMEOUT = 900
#: the traced peak (arguments + the step's) of a step the card also runs,
#: and its traced temporaries (the step's own bytes), each as a share of
#: the measured one
TRACE_PEAK_TOL = 0.10


def mesh_tag(shape) -> str:
    """A trace's name for a mesh of ``shape``: ``"2x2"``."""
    return "x".join(str(n) for n in shape)


def serve_prefill_key(shape) -> tuple:
    """The trace key (:func:`collect_traces`) of mesh_serve's plain-route
    prefill (``MOE_TIMED``'s batch over a cache of its prompt length) on
    a ``(data, model)`` mesh of ``shape``, the one it ran on."""
    B, S, _ = MOE_TIMED
    return (mesh_tag(shape), MESH_SERVE_ARCH, json.dumps(["prefill", B, S]))


def dryrun_prefill_key(prefill=DRYRUN_PREFILL) -> tuple:
    """The trace key (:func:`collect_traces`) of the dry-run phase's SSM
    prefill on a mesh of one."""
    return ("1x1", DRYRUN_CELL[0], json.dumps(["prefill", *prefill]))


def start_traces(serve_mesh=(1, 1)) -> dict:
    """Start the dry-run phase's traces, one process per mesh: the
    ``TRACE_CELLS`` on the ``single`` and ``multi`` production meshes;
    the steps the card runs on the meshes it runs them on:
    ``DRYRUN_CELL``'s decode and its model's ``DRYRUN_PREFILL`` on a mesh
    of one, mesh_serve's plain-route
    prefill on ``serve_mesh`` (:func:`mesh_shape` of the visible cards),
    and mesh_train's step (``MESH_TIMED``'s batch and sequence) on
    ``(2, 2)``, whose collectives the four-card run sends.  They run at
    the host's lowest priority while the card works through the phases
    (the 512-rank mesh's train step takes minutes: DTensor plans its
    redistributions over three mesh dimensions); :func:`collect_traces`
    reads them.  ``{tag: (process, cells)}``."""
    from repro_torch.launch import trace

    cells = {"single": [list(c) for c in TRACE_CELLS],
             "multi": [list(c) for c in TRACE_CELLS],
             "1x1": [list(DRYRUN_CELL),
                     [DRYRUN_CELL[0], ["prefill", *DRYRUN_PREFILL]]],
             "2x2": [["tinyllama-1.1b", ["train", MESH_TIMED[1],
                                         MESH_TIMED[2]]]]}
    tag, arch, shape = serve_prefill_key(serve_mesh)
    cells.setdefault(tag, []).append([arch, json.loads(shape)])
    names = ["data", "model"]
    procs = {tag: (trace.start(
        c, **({"mesh": tag} if tag in ("single", "multi") else {
            "sizes": [int(n) for n in tag.split("x")], "names": names}),
        nice=19), c) for tag, c in cells.items()}
    atexit.register(_stop, procs)   # a phase that fails leaves none behind
    return procs


def _stop(procs: dict) -> None:
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def collect_traces(procs: dict, timeout: float = TRACE_TIMEOUT) -> dict:
    """Every trace record of :func:`start_traces`' processes, ``{(mesh
    tag, arch, shape as JSON): record}``; a process that failed or passed
    its time limit (and was stopped) leaves its cells ``status:
    "error"``."""
    from repro_torch.launch import trace

    out = {}
    try:
        for tag, (p, cells) in procs.items():
            for (arch, shape), r in zip(cells,
                                        trace.collect(p, cells, timeout)):
                out[(tag, arch, json.dumps(shape))] = r
    finally:
        _stop(procs)
    return out


def traced_peak(rec: dict) -> int:
    """A traced step's peak: its arguments and its own live bytes."""
    mem = rec["memory"]
    return mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]


def trace_reading(traces: dict, measured: dict) -> dict:
    """The traces in a record: each one's peak, FLOPs, collective bytes
    by kind and time; every trace must have run.  Each step the card ran
    (``measured``: ``{name: (trace key, measured peak, measured
    temporaries)}``: the peak ``max_memory_allocated`` above the phase's
    base, the temporaries the peak of the requested bytes less the
    step's arguments, :func:`_requested`) with its traced peak and its
    traced temporaries each within ``TRACE_PEAK_TOL`` of the card's (no
    card: not held)."""
    bad = {f"{tag} {arch} {shape}": r.get("error")
           for (tag, arch, shape), r in traces.items()
           if r.get("status") != "ok"}
    check(not bad, f"a trace failed: {bad}")
    cells = {f"{tag} {arch} {shape}": {
        "peak_bytes": traced_peak(r), "memory": r["memory"],
        "flops": r["cost"]["flops"], "collectives": r["collectives"],
        "trace_s": r["trace_s"]}
        for (tag, arch, shape), r in traces.items()}
    held = {}
    for name, (key, peak, got_temp) in measured.items():
        check(key in traces, f"{name}: no trace {key}")
        want = traced_peak(traces[key])
        temp = traces[key]["memory"]["temp_size_in_bytes"]
        held[name] = {
            "trace": list(key), "traced_peak_bytes": want,
            "measured_peak_bytes": peak,
            "traced_over_measured": want / peak if peak else None,
            "traced_temp_bytes": temp, "measured_temp_bytes": got_temp,
            "traced_temp_over_measured": (temp / got_temp if got_temp
                                          else None)}
        if peak is not None:
            check(abs(want - peak) <= TRACE_PEAK_TOL * peak,
                  f"{name}: traced peak {want} against the card's {peak} "
                  f"(tol {TRACE_PEAK_TOL})")
        if got_temp is not None:
            check(abs(temp - got_temp) <= TRACE_PEAK_TOL * got_temp,
                  f"{name}: traced temporaries {temp} against the card's "
                  f"{got_temp} (its requested peak less its arguments; "
                  f"tol {TRACE_PEAK_TOL})")
    return {"cells": cells, "held": held, "tol": TRACE_PEAK_TOL}


def held_steps(cell, peak, temp, served: dict | None,
               prefill: dict | None = None) -> dict:
    """The steps the card ran that :func:`trace_reading` holds to their
    traces: ``cell``'s decode on a mesh of one (its measured ``peak`` and
    ``temp``), the SSM prefill there (``prefill``: the dry-run phase's
    ``prefill`` reading), and mesh_serve's plain-route prefill
    (``served``: that phase's record) on the mesh it ran on, as rank 0
    measured it."""
    out = {f"{cell[0]} {cell[1]} decode": (
        ("1x1", cell[0], json.dumps(cell[1])), peak, temp)}
    if prefill is not None:
        out[f"{cell[0]} plain prefill {prefill['batch']} x "
            f"{prefill['prompt']} (stepwise scans; traced in closed "
            f"form)"] = (dryrun_prefill_key(
                (prefill["batch"], prefill["prompt"])),
                prefill["peak_bytes"], prefill["temp_bytes"])
    if served is not None:
        pre = served["prefill_plain"]
        out[f"mesh_serve {MESH_SERVE_ARCH} plain prefill on "
            f"{mesh_tag(served['mesh'])} (rank 0)"] = (
            serve_prefill_key(served["mesh"]), pre["peak_bytes"],
            pre["temp_bytes"])
    return out


def dryrun_prefill(cfg, params, batch: int, prompt: int, device,
                   base: int | None, base_req: int | None) -> dict:
    """The plain-route prefill of ``batch`` prompts of ``prompt`` tokens
    from an empty cache on ``params`` (already allocated): the peak memory
    over it above ``base`` (what was allocated before ``params``), so
    weights included, and its temporaries (the requested peak less the
    arguments: weights, cache and tokens), as :func:`trace_reading` holds
    them.  On an SSM model the recurrence runs a step per token and
    layer; its trace counts that in closed form."""
    import torch

    from repro_torch.serve.decode import prefill
    from repro_torch.serve.kvcache import init_cache

    t0 = time.perf_counter()
    cache = init_cache(cfg, batch, prompt, device=device)
    gen = torch.Generator(device="cpu").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                           dtype=torch.int32).to(device)
    args = peak = temp = None
    if device.type == "cuda":
        args = _requested(device) - base_req
        torch.cuda.reset_peak_memory_stats(device)
    ((logits, _), ms), counts = _counted(lambda: _timed(
        lambda: prefill(cfg, params, cache, tokens, use_kernel=False),
        device))
    check(tuple(logits.shape) == (batch, 1, cfg.vocab) and _finite(logits),
          f"the dry-run prefill gave {tuple(logits.shape)} or non-finite "
          f"logits")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) - base
        temp = _requested(device, "peak") - base_req - args
    return {"batch": batch, "prompt": prompt, "argument_bytes": args,
            "peak_bytes": peak, "temp_bytes": temp, "prefill_ms": ms,
            "launches": counts, "wall_s": time.perf_counter() - t0}


def phase_dryrun(device, card_bytes: int | None = None,
                 run_cfg=None, traces: dict | None = None,
                 served: dict | None = None,
                 prefill=DRYRUN_PREFILL) -> dict:
    """The dry-run records of every (arch x shape) cell
    (``launch.dryrun.cell_record``, nothing allocated) with
    ``fits_one_card`` against the card's memory, then ``DRYRUN_CELL``
    run for real: one decode step at the last position of its sequence
    from a zeroed cache, the peak memory over the step (above what was
    allocated before the phase) beside the record's argument bytes, and
    the set-up's peak (the draws' float32 temporaries) beside
    (``run_cfg`` stands in for the cell's config in a rehearsal), then
    the plain-route prefill of ``prefill`` (batch, prompt) on the same
    weights (:func:`dryrun_prefill`).  With
    ``traces`` (:func:`start_traces`' processes), their records, the
    cell's and the prefill's traced peaks on a mesh of one and mesh_serve's
    plain-route prefill's on the mesh it ran on (``served``: mesh_serve's
    record, rank 0's peak and temporaries) each held to the card's
    (:func:`trace_reading`)."""
    import torch

    from repro_torch.configs.base import SHAPES, get_config, list_configs
    from repro_torch.launch import dryrun, serve
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache

    t0 = time.perf_counter()
    if card_bytes is None and device.type == "cuda":
        card_bytes = torch.cuda.get_device_properties(device).total_memory
    rows = []
    by_cell = {}
    for arch in list_configs():
        if arch == "kratos-dd":
            continue
        for shape in SHAPES:
            r = dryrun.cell_record(arch, shape, card_bytes)
            by_cell[(arch, shape)] = r
            if r["status"] != "ok":
                rows.append([arch, shape, "skipped"])
                continue
            rows.append([arch, shape, r["kind"], r["n_params"],
                         r["n_active_params"], r["model_flops"],
                         r["bytes"], r["argument_bytes"],
                         r["fits_one_card"],
                         r["per_device"]["single"]["argument_bytes"],
                         r["per_device"]["multi"]["argument_bytes"]])
    records_s = time.perf_counter() - t0
    cell = DRYRUN_CELL
    rec = by_cell[cell]
    check(rec["fits_one_card"] is not False,
          f"the dry run says {cell} does not fit one card")
    cfg = run_cfg or get_config(cell[0])
    shape = SHAPES[cell[1]]
    check(shape.kind == "decode", f"{cell} is not a decode cell")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        base_req = _requested(device)
    t1 = time.perf_counter()
    params = serve.make_params(cfg, device, seed=0)
    cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                       encoder_len=cfg.encoder_seq or None, device=device)
    tok = torch.ones((shape.global_batch, 1), dtype=torch.int64,
                     device=device)
    held = dryrun.nbytes(params) + dryrun.nbytes(cache)
    init_peak = args = temp = None
    if device.type == "cuda":
        # the draws' float32 temporaries peak during the set-up; the step
        # is read from here
        init_peak = torch.cuda.max_memory_allocated(device) - base
        args = _requested(device) - base_req
        torch.cuda.reset_peak_memory_stats(device)
    ((logits, _), step_ms), counts = _counted(lambda: _timed(
        lambda: decode_step(cfg, params, cache, tok, shape.seq_len - 1),
        device))
    check(tuple(logits.shape) == (shape.global_batch, 1, cfg.vocab)
          and _finite(logits), f"{cell}: decode gave "
                               f"{tuple(logits.shape)} or non-finite logits")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) - base
        temp = _requested(device, "peak") - base_req - args
    else:
        peak = base = base_req = None
    run_s = time.perf_counter() - t1
    del cache, logits, _   # the step returns the cache as well
    pre = dryrun_prefill(cfg, params, *prefill, device, base, base_req)
    del params
    traced = None
    if traces is not None:
        t2 = time.perf_counter()
        got = collect_traces(traces)
        traced = {**trace_reading(got, held_steps(cell, peak, temp, served,
                                                  pre)),
                  "collect_s": time.perf_counter() - t2}
    return {"phase": "dryrun", "card_bytes": card_bytes,
            "columns": ["arch", "shape", "kind", "n_params",
                        "n_active_params", "model_flops", "bytes",
                        "argument_bytes", "fits_one_card",
                        "per_device_single", "per_device_multi"],
            "records": rows, "records_s": records_s,
            "fits": [[a, s] for (a, s), r in by_cell.items()
                     if r.get("fits_one_card")],
            "activations_counted": False,
            "run": {"cell": list(cell), "pos": shape.seq_len - 1,
                    "record_argument_bytes": rec["argument_bytes"],
                    "record_bytes": rec["bytes"],
                    "allocated_bytes": held, "argument_bytes": args,
                    "peak_bytes": peak, "temp_bytes": temp,
                    "setup_peak_bytes": init_peak,
                    "base_bytes": base, "step_ms": step_ms,
                    "launches": counts, "wall_s": run_s},
            "prefill": pre, "trace": traced,
            "wall_s": time.perf_counter() - t0}


def main() -> int:
    walls = PhaseWalls()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    device = resolve_device(None)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    card = card_line()
    walls.emit({"phase": "device", "device": name,
                "count": torch.cuda.device_count(), "nvidia_smi": card,
                "nvidia_smi_s": time.perf_counter() - t0,
                "torch": torch.__version__, "cuda": torch.version.cuda})

    secs = build.build_all()
    ptxas = {s: [ln.strip() for ln in build.build_log(s).splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln] for s in build.sources()}
    walls.emit({"phase": "build", "per_source_s": secs, "ptxas": ptxas})

    suites = full_suites()
    nets = [n for v in suites.values() for n in v]
    levels_net = fig9_workload()
    shapes = main_path_shapes(nets, levels_net)
    krec = kernel_parity(device, shapes, widest_grouped_level(nets, device))
    walls.emit({"phase": "kernel_parity", **krec})
    lmrec = lm_kernel_parity(device)
    walls.emit(lmrec)
    ssmrec = ssm_kernel_parity(device)
    walls.emit(ssmrec)

    frec = phase_flow(suites, device)
    walls.emit(frec)
    lanes = suite_lanes(nets, N_LANE_WORDS)
    rec = phase_suite_eval(nets, lanes, N_LANE_WORDS, device)
    walls.emit(rec)
    launches6 = rec["launches"]["grouped"]["lut_eval6"] \
        + rec["launches"]["per_circuit"]["lut_eval6"]
    check(rec["launches"]["grouped"]["lut_eval6"] > 0
          and rec["launches"]["per_circuit"]["lut_eval6"] > 0,
          "suite evaluation did not launch lut_eval6")

    walls.emit(phase_profile(nets, lanes, N_LANE_WORDS, device))

    by_name = {n.name: n for n in nets}
    erec = phase_equiv([by_name["conv2d-fu"], by_name["conv1d-fu"]], device,
                       n_vectors=32 * N_LANE_WORDS)
    walls.emit(erec)
    check(all(c["launches"]["lut_eval6"] > 0 for c in erec["circuits"]),
          "equivalence did not go through lut_eval6")

    swrec, unplaced = phase_sweep(suites, device, frec)
    walls.emit(swrec)
    walls.emit(phase_sweep_placed({k: suites[k] for k in PLACED_SUITES},
                                  device, unplaced["result"],
                                  unplaced["packs"]))
    serec = phase_search(suites, device, packs=unplaced["packs"])
    del unplaced
    walls.emit(serec)
    launches6 += serec["launches"]["lut_eval6"]
    walls.emit(phase_placement_ensembles({"kratos": suites["kratos"]},
                                         device))
    sfrec = phase_serve_flow(device, eval_nets=nets)
    walls.emit(sfrec)
    launches6 += sfrec["launches"]["lut_eval6"]

    lrec = phase_levels(levels_net, N_LANE_WORDS, device)
    walls.emit(lrec)
    check(lrec["launches"]["lut_eval"] > 0,
          "the per-level baseline did not launch lut_eval")

    # host work at the lowest priority while the card works through the
    # model phases (not beside the CAD phases, whose host-bound work would
    # share the cores); read by the dryrun phase at the end
    traces = start_traces(mesh_shape(torch.cuda.device_count()))

    from repro_torch.configs.base import get_config

    srec, kratos_params = phase_serve(
        "serve", get_config("kratos-dd"), device, gate=(2, 128, 16),
        timed=(8, 512, 64))
    walls.emit(srec)
    flash_launches = srec["timed"]["launches"]["flash_attention"]
    check(flash_launches == srec["flash_launches_expected"],
          f"kratos-dd serving launched flash_attention {flash_launches} "
          f"times, expected {srec['flash_launches_expected']}")
    check(srec["gate"]["launches"]["flash_attention"] > 0,
          "the kratos-dd gate run did not launch flash_attention")
    check_flash_variants(srec)
    walls.emit(phase_profile_serve(get_config("kratos-dd"), kratos_params, 8,
                                   512, device))
    del kratos_params
    torch.cuda.empty_cache()

    grec, gemma_params = phase_serve(
        "serve_gemma2", get_config("gemma2-2b"), device, gate=(1, 4608, 4),
        timed=(2, 4608, 16))
    walls.emit(grec)
    check(grec["timed"]["launches"]["flash_attention"]
          == grec["flash_launches_expected"],
          "gemma2-2b serving did not launch flash_attention once per layer "
          "and step")
    check_flash_variants(grec)
    walls.emit(phase_profile_serve(get_config("gemma2-2b"), gemma_params, 2,
                                   4608, device))
    del gemma_params
    torch.cuda.empty_cache()
    chrec = phase_serve_chunked(get_config("gemma2-2b"), device)
    walls.emit(chrec)
    torch.cuda.empty_cache()
    new_serve = []
    for phase, arch in SERVE_MORE:
        rec_, params_ = phase_serve(phase, get_config(arch), device,
                                    gate=SERVE_MORE_GATE,
                                    timed=SERVE_MORE_TIMED)
        del params_
        torch.cuda.empty_cache()
        check(rec_["timed"]["launches"]["flash_attention"]
              == rec_["flash_launches_expected"],
              f"{arch} serving did not launch flash_attention once per "
              f"layer and step")
        check_flash_variants(rec_)
        timed_calls = [r for r in lmrec["flash_attention"]["main"]
                       if r["label"].startswith(arch + " ")]
        if timed_calls:   # gemma-2b's G 8, D 256 prefill and decode
            rec_["flash_main"] = timed_calls
        walls.emit(rec_)
        new_serve.append(rec_)

    qrec = phase_quantized(as_float32(get_config("kratos-dd")), device)
    walls.emit(qrec)
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
    walls.emit(mrec)
    check_ssd_variants(mrec)
    walls.emit(phase_profile_ssm(get_config("mamba2-2.7b"), mamba_params, 2,
                                 4096, device))
    del mamba_params
    torch.cuda.empty_cache()
    hrec, hymba_params = phase_ssm(
        "ssm_hymba", get_config("hymba-1.5b"), device,
        gate=(1, 512, 497, 16), forward=(2, 2048), timed=(8, 2048, 32))
    walls.emit(hrec)
    check_ssd_variants(hrec)
    walls.emit(phase_profile_ssm(get_config("hymba-1.5b"), hymba_params, 2,
                                 2048, device))
    del hymba_params
    torch.cuda.empty_cache()

    from repro_torch.models import blocks

    ds = get_config("deepseek-moe-16b")
    moerec, moe_state = phase_serve_moe(ds, device, gate=MOE_GATE,
                                        timed=MOE_TIMED)
    walls.emit(moerec)
    walls.emit({**phase_profile_serve(
        ds, moe_state["params"], MOE_TIMED[0], MOE_TIMED[1], device,
        ranges=(blocks.EXPERTS_RANGE,)),
        "phase": "profile_moe"})
    i8rec = phase_serve_moe_int8(ds, moe_state, device, gate=MOE_GATE,
                                 timed=MOE_TIMED)
    walls.emit(i8rec)
    del moe_state
    torch.cuda.empty_cache()
    walls.emit(phase_moe_topk(ds, device))
    vlmrec = phase_serve_vlm(get_config("llava-next-34b"), device,
                             gate=VLM_GATE, timed=VLM_TIMED)
    walls.emit(vlmrec)
    torch.cuda.empty_cache()
    encrec = phase_serve_encdec(get_config("whisper-small"), device,
                                gate=ENCDEC_GATE, forward=ENCDEC_FORWARD,
                                timed=ENCDEC_TIMED)
    walls.emit(encrec)
    torch.cuda.empty_cache()

    fbrec = phase_flash_backward(device)
    walls.emit(fbrec)
    families = []
    for arch, (_, gate, run) in FAMILY_TRAIN.items():
        workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_family_"))
        try:
            families.append(phase_train_family(arch, device, gate, run,
                                               workdir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        walls.emit(families[-1])
        torch.cuda.empty_cache()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        trec, prec = phase_train("train_tinyllama",
                                 get_config("tinyllama-1.1b"), device,
                                 workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    walls.emit(trec)
    walls.emit(prec)
    torch.cuda.empty_cache()
    plrec = phase_pipeline(get_config("tinyllama-1.1b"), device)
    walls.emit(plrec)
    torch.cuda.empty_cache()
    mtrec = phase_mesh_train(device)
    walls.emit(mtrec)
    torch.cuda.empty_cache()
    msrec = phase_mesh_serve(device)
    walls.emit(msrec)
    torch.cuda.empty_cache()
    walls.emit(phase_dryrun(device, traces=traces, served=msrec))

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
                # kratos-dd serving, the new families' timed serving
                # runs, the timed training run, gemma2-2b's chunked
                # forward, the pipeline and the mesh runs (every rank's)
                "flash_attention": flash_launches + sum(
                    r["timed"]["launches"]["flash_attention"]
                    for r in (moerec, i8rec, vlmrec, encrec, trec, chrec))
                + plrec["bf16"]["launches"]["flash_attention"]
                + sum(mtrec["per_rank_launches"])
                + sum(msrec["per_rank_launches"])
                # qwen1.5-0.5b and gemma-2b serving, the other families'
                # bf16 training runs and deepseek's fp8 step
                + sum(r["timed"]["launches"]["flash_attention"]
                      for r in new_serve)
                + sum(r[k]["launches"]["flash_attention"]
                      for r in families for k in ("timed", "fp8_step")
                      if r[k] is not None),
                "bitplane_matmul": bit_launches,
                # the two models' timed forwards (64 + 32 SSD layers)
                "ssd_scan": sum(r["forward"]["launches"]["ssd_scan"]
                                for r in (mrec, hrec)),
                # no model path calls it: its one counted main call
                "popcount_matmul": pop_main["launches"]}
    flash_main = lmrec["flash_attention"]["main"][0]  # kratos-dd prefill
    # the float32 (tf32x3) kernel at whisper-small's serving encoder
    flash_f32 = next(r for r in lmrec["flash_attention"]["main"]
                     if r["label"] == FLASH_F32_MAIN)
    bit_main = lmrec["bitplane_matmul"]["main"][1]    # [4096, 768] rows
    recs = {**{k: {**krec[k], "library_ms": None}
               for k in ("lut_eval6", "lut_eval")},
            "flash_attention": {
                **flash_main, "shape": [flash_main["q"], flash_main["kv"]],
                "max_abs_err": max(
                    flash_main["max_abs_err"],
                    *lmrec["flash_attention"]["max_abs_err"].values(),
                    *fbrec["max_abs_err"].values()),
                "train": {
                    "launches_per_step":
                        trec["flash_launches_expected"]["per_step"],
                    "ms": fbrec["train_shape"]["forward_ms"],
                    "device_ms": fbrec["train_shape"]["forward_device_ms"],
                    **{k: fbrec["train_shape"][k] for k in (
                        "shape", "plain_ms", "recompute_backward_ms",
                        "recompute_backward_device_ms",
                        "route_forward_backward_ms", "bound_ms",
                        "bound_by", "library_ms")}},
                "float32": {
                    "shape": [flash_f32["q"], flash_f32["kv"]],
                    **{k: flash_f32[k] for k in (
                        "variant", "ms", "device_ms", "plain_ms", "bound_ms",
                        "bound_by", "fp32_bound_ms", "library_ms",
                        "library_device_ms")}}},
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
                      "suite per_circuit": rec["variants"]["per_circuit"],
                      "search verify": serec["verify_variants"],
                      "search winner simulated": sum(
                          r["lut_eval6_launches"]
                          for r in serec["winner_simulated"]),
                      **{f"serve_flow eval {b}": sfrec["eval"][b]["variants"]
                         for b in ("torch", "numpy")}},
        "flash_attention": {
            "serve bf16": srec["timed"]["variants"]["flash_attention"],
            "gate float32": srec["gate"]["variants"]["flash_attention"],
            **{f"serve bf16 {r['arch']}{' int8' if r is i8rec else ''}":
               r["timed"]["variants"]["flash_attention"]
               for r in (moerec, i8rec, vlmrec, encrec)},
            "forward bf16 whisper-small":
                encrec["forward_bf16"]["variants"]["flash_attention"],
            "train bf16": trec["timed"]["variants"]["flash_attention"],
            "train gate float32":
                trec["gate"]["variants"]["flash_attention"],
            **{f"serve bf16 {r['arch']}":
               r["timed"]["variants"]["flash_attention"] for r in new_serve},
            **{f"{what} {r['arch']}": r[k]["variants"]["flash_attention"]
               for r in families if r["route"] == "kernel"
               for what, k in (("train bf16", "timed"),
                               ("train fp8 step", "fp8_step"),
                               ("train gate float32", "gate"),
                               ("train gate bf16", "gate_bf16"))
               if r[k] is not None},
            "chunked gemma2-2b":
                chrec["timed"]["variants"]["flash_attention"],
            "chunked gate float32 gemma2-2b":
                chrec["gate"]["variants"]["flash_attention"],
            "pipeline tinyllama-1.1b":
                plrec["bf16"]["variants"]["flash_attention"],
            "pipeline float32 tinyllama-1.1b":
                plrec["float32"]["variants"]["flash_attention"],
            "mesh train bf16 (rank 0)":
                mtrec["timed"]["variants"]["flash_attention"],
            "mesh train gate float32 (rank 0)":
                mtrec["gate"]["variants"]["flash_attention"],
            "mesh serve bf16 (rank 0)":
                msrec["timed"]["variants"]["flash_attention"],
            "mesh serve gate float32 (rank 0)":
                msrec["gate"]["variants"]["flash_attention"]},
        "bitplane_matmul": {
            "quantized": qrec["variants"]["bitplane_matmul"]},
        "ssd_scan": {
            "forward bf16 mamba2": mrec["forward"]["variants"]["ssd_scan"],
            "forward bf16 hymba": hrec["forward"]["variants"]["ssd_scan"],
            "gate float32 mamba2":
                mrec["gate"]["forward"]["variants"]["ssd_scan"]},
        "popcount_matmul": {"main": pop_main["variants"]}}
    emit({"phase": "profiler", "floor": PROFILE_FLOOR,
          "warmup_launches": PROFILE_WARMUP_LAUNCHES, "tries": PROFILE_TRIES,
          "rejected": PROFILE_REJECTED})
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
            if k in variant_launches else {}),
         **{key: r[key] for key in ("train", "float32") if key in r}}
        for k, r in recs.items()]})
    emit(walls.line())
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(_mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4], sys.argv[5], *sys.argv[6:7]))
    sys.exit(main())
