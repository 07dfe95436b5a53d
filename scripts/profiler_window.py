"""Where a profiler reading loses device time: ``torch.profiler`` sessions
over the training shapes' attention backward, early in a process and again
after minutes of work, as ``chip_smoke.device_ms`` opened them before it
opened each window with throwaway launches, held open longer, and as it
opens them now.

    python scripts/profiler_window.py [--phases train|none]

On the card (CUDA): for whisper-small's decoder and tinyllama-1.1b's
training attention (bf16), the recomputing backward that
``FlashAttentionFn.backward`` runs, timed with CUDA events
(``chip_smoke.time_ms``), then read in ``chip_smoke.profile_session``
sessions without throwaway launches (``warmup`` 0) and ``pad_s`` 0 or
0.5 s (the window held open that long before the calls and after the
device finished them), and with ``chip_smoke``'s
``PROFILE_WARMUP_LAUNCHES``.  For each call, the host's ms to launch
it outside the profiler; for each session: the device ms per call, the
device records (and by kernel name: count and ms per call), those it
kept of its window's opening launches, the host's ms per call under
the profiler, whether ``chip_smoke.lost_records`` and
``chip_smoke.short_reading`` turn it down, and from the profiler's own
records the offset of each kernel's start on the device from its launch
on the host (a kernel cannot start before it is launched) and the end of
the last kernel against the end of the host's ``cudaDeviceSynchronize``
that waited for it: on one clock the first is a few microseconds and the
second negative.  ``--phases train`` runs ``chip_smoke.py``'s training phases
between the two probes (their records printed as they come), as the
script runs them late.  One JSON line a probe and a phase.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402

#: (label, [B, Hq, Hkv, S, D], causal) of the probed backward calls
CALLS = [("whisper-small decoder", [8, 12, 12, 128, 64], True),
         ("tinyllama-1.1b", [4, 32, 4, 2048, 64], True)]
#: (pad_s, warmup launches) of the sessions
SESSIONS = ((0.0, 0), (0.5, 0), (0.0, cs.PROFILE_WARMUP_LAUNCHES))


def clocks(prof) -> dict:
    """The kernels' offsets from their launches, in µs (min, median,
    max), and the last kernel's end less the end of the last device
    synchronisation (ms)."""
    import numpy as np
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in evs
              if e.device_type() == DeviceType.CPU
              and "LaunchKernel" in e.name()}
    kernels = [e for e in evs if e.device_type() == DeviceType.CUDA]
    offs = [(e.start_ns() - launch[e.correlation_id()]) / 1e3
            for e in kernels if e.correlation_id() in launch]
    sync = [e.end_ns() for e in evs if e.name() == "cudaDeviceSynchronize"]
    end = max((e.end_ns() for e in kernels), default=None)
    return {"all_kernel_records": len(kernels), "linked": len(offs),
            "launch_to_start_us": ([float(np.min(offs)),
                                    float(np.median(offs)),
                                    float(np.max(offs))] if offs else None),
            "last_end_after_sync_ms": ((end - max(sync)) / 1e6
                                       if sync and end is not None
                                       else None)}


def probe(when: str, device) -> list:
    """Each of ``CALLS``: events ms, then one session a pad."""
    import torch

    from repro_torch.kernels import ref

    out = []
    for label, (B, Hq, Hkv, S, D), causal in CALLS:
        q, k, v, g = cs.train_shape_inputs(device, (B, Hq, Hkv, S, S, D))
        qd, kd, vd = [t.detach().requires_grad_() for t in (q, k, v)]
        kw = dict(causal=causal, window=cs.HUGE_WINDOW if causal else None,
                  softcap=None)

        def recompute_bwd():
            with torch.enable_grad():
                o = ref.flash_attention_ref(qd, kd, vd, **kw)
                return torch.autograd.grad(o, (qd, kd, vd), g)

        events = cs.time_ms(recompute_bwd, **cs.HEAVY_REPS)
        calls = 2
        launch = cs.host_launch_ms(recompute_bwd, calls)
        rows = []
        for pad, warmup in SESSIONS:
            prof, dev, host, opening = cs.profile_session(
                recompute_bwd, calls, warmup=warmup, pad_s=pad)
            ms = sum(e.self_device_time_total for e in dev) / 1e3 / calls
            rows.append({"pad_s": pad, "warmup": warmup, "device_ms": ms,
                         "records": sum(e.count for e in dev),
                         "opening_records": opening, "host_ms": host,
                         "lost": cs.lost_records(dev, calls, opening),
                         "short": cs.short_reading(ms, events, launch),
                         **clocks(prof),
                         "by_name": sorted(
                             [e.key[:70], e.count,
                              e.self_device_time_total / 1e3 / calls]
                             for e in dev)})
        out.append({"probe": when, "call": label, "events_ms": events,
                    "host_launch_ms": launch, "sessions": rows})
        del q, k, v, g, qd, kd, vd
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="train", choices=["train", "none"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_window: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build

    device = torch.device("cuda")
    build.build_all()
    t0 = time.perf_counter()
    for rec in probe("early", device):
        cs.emit({**rec, "process_s": time.perf_counter() - t0})
    if args.phases == "train":
        for arch, (_, gate, run) in cs.FAMILY_TRAIN.items():
            with tempfile.TemporaryDirectory() as d:
                cs.emit(cs.phase_train_family(arch, device, gate, run, d))
            torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as d:
            rec, prof = cs.phase_train("train_tinyllama",
                                       get_config("tinyllama-1.1b"), device,
                                       d)
        cs.emit(rec)
        cs.emit(prof)
        torch.cuda.empty_cache()
        cs.emit(cs.phase_mesh_train(device))
        torch.cuda.empty_cache()
    for rec in probe("late", device):
        cs.emit({**rec, "process_s": time.perf_counter() - t0})
    cs.emit({"profile_rejected": cs.PROFILE_REJECTED,
             "card": cs.card_line()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
