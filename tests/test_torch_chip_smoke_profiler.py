"""``chip_smoke.device_ms``'s rules against short profiler readings,
driven on the CPU with stubbed profiler sessions: a reading whose
session's records show a loss (it kept none of its window's opening
launches, or a kernel's count is no multiple of the calls), or far below
what the same call's CUDA events allow beside the host's own time to
launch it outside the profiler, is retried and, if every try is short,
reported as not measured (None) with each rejected try kept in
``PROFILE_REJECTED``; a sound reading, or a host-bound call's small
whole one, passes."""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: whisper-small's decoder recompute backward at [8, 12, 128, 64], a
#: host-bound call: 2.44 ms a call in CUDA events, of which the device
#: is busy 0.146 (the profiler's whole reading), the host launching
#: the rest; a late session without opening launches once read 0.021
WHISPER = dict(events_ms=2.44, host_ms=2.40, whole=0.146, lost=0.021)


def _records(counts: dict) -> list:
    return [SimpleNamespace(key=k, count=n, self_device_time_total=0.0)
            for k, n in counts.items()]


def test_short_reading_rule():
    # a device-bound call: 22.8 ms in events, 0.5 ms of host time a call
    assert cs.short_reading(7.73, 22.8, 0.5)
    assert not cs.short_reading(22.2, 22.8, 0.5)
    # a host-bound call: the device may idle for most of the events time,
    # and the events' launch latency outweighs its work (whisper's decoder
    # forward and backward through SDPA: 0.0217 ms device, 0.804 events)
    assert not cs.short_reading(0.0113, 0.0437, 0.040)
    assert not cs.short_reading(0.0217, 0.804, 0.731)
    assert not cs.short_reading(0.001, 0.804, 0.402)
    assert cs.short_reading(None, 0.0437, 0.040)   # no device records
    assert not cs.short_reading(0.5, None, 0.0)    # nothing to hold it to
    assert cs.short_reading(0.021, 2.83, 0.3)      # most of the work lost
    assert cs.short_reading(0.2, 0.804, 0.401)     # device-bound, short
    # whisper's decoder: the events allow the device to idle almost all
    # of the call, so the floor alone passes its short reading
    w = WHISPER
    assert not cs.short_reading(w["lost"], w["events_ms"], w["host_ms"])
    assert not cs.short_reading(w["whole"], w["events_ms"], w["host_ms"])


def test_lost_records_rule():
    whole = _records({"gemm": 4, "softmax": 2, "Memset (Device)": 2})
    assert not cs.lost_records(whole, 2, 49)       # opening partly dropped
    assert not cs.lost_records(whole, 2, None)     # no opening launches
    assert cs.lost_records(whole, 2, 0)            # opening wholly dropped
    # the first call's first records dropped
    assert cs.lost_records(_records({"gemm": 3, "softmax": 2}), 2, None)
    assert cs.lost_records(_records({"gemm": 4, "softmax": 1}), 2, 257)


def _sessions(monkeypatch, readings, host_ms: float):
    """``profile_session`` stubbed to give ``readings`` in turn: each
    ``(device ms summed over the calls, the records kept of the window's
    opening launches)``, one kernel record a reading (none for None),
    launched once a call; ``host_launch_ms`` to give ``host_ms``."""
    it = iter(readings)

    def session(fn, calls, **_):
        total, opening = next(it)
        dev = [] if total is None else [SimpleNamespace(
            key="kernel", count=calls, self_device_time_total=total * 1e3)]
        return None, dev, 10 * host_ms, opening

    monkeypatch.setattr(cs, "profile_session", session)
    monkeypatch.setattr(cs, "host_launch_ms", lambda fn, calls: host_ms)
    monkeypatch.setattr(cs, "PROFILE_REJECTED", [])


def test_device_ms_rejects_short_readings(monkeypatch):
    _sessions(monkeypatch, [(2 * 7.73, 257), (2 * 9.4, 257), (None, 257)],
              0.5)
    ms, kernels = cs.device_ms(lambda: None, calls=2, events_ms=22.8)
    assert ms is None and kernels == []
    assert [r["ms"] for r in cs.PROFILE_REJECTED] == [7.73, 9.4, None]
    assert [r["try"] for r in cs.PROFILE_REJECTED] == [0, 1, 2]
    assert all(r["at"].startswith("test_torch_chip_smoke_profiler.py:")
               and r["events_ms"] == 22.8 and r["host_ms"] == 0.5
               for r in cs.PROFILE_REJECTED)


def test_device_ms_keeps_a_whole_reading_after_a_short_one(monkeypatch):
    _sessions(monkeypatch, [(2 * 7.73, 257), (2 * 22.1, 48)], 0.5)
    ms, kernels = cs.device_ms(lambda: None, calls=2, events_ms=22.8)
    assert ms == pytest.approx(22.1)
    assert kernels == [{"name": "kernel", "ms": pytest.approx(22.1)}]
    assert len(cs.PROFILE_REJECTED) == 1


def test_device_ms_rejects_a_host_bound_reading_that_lost_records(
        monkeypatch):
    """whisper's decoder recompute: a session that dropped every opening
    launch's record reads 0.021 ms and is turned down, though the events
    floor would pass it; the next, whole, reads 0.146."""
    w = WHISPER
    _sessions(monkeypatch, [(2 * w["lost"], 0), (2 * w["whole"], 49)],
              w["host_ms"])
    ms, _ = cs.device_ms(lambda: None, calls=2, events_ms=w["events_ms"])
    assert ms == pytest.approx(w["whole"])
    [rej] = cs.PROFILE_REJECTED
    assert rej["ms"] == pytest.approx(w["lost"])
    assert rej["opening_records"] == 0 and rej["host_ms"] == w["host_ms"]


def test_device_ms_names_kernels_of_a_rejected_reading_without_time(
        monkeypatch):
    _sessions(monkeypatch, [(5 * 0.001, 257)] * cs.PROFILE_TRIES, 0.01)
    ms, kernels = cs.device_ms(lambda: None, calls=5, events_ms=2.0)
    assert ms is None and kernels == [{"name": "kernel", "ms": None}]
    # a host-bound call's small whole reading is no short one: its host
    # time is the one outside the profiler, not the profiled session's
    # (here ten times longer than the events)
    _sessions(monkeypatch, [(5 * 0.0113, 257)], 0.040)
    ms, _ = cs.device_ms(lambda: None, calls=5, events_ms=0.0437)
    assert ms == pytest.approx(0.0113) and cs.PROFILE_REJECTED == []
