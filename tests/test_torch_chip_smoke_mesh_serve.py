"""``chip_smoke.py``'s mesh serving phase and the dry run's traced peaks,
rehearsed on the CPU.

- ``mesh_serve`` (its rank part on a gloo group of 2, a ``(1, 2)`` mesh,
  in subprocesses, deepseek-moe-16b at smoke width): the float32 gate and
  the timed run pass, and the gate refuses a planted fault, the
  all-reduce over ``model`` after the row-sharded products (the experts'
  partial sums among them) dropped, each rank keeping its partial sum;
- the traced peaks and temporaries held to the card's: within
  ``TRACE_PEAK_TOL`` passes, beyond it fails, and a failed trace fails;
  mesh_serve's prefill is held to the trace of the mesh it ran on, and
  the dry-run phase reads the traces of a four-card record so.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_config

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: the rehearsal's sizes: gate and timed (batch, prompt, new tokens)
SIZES = ((2, 16, 4), (2, 16, 4))

SCRIPT = r"""
import json, sys
sys.path.insert(0, ARGS[0])
import torch
import chip_smoke as cs
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.models import blocks


def dropped(x):
    # the partial sums over model kept as they are: no all-reduce
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements],
        run_check=False)


if ARGS[1] == "fault":
    blocks.reduce_model = dropped
gate, timed = (tuple(x) for x in json.loads(ARGS[2]))
try:
    rec = cs.mesh_serve_rank(cs.MESH_SERVE_ARCH, torch.device("cpu"), 2,
                             gate, timed, 2, smoke=True)
    out = {k: rec[k] for k in ("mesh", "gate", "prefill_plain", "timed")}
except cs.SmokeFailure as e:
    out = {"refused": str(e)[:300]}
print(json.dumps(out))
"""


def _ranks(tmp_path, mode: str) -> list:
    from _torch_ranks import run_ranks

    return run_ranks(SCRIPT, 2, tmp_path, str(ROOT), mode,
                     json.dumps(SIZES), timeout=240)


def test_mesh_serve_phase_rehearsed_on_cpu(tmp_path):
    for rec in _ranks(tmp_path, "sound"):
        assert rec["mesh"] == {"data": 1, "model": 2}
        gate, timed = rec["gate"], rec["timed"]
        assert gate["layers"] == 2 and gate["tokens_identical"]
        assert gate["max_abs_logit_diff_vs_plain"] <= gate["tol"]
        assert gate["max_abs_logit_diff_vs_unsharded"] <= gate["tol"]
        assert timed["tokens_identical"]
        assert timed["max_abs_logit_diff_vs_unsharded"] <= timed["tol"]
        # two ranks: held to the unsharded routes' own distance
        assert timed["unsharded_plain_vs_kernel_while_tokens_agree"] \
            is not None
        assert timed["max_abs_logit_diff_while_tokens_agree"] <= timed["tol"]
        assert timed["flash_heads"] == {}          # no card: no launches
        assert rec["prefill_plain"]["peak_bytes"] is None
        assert rec["prefill_plain"]["temp_bytes"] is None
        assert rec["prefill_plain"]["cache_len"] == SIZES[1][1]


def test_mesh_serve_gate_rejects_a_dropped_model_all_reduce(tmp_path):
    for rec in _ranks(tmp_path, "fault"):
        assert "mesh serving gate" in rec.get("refused", ""), rec


def _trace(arg: int, temp: int) -> dict:
    return {"status": "ok", "memory": {"argument_size_in_bytes": arg,
                                       "temp_size_in_bytes": temp},
            "cost": {"flops": 1.0}, "collectives": {"total_bytes": 0},
            "trace_s": 0.1}


def test_traced_peak_is_held_to_the_card():
    key = ("1x1", "mamba2-2.7b", json.dumps("long_500k"))
    traces = {key: _trace(1000, 50)}
    rec = cs.trace_reading(traces, {"decode": (key, 1000, 48)})
    assert rec["held"]["decode"]["traced_over_measured"] == 1.05
    assert rec["held"]["decode"]["traced_temp_over_measured"] == 50 / 48
    assert rec["cells"]["1x1 mamba2-2.7b \"long_500k\""]["peak_bytes"] == 1050
    # no card: recorded, not held
    assert cs.trace_reading(traces, {"decode": (key, None, None)})["held"][
        "decode"]["traced_over_measured"] is None
    with pytest.raises(cs.SmokeFailure, match="traced peak"):
        cs.trace_reading(traces, {"decode": (key, 900, 50)})
    # the peak within its tolerance, the temporaries beyond theirs
    with pytest.raises(cs.SmokeFailure, match="traced temporaries"):
        cs.trace_reading(traces, {"decode": (key, 1000, 40)})
    with pytest.raises(cs.SmokeFailure, match="a trace failed"):
        cs.trace_reading({key: {"status": "error", "error": "boom"}},
                         {"decode": (key, 1000, 50)})
    # a trace that failed fails the reading, held or not
    other = ("single", "deepseek-moe-16b", json.dumps("train_4k"))
    with pytest.raises(cs.SmokeFailure, match="a trace failed"):
        cs.trace_reading({key: _trace(1000, 50),
                          other: {"status": "error", "error": "boom"}},
                         {"decode": (key, 1000, 50)})


def _serve_rec(mesh, peak, temp) -> dict:
    return {"mesh": list(mesh), "prefill_plain": {"peak_bytes": peak,
                                                  "temp_bytes": temp}}


@pytest.mark.parametrize("mesh", [(1, 1), (1, 2), (2, 2)])
def test_mesh_serve_prefill_is_held_to_its_own_mesh(mesh):
    """mesh_serve's prefill on more than one card is held to the trace of
    the mesh it ran on, not to the mesh of one's: rank 0 of ``(2, 2)``
    holds a quarter of the weights."""
    cell = ("mamba2-2.7b", "long_500k")
    key = cs.serve_prefill_key(mesh)
    assert key[0] == "x".join(map(str, mesh))
    measured = cs.held_steps(cell, 1000, 50, _serve_rec(mesh, 2000, 200))
    (name, (got_key, peak, temp)), = [
        (n, v) for n, v in measured.items() if "prefill" in n]
    assert got_key == key and (peak, temp) == (2000, 200)
    decode = ("1x1", cell[0], json.dumps(cell[1]))
    one = cs.serve_prefill_key((1, 1))
    traces = {decode: _trace(1000, 50), key: _trace(1800, 200)}
    if key != one:
        # the mesh of one's trace (the whole weights) beside: not read
        traces[one] = _trace(8000, 200)
    rec = cs.trace_reading(traces, measured)
    assert rec["held"][name]["trace"] == list(key)
    assert rec["held"][name]["traced_over_measured"] == 1.0
    if key != one:
        with pytest.raises(cs.SmokeFailure, match="traced peak"):
            cs.trace_reading({**traces, key: traces[one]}, measured)


def test_dryrun_phase_reads_the_trace_of_the_mesh_served():
    """The dry-run phase with traces and a four-card mesh_serve record:
    the long_500k decode is read from the mesh of one's trace, the
    prefill from the ``(2, 2)`` one (full width, ``meta`` tensors; no
    card, so nothing is held)."""
    from repro_torch.launch import trace

    B, S, _ = cs.MOE_TIMED
    cells = {"1x1": [list(cs.DRYRUN_CELL)],
             "2x2": [[cs.MESH_SERVE_ARCH, ["prefill", B, S]]]}
    procs = {tag: (trace.start(c, sizes=[int(n) for n in tag.split("x")],
                               names=["data", "model"]), c)
             for tag, c in cells.items()}
    served = {"mesh": [2, 2], "prefill_plain": {"peak_bytes": None,
                                                "temp_bytes": None}}
    run_cfg = get_config("mamba2-2.7b").smoke()
    rec = cs.phase_dryrun(torch.device("cpu"), card_bytes=80 * 2**30,
                          run_cfg=run_cfg, traces=procs, served=served)
    held = rec["trace"]["held"]
    assert sorted(h["trace"][0] for h in held.values()) == ["1x1", "2x2"]
    prefill = [h for n, h in held.items() if "prefill" in n][0]
    # rank 0 of (2, 2) holds a quarter of the weights or less
    assert prefill["traced_peak_bytes"] < 12 * 2**30
    assert prefill["measured_peak_bytes"] is None
    assert len(rec["trace"]["cells"]) == 2
