"""``chip_smoke.py``'s families mesh phase, rehearsed on the CPU at smoke
width:

- ``mesh_train_families`` on a ``(1, 1)`` gloo group in this process:
  every family's mesh gate (qwen1.5-0.5b, deepseek-moe-16b, mamba2-2.7b,
  hymba-1.5b, whisper-small, llava-next-34b) against its unsharded step;
- the branch for more than one card on two gloo ranks, a ``(1, 2)``
  mesh, in subprocesses: the six gates sharded, the MoE model through the
  train launcher at full (smoke) depth, the pipeline with one stage per
  rank and the elastic restore onto ``(2, 1)``;
- planted faults, each rejected by its family's gate on ``(1, 2)``: the
  model-axis all-reduce after the SSD ``out_proj`` dropped (mamba2), and
  the one after the MoE experts' combine dropped (deepseek);
- ``trace_reading`` holding the four-card MoE step's per-rank peaks to a
  deepseek-shaped trace: within ``TRACE_PEAK_TOL`` it passes, beyond it
  fails;
- the sweep's oracle gate, now checked in worker processes, rejecting a
  record one ulp off.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import circuits
from repro_torch.core.alm import arch_grid

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")
#: the rehearsals' gate (layers, batch, sequence) for every family, and the
#: branch's sizes: the MoE run (steps, batch, sequence), the pipeline
#: (stages, microbatches, rows, sequence; the stages are the ranks) and
#: the elastic restore's step (batch, sequence)
GATES = {a: (2, 1, 8) for a in cs.MESH_FAMILY_GATES}
MORE = {"timed": (2, 2, 8), "pipeline_shape": (2, 4, 1, 8),
        "elastic": (2, 8)}

SCRIPT = r"""
import json, sys
sys.path.insert(0, ARGS[0])
import torch
import chip_smoke as cs
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import blocks

CPU = torch.device("cpu")
gates, more = json.loads(ARGS[2])


def dropped(x):
    # the partial sums over model kept as they are: no all-reduce
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements],
        run_check=False)


if ARGS[3] == "phase":      # a group of one: the phase in this process
    out = cs.phase_mesh_train_families(CPU, gates=gates, smoke=True)
else:                       # the branch, then each gate with its fault
    out = {"sound": cs.mesh_families_rank(CPU, 2, gates,
                                          workdir=cs.Path(ARGS[1]),
                                          smoke=True, more=more),
           "faults": {}}
    mesh = make_host_mesh(2, CPU)
    einsum = blocks._dispatch_einsum

    def combine_dropped(eq, *ts):
        y = einsum(eq, *ts)
        return dropped(y) if eq == "necd,ngec->ngd" else y

    for arch, module, name, fault in (
            ("mamba2-2.7b", blocks, "reduce_model", dropped),
            ("deepseek-moe-16b", blocks, "_dispatch_einsum",
             combine_dropped)):
        real = getattr(module, name)
        setattr(module, name, fault)
        try:
            cs.mesh_gate(get_config(arch).smoke(), mesh, CPU,
                         *gates[arch])
            out["faults"][arch] = "passed"
        except cs.SmokeFailure as e:
            out["faults"][arch] = str(e)[:300]
        finally:
            setattr(module, name, real)
print(json.dumps(out))
"""


def _ranks(tmp_path, mode: str, world: int) -> list:
    from _torch_ranks import run_ranks

    return run_ranks(SCRIPT, world, tmp_path, str(ROOT),
                     str(tmp_path / "work"), json.dumps([GATES, MORE]), mode,
                     timeout=240)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory) -> list:
    """Each of two ranks' record of the branch and of the planted faults
    (one launch of both: the ranks' start and warm-up cost more than the
    gates at this width)."""
    return _ranks(tmp_path_factory.mktemp("two_ranks"), "branch", 2)


def _held(rec: dict, arch: str):
    gate = rec["gate"]
    assert gate["worst_grad_share_of_tol"] <= 1.0, arch
    assert gate["worst_post_step_share_of_tol"] <= 1.0, arch
    assert gate["loss"]["mesh_vs_unsharded"] <= gate["loss"]["tol"], arch


def test_families_phase_rehearsed_on_one_rank(tmp_path):
    """Every family's gate on a ``(1, 1)`` mesh over a gloo group of one:
    the kernel route's families held to the unsharded kernel step with
    the plain path's float64 noise, ssm and hybrid on the plain route
    held with the host's float64 noise; nothing launches on the CPU."""
    rec, = _ranks(tmp_path, "phase", 1)
    assert rec["phase"] == "mesh_train_families"
    assert rec["cards"] == 1 and rec["mesh"] == [1, 1]
    assert list(rec["families"]) == list(cs.MESH_FAMILY_GATES)
    routes = {a: f["route"] for a, f in rec["families"].items()}
    assert routes == {"qwen1.5-0.5b": "kernel", "deepseek-moe-16b": "kernel",
                      "llava-next-34b": "kernel", "whisper-small": "kernel",
                      "mamba2-2.7b": "plain", "hymba-1.5b": "plain"}
    for arch, fam in rec["families"].items():
        _held(fam, arch)
        noise = ("plain", "float64") if fam["route"] == "kernel" else (
            "unsharded", "host_float64")
        assert f"{noise[0]}_vs_{noise[1]}" in fam["gate"]["loss"], arch
        assert fam["gate"]["flash_heads"] == {}   # no card
        # a mesh of one card still shards the weights (over data, FSDP,
        # and over model); only the batch's dimension of one row stays
        # replicated
        placed = fam["gate"]["placements"]
        assert any("S" in k for k in placed["params"]), (arch, placed)
        assert set(placed["batch"]) == {"R,R"}, (arch, placed)
    # the decoder's and encoder's layers (no remat at smoke width)
    assert rec["families"]["whisper-small"]["flash_expected"]["variants"][
        "tf32x3"] == 2 + 2
    assert rec["flash_launches"] == 0
    assert "moe_full_depth" not in rec and cs.families_held(rec) == {}


def test_more_cards_branch_rehearsed_on_two_ranks(two_ranks):
    recs = [r["sound"] for r in two_ranks]
    assert [r["mesh"] for r in recs] == [{"data": 1, "model": 2}] * 2
    rec = cs.families_record(recs, (1, 2), CPU, GATES, smoke=True)
    for arch, fam in rec["families"].items():
        for r in recs:
            _held({"gate": r["families"][arch]}, arch)
        assert len(fam["per_rank_worst_grad_share_of_tol"]) == 2
    moe = rec["moe_full_depth"]
    assert moe["trace"] == ["1x2", "deepseek-moe-16b", '["train", 2, 8]']
    assert [len(r["losses"]) for r in moe["per_rank"]] == [2, 2]
    assert moe["per_rank"][0]["losses"] == moe["per_rank"][1]["losses"]
    assert all(np.isfinite(r["losses"]).all() for r in moe["per_rank"])
    assert moe["per_rank"][0]["peak_bytes"] is None   # no card
    held = cs.families_held(rec)
    assert len(held) == 2 and all(v[0] == tuple(moe["trace"])
                                  for v in held.values())
    pipe = rec["pipeline"]
    assert pipe["stages"] == 2 and pipe["microbatches"] == 4
    assert pipe["bubble_fraction"] == pytest.approx(1 / 5)
    assert pipe["bf16"]["bitwise_equal_per_microbatch"]
    assert pipe["float32"]["bitwise_equal_per_microbatch"]
    assert pipe["float32"]["max_abs_diff_vs_batched"] <= \
        pipe["float32"]["tol"]
    el = rec["elastic"]
    assert el["saved_on"] == [1, 2] and el["restored_on"] == [2, 1]
    assert el["step"] == 1 and el["leaves_restored_bitwise"] > 0


def test_family_gates_reject_dropped_model_reductions(two_ranks):
    for rec in (r["faults"] for r in two_ranks):
        assert "mamba2-2.7b-smoke mesh gate" in rec["mamba2-2.7b"], rec
        assert "deepseek-moe-16b-smoke mesh gate" in \
            rec["deepseek-moe-16b"], rec


def _deepseek_record(peaks: list) -> dict:
    return {"mesh": [2, 2], "moe_full_depth": {
        "arch": "deepseek-moe-16b",
        "trace": list(cs.mesh_moe_key((2, 2))),
        "per_rank": [{"peak_bytes": p, "temp_bytes": t}
                     for p, t in peaks]}}


def test_trace_reading_holds_the_four_card_moe_step():
    """A deepseek-shaped trace (the full-depth step's figures before the
    chunked update: 40.94 GB of arguments, 28.12 GB of temporaries a
    card) against per-rank readings."""
    args, temp = 40_940_000_000, 28_120_000_000
    key = cs.mesh_moe_key((2, 2))
    assert key == ("2x2", "deepseek-moe-16b", '["train", 4, 2048]')
    traces = {key: {"status": "ok", "memory": {
        "argument_size_in_bytes": args, "temp_size_in_bytes": temp},
        "cost": {"flops": 1.0}, "collectives": {}, "trace_s": 1.0}}
    near = [(int((args + temp) * f), int(temp * g))
            for f, g in ((1.05, 0.95), (0.93, 1.08), (1.0, 1.0),
                         (1.09, 0.92))]
    out = cs.trace_reading(traces, cs.families_held(_deepseek_record(near)))
    assert len(out["held"]) == 4
    assert all(abs(h["traced_over_measured"] - 1) <= 0.1
               for h in out["held"].values())
    for bad in ((int((args + temp) * 1.12), temp),
                (args + temp, int(temp * 0.85))):
        with pytest.raises(cs.SmokeFailure, match="full depth on 2x2"):
            cs.trace_reading(traces, cs.families_held(
                _deepseek_record(near[:3] + [bad])))
    # the dry-run phase reads the families' steps beside its own
    assert set(cs.families_held(_deepseek_record(near))) <= set(
        cs.held_steps(("mamba2-2.7b", "long_500k"), None, None, None,
                      families=_deepseek_record(near)))


def test_start_traces_adds_the_moe_step_on_four_cards(monkeypatch):
    from repro_torch.launch import trace

    started = {}

    def fake_start(cells, **kw):
        started[json.dumps(kw.get("sizes") or kw.get("mesh"))] = cells
        return None

    monkeypatch.setattr(trace, "start", fake_start)
    monkeypatch.setattr(cs.atexit, "register", lambda *a: None)
    for cards, want in ((1, False), (4, True)):
        started.clear()
        cs.start_traces(cs.mesh_shape(cards))
        cells = started.get("[2, 2]", [])
        assert (["deepseek-moe-16b", ["train", 4, 2048]] in cells) == want


def test_sweep_oracle_pool_rejects_a_record_off_by_one_ulp():
    from repro_torch.core import flow

    suites = {"vtr": circuits.vtr_suite(scale=0.3)[:1]}
    archs = arch_grid()[:2]
    res = flow.sweep_architectures(suites, archs=archs, backend="numpy")
    row = res.records[0][1]
    row["critical_path_ps"] = np.nextafter(row["critical_path_ps"], 0.0)
    # one circuit: one worker process
    assert not cs.oracle_parity_pool(res, suites, archs)
