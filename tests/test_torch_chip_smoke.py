"""``chip_smoke.py``'s phases, rehearsed on the CPU at tiny sizes (the GPU
phases — the build and the kernel parity — run only on the card)."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import circuits  # noqa: E402
from repro_torch.core.stress import packing_stress_circuit  # noqa: E402
CPU = torch.device("cpu")


def test_phase_functions_importable():
    for name in ("main", "kernel_parity", "time_ms", "lut_bound_ms",
                 "phase_flow", "phase_suite_eval", "phase_profile",
                 "phase_equiv",
                 "phase_levels", "main_path_shapes", "full_suites",
                 "fig9_workload", "card_line"):
        assert callable(getattr(cs, name)), name


def test_main_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script exits non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bounds():
    b = cs.lut_bound_ms(2330, 6, 4096, 2)
    assert b["bytes"] == 4 * (2330 * 6 * 4096 + 2330 * 2 + 2330 * 4096)
    assert b["ops"] == 2330 * 4096 * 63
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])
    assert 0.07 < b["bound_ms"] < 0.09


def test_phases_rehearsed_on_cpu():
    nets = circuits.vtr_suite(scale=0.3)[:3]
    rec = cs.phase_flow({"vtr": nets[:2]}, CPU)
    assert set(rec["geomean_ratios_vs_baseline"]["vtr"]) == {"dd5", "dd6"}
    lanes = cs.suite_lanes(nets, 2)
    rec = cs.phase_suite_eval(nets, lanes, 2, CPU, n_oracle_words=2)
    assert rec["circuits"] == 3 and rec["launches"]["grouped"] == \
        {"lut_eval6": 0, "lut_eval": 0}
    assert set(rec["lut_eval6_launches_per_circuit"]) == \
        {n.name for n in nets}
    rec = cs.phase_profile(nets, lanes, 2, CPU)
    assert rec["device_busy_ms"] == 0 and rec["host_self_ms_by_name"]
    rec = cs.phase_equiv(nets[:2], CPU, n_vectors=64)
    assert all(c["equivalent"] for c in rec["circuits"])
    stress = packing_stress_circuit(n_adders=20, n_luts=20, depth=2)
    rec = cs.phase_levels(stress, 2, CPU)
    assert rec["net"] == stress.name
    shapes = cs.main_path_shapes(nets, stress)
    assert shapes["lut_eval6"][1] == cs.N_LANE_WORDS
    assert 1 <= shapes["lut_eval"][1] <= 5


def test_check_raises():
    with pytest.raises(cs.SmokeFailure):
        cs.check(False, "boom")
    cs.check(True, "fine")
    assert cs.geomean([2.0, 8.0]) == pytest.approx(4.0)
    assert np.isclose(cs.geomean([1.0]), 1.0)
