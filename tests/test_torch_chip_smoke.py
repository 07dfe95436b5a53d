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
from repro_torch.core import anneal, circuits  # noqa: E402
from repro_torch.core.stress import packing_stress_circuit  # noqa: E402
CPU = torch.device("cpu")


def test_phase_functions_importable():
    for name in ("main", "kernel_parity", "time_ms", "lut_bound_ms",
                 "phase_flow", "phase_suite_eval", "phase_profile",
                 "phase_equiv",
                 "phase_levels", "main_path_shapes", "full_suites",
                 "fig9_workload", "card_line", "lm_kernel_parity",
                 "flash_parity", "bitplane_parity", "flash_bound_ms",
                 "bitplane_bound_ms", "phase_serve", "phase_quantized",
                 "phase_profile_serve", "profile_summary", "sdpa_backend",
                 "ssm_kernel_parity", "ssd_parity", "popcount_parity",
                 "ssd_bound_ms", "popcount_bound_ms", "ssd_inputs",
                 "unpack_signs", "forward_gate", "forward_timed",
                 "phase_ssm", "phase_profile_ssm", "cast_params",
                 "forward_gate_bf16", "drop_diagonal", "check_mma_ref",
                 "at_p_block", "first_layers", "lut_sass_counts",
                 "widest_grouped_level", "level_parity", "random_level",
                 "lut_eval6_launches_grouped", "cost_model_reading",
                 "check_lut_sass", "level_rows_once_bound",
                 "phase_sweep", "phase_sweep_placed", "phase_search",
                 "stable_payload", "phase_placement_ensembles",
                 "phase_serve_flow", "serve_pool", "edit_stream",
                 "flash_grad_parity", "phase_flash_backward",
                 "flash_backward_bound_ms", "train_model_flops",
                 "train_gate", "train_timed", "train_resume",
                 "phase_train", "phase_profile_train", "train_shape_inputs",
                 "train_forward_parity", "route_recorder",
                 "routing_agreement", "params_bytes", "cut_depth",
                 "check_timed_variants", "phase_serve_moe", "int8_gate",
                 "phase_serve_moe_int8", "phase_serve_vlm",
                 "forward_gate_inputs_bf16", "phase_serve_encdec",
                 "tied_router_rows", "lowest_index_topk", "phase_moe_topk",
                 "sample_positions", "call_recorder", "chunked_gate",
                 "phase_serve_chunked", "pipeline_run", "phase_pipeline",
                 "phase_dryrun", "mesh_shape", "mesh_gate", "mesh_timed",
                 "mesh_train_rank", "phase_mesh_train", "step_gate",
                 "gate_step", "host_gate", "phase_train_family",
                 "family_timed", "train_attention_timing",
                 "resume_check"):
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


def _sass(per_word: float) -> dict:
    return {"vec": 4, "lop3": per_word * 8, "instructions": 800,
            "words_per_thread": 8, "lop3_per_word": per_word}


@pytest.mark.parametrize("counts, ok", [
    ({"lut_eval6_kernel<4>": 63.25, "lut_eval6_level_kernel<4>": 63.25},
     True),
    ({"lut_eval6_kernel<4>": 63.0, "lut_eval6_level_kernel<4>": 66.0}, True),
    # a sum of products (~260 logic ops per word) fails
    ({"lut_eval6_kernel<4>": 260.0, "lut_eval6_level_kernel<4>": 63.25},
     False),
    # a tree the compiler cut short fails
    ({"lut_eval6_kernel<4>": 63.25, "lut_eval6_level_kernel<4>": 40.0},
     False),
    # a kernel the reading did not find fails
    ({"lut_eval6_kernel<4>": 63.25}, False),
    ({}, False),
])
def test_check_lut_sass(counts, ok):
    sass = {name: _sass(v) for name, v in counts.items()}
    if ok:
        cs.check_lut_sass(sass)
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.check_lut_sass(sass)


def test_level_bound_counts_what_the_data_needs():
    """The level's data bound reads each distinct row of a LUT with a
    table other than 0 once, writes each distinct output row once, and
    charges the tree's operations to those LUTs only; the [M, 6, N]
    figure counts every pin row."""
    ins = torch.tensor([[2, 3, 3, 4, 0, 0], [2, 2, 5, 5, 5, 0],
                        [0] * 6, [0] * 6])
    level = {"luts": 4, "ins": ins, "out": torch.tensor([6, 7, 9, 9]),
             "tt_lo": torch.tensor([5, 0, 0, 0], dtype=torch.int32),
             "tt_hi": torch.tensor([0, 1, 0, 0], dtype=torch.int32)}
    b = cs.level_rows_once_bound(level, 1024)
    assert b["nonzero_tables"] == 2
    assert b["rows_read"] == 5 and b["rows_written"] == 3
    assert b["bytes"] == 4 * 1024 * (5 + 3) + 8 * 4
    assert b["ops_ms"] == cs.lut_bound_ms(2, 6, 1024, 2)["ops_ms"]
    assert b["bound_ms"] == max(b["bytes_ms"], b["ops_ms"])
    assert b["bound_ms"] < cs.lut_bound_ms(4, 6, 1024, 2)["bound_ms"]


def test_phases_rehearsed_on_cpu():
    nets = circuits.vtr_suite(scale=0.3)[:3]
    rec = cs.phase_flow({"vtr": nets[:2]}, CPU)
    assert set(rec["geomean_ratios_vs_baseline"]["vtr"]) == {"dd5", "dd6"}
    lanes = cs.suite_lanes(nets, 2)
    rec = cs.phase_suite_eval(nets, lanes, 2, CPU, n_oracle_words=2)
    assert rec["circuits"] == 3 and rec["launches"]["grouped"] == \
        {"lut_eval6": 0, "lut_eval": 0, "flash_attention": 0,
         "bitplane_matmul": 0, "ssd_scan": 0, "popcount_matmul": 0}
    assert set(rec["lut_eval6_launches_per_circuit"]) == \
        {n.name for n in nets}
    assert rec["variants"]["grouped"] == {"op": 0, "level": 0}
    assert rec["lut_eval6_launches_planned"]["grouped"] > 0
    model = rec["cost_model"]
    assert model["backend"] == "cpu" and model["faster"] in \
        ("grouped", "per_circuit")
    assert model["pick_is_faster"] == (model["pick"] == model["faster"])
    rec = cs.phase_profile(nets, lanes, 2, CPU)
    assert rec["device_busy_ms"] == 0 and rec["host_self_ms_by_name"]
    assert rec["copy_ms"] == 0 and rec["device_kernel_launches"] == 0
    rec = cs.phase_equiv(nets[:2], CPU, n_vectors=64)
    assert all(c["equivalent"] for c in rec["circuits"])
    stress = packing_stress_circuit(n_adders=20, n_luts=20, depth=2)
    rec = cs.phase_levels(stress, 2, CPU)
    assert rec["net"] == stress.name
    shapes = cs.main_path_shapes(nets, stress)
    assert shapes["lut_eval6"][1] == cs.N_LANE_WORDS
    assert 1 <= shapes["lut_eval"][1] <= 5


def test_sweep_and_search_phases_rehearsed_on_cpu():
    """The CAD scale-out phases on two small circuits: the sweep's gates
    (numpy, oracle, the flow phase's records) and the placed sweep's
    pass, and the search over a 12-point subgrid agrees across backends
    with its winners verified (nothing launches on the CPU)."""
    from repro_torch.core.alm import full_arch_grid, subgrid

    suites = {"vtr": circuits.vtr_suite(scale=0.3)[:2]}
    frec = cs.phase_flow(suites, CPU)
    rec, unplaced = cs.phase_sweep(suites, CPU, frec)
    assert rec["equal_numpy"] and rec["oracle_parity"]
    assert len(rec["archs"]) == 7 and rec["structural_classes"] == 5
    assert rec["programs_built"]["cold"] > 0
    assert rec["profile_warm"]["device_busy_ms"] == 0
    assert {r["arch"] for r in rec["frontier"]} == set(rec["archs"]) - {"b0"}
    placed = cs.phase_sweep_placed({"vtr": suites["vtr"][1:]}, CPU,
                                   unplaced["result"], unplaced["packs"])
    # the canonical rows under both wire profiles
    assert len(placed["archs"]) == 6 and placed["circuits"] == 1
    assert placed["zero_wire_rows_equal_unplaced"] == \
        list(cs.CANONICAL_ROWS.values())
    assert placed["wall_split"]["place_s"] >= \
        placed["wall_split"]["anneal_s"] > 0
    srec = cs.phase_search(suites, CPU, archs=subgrid(full_arch_grid(), 12),
                           params={"budget": 200, "eta": 4,
                                   "min_survivors": 4})
    assert srec["equal_backends"] and srec["verify"]["equivalent"]
    assert srec["verify"]["oracle_match"]
    assert [r["net"] for r in srec["winner_simulated"]] == \
        sorted((n.name for n in suites["vtr"]),
               key=lambda name: next(n.n_luts + n.n_adders
                                     for n in suites["vtr"]
                                     if n.name == name))
    assert srec["launches"] == {"lut_eval6": 0}
    assert srec["budget_ledger"]["used"] <= 200


def test_placement_ensembles_phase_rehearsed_on_cpu():
    """The ensemble phase on two small Kratos circuits: every gate of
    every case passes, and each backend's wall, wirelengths and profiled
    largest case are read (nothing launches on the CPU)."""
    suites = {"kratos": [n for n in circuits.kratos_suite(scale=0.3)
                         if n.name in ("conv1d-pw-fu", "fc-fu")]}
    rec = cs.phase_placement_ensembles(suites, CPU, archs=("dd5",),
                                       workers=2)
    assert rec["workers"] == 2
    assert rec["circuits"] == 2 and len(rec["cases"]) == 2
    for case in rec["cases"]:
        assert case["relax_max_abs_err"] <= cs.RELAX_TOL
        assert case["anneal"]["cost_rel_err"] == 0.0
        assert case["anneal_timing"]["cost_rel_err"] <= 1e-12
        for mode in ("anneal", "anneal_timing"):
            assert case[mode]["objective"] <= case[mode]["seed_objective"]
            assert len(case[mode]["chain_costs"]) == anneal.CHAINS
            assert case[mode]["torch_place_s"] > 0
        assert case["anneal"]["wirelength"] <= case["seed_wirelength"]
        assert "final" not in case
    assert rec["largest"]["lbs"] == max(c["lbs"] for c in rec["cases"])
    for backend in ("torch", "numpy"):
        for mode in ("anneal", "anneal_timing"):
            reading = rec["largest"][f"{backend}/{mode}"]
            assert reading["wall_ms"] > 0 and reading["wirelength"] > 0
            assert reading["device_kernel_launches"] == 0
    assert rec["totals"]["anneal"]["numpy_chains_pool_s"] > 0


def test_serve_flow_phase_rehearsed_on_cpu():
    """The flow-server phase at a tiny size: 8 requests over a two-circuit
    pool, eval of two circuits at 2 lane words, a 3-edit stream; every
    gate passes with both timing backends."""
    from repro_torch.core.circuits import kratos_gemm

    pool = cs.serve_pool(smoke=True)
    assert len(pool) == 4 and len(cs.serve_pool()) == 12
    rec = cs.phase_serve_flow(
        CPU, pool=pool, n_requests=8, client_counts=(4,),
        eval_nets=circuits.vtr_suite(scale=0.3)[:2], n_lane_words=2,
        edit_net=kratos_gemm(m=5, n=5, width=5, sparsity=0.5), n_edits=3)
    assert rec["equal_serial"] and rec["equal_backends"]
    assert set(rec["coalescing"]) == {f"{b}/clients4/{t}"
                                      for b in ("torch", "numpy")
                                      for t in ("cold", "warm")}
    for reading in rec["coalescing"].values():
        assert reading["n_batches"] >= 1 and reading["p99_ms"] >= \
            reading["p50_ms"] > 0
        assert set(reading["wall_split"]) == set(cs._SERVE_WALLS)
    assert rec["eval"]["circuits"] == 2
    assert rec["eval"]["torch"]["wall_split"]["eval_s"] > 0
    assert rec["launches"] == {"lut_eval6": 0}
    for backend in ("torch", "numpy"):
        edits = rec["edit_stream"][backend]
        assert edits["n_incremental"] >= 1
        assert [e["kind"] for e in edits["edits"]] == \
            ["rewire_fanin", "rewire_fanin", "lut_tt"]


def test_sweep_phase_rejects_a_wrong_flow_record():
    """The paper-row gate fails when a flow record differs from the
    sweep's row in its last bit."""
    suites = {"vtr": circuits.vtr_suite(scale=0.3)[:1]}
    frec = cs.phase_flow(suites, CPU)
    net = suites["vtr"][0].name
    cp = frec["records"][net]["dd5"]["critical_path_ps"]
    frec["records"][net]["dd5"]["critical_path_ps"] = np.nextafter(cp, 0.0)
    with pytest.raises(cs.SmokeFailure, match="b2_f10"):
        cs.phase_sweep(suites, CPU, frec)


def test_level_parity_rehearsed_on_cpu():
    """The level variant's parity inputs on the CPU (both sides run the
    plain version here): the widest grouped level of a small suite, and
    random levels laid out as the planner lays one out."""
    nets = circuits.vtr_suite(scale=0.3)
    level = cs.widest_grouped_level(nets, CPU)
    M = level["luts"]
    assert level["ins"].shape == (M, 6) and level["out"].shape == (M,)
    assert 0 < level["real_luts"] <= M
    assert int(level["ins"].max()) < level["rows"]
    assert int(level["out"].max()) < level["rows"]
    # no pin of the level reads a row the level writes
    assert not set(level["ins"].flatten().tolist()) & \
        set(level["out"].tolist())
    errs = cs.level_parity(CPU, level, cases=[(100, 20, 3)], n_words=2)
    assert set(errs.values()) == {0} and len(errs) == 3
    rng = np.random.default_rng(0)
    vals, ins, lo, hi, out = cs.random_level(rng, 50, 10, 3, CPU,
                                             unaligned=True)
    pad = out == 49
    assert pad.sum() == 2 and (ins[pad] == 0).all() and (lo[pad] == 0).all()
    assert not set(ins.flatten().tolist()) & set(out[~pad].tolist())
    assert vals[0].eq(0).all() and vals[1].eq(-1).all()


def test_check_raises():
    with pytest.raises(cs.SmokeFailure):
        cs.check(False, "boom")
    cs.check(True, "fine")
    assert cs.geomean([2.0, 8.0]) == pytest.approx(4.0)
    assert np.isclose(cs.geomean([1.0]), 1.0)


def test_lm_bounds():
    # causal tail queries: S = T gives the triangle, one tail query all keys
    assert cs.visible_pairs(4, 4, True, None) == 10
    assert cs.visible_pairs(1, 9, True, None) == 9
    assert cs.visible_pairs(4, 4, False, None) == 16
    assert cs.visible_pairs(5, 5, True, 2) == 9
    assert cs.visible_pairs(3, 5, False, 2) == 4 + 3 + 2
    assert cs.visible_pairs(6, 6, True, cs.HUGE_WINDOW) == 21
    b = cs.flash_bound_ms(8, 12, 12, 512, 512, 64, 2, True, cs.HUGE_WINDOW)
    assert b["flops"] == 4 * 8 * 12 * (512 * 513 // 2) * 64
    assert b["bytes"] == 2 * (2 * 8 * 12 * 512 * 64 + 2 * 8 * 12 * 512 * 64)
    assert b["bound_ms"] == max(b["ops_ms"], b["bytes_ms"])
    b = cs.bitplane_bound_ms(4096, 768, 4096, 6)
    assert b["fp32_flops"] == 2 * 4096 * 768 * 4096
    assert b["fp32_bound_by"] == "operations"
    assert 0.38 < b["fp32_bound_ms"] < 0.39
    b = cs.bitplane_bound_ms(8, 768, 4096, 6)
    assert b["bound_by"] == "bytes" and 0.022 < b["bound_ms"] < 0.023


def test_lm_kernel_parity_rehearsed_on_cpu():
    err = cs.flash_parity(CPU, dims=(16, 32))
    assert set(err) == {"float32", "bfloat16"}
    assert cs.bitplane_parity(CPU, cases=cs.BITPLANE_CASES[:6]) == 0.0
    planes, scale = cs.quantized_planes(torch.Generator().manual_seed(0),
                                        64, 32, 6, CPU)
    assert planes.shape == (6, 64, 32) and scale.shape == (32,)
    assert all(len(c) == 12 for c in cs.FLASH_MAIN)


@pytest.mark.parametrize("B,Hq,Hkv,S,T,causal,window", [
    (2, 10, 2, 40, 40, True, 16),      # hymba's local prefill, G 5
    (3, 10, 2, 1, 70, True, 16),       # its local decode
    (3, 10, 2, 1, 70, True, 1 << 30),  # its global decode
    (2, 4, 4, 24, 24, True, None),     # a causal prefill: is_causal
    (1, 4, 2, 5, 30, True, None),      # tail queries, S < T
    (2, 4, 1, 30, 30, False, 8)])      # a window, not causal
def test_sdpa_call_computes_the_kernels_function(B, Hq, Hkv, S, T, causal,
                                                 window):
    """The library yardstick of ``lm_kernel_parity``: SDPA with the window
    as a boolean mask and ``enable_gqa`` gives the plain attention's
    output (the queries at the tail of the keys); none with softcap."""
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((B, h, n, 16), generator=gen)
               for h, n in ((Hq, S), (Hkv, T), (Hkv, T)))
    want = ops.flash_attention(q, k, v, causal=causal, window=window,
                               use_kernel=False)
    got = cs.sdpa_call(q, k, v, causal, window, None)()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert cs.sdpa_call(q, k, v, causal, window, 50.0) is None


def test_serve_phases_rehearsed_on_cpu():
    from repro_torch.configs.base import get_config

    for arch, gate in (("kratos-dd", (2, 12, 3)), ("gemma2-2b", (1, 20, 3))):
        cfg = get_config(arch).smoke()
        rec, params = cs.phase_serve("serve", cfg, CPU, gate=gate,
                                     timed=(2, 10, 3))
        assert rec["gate"]["tokens_identical"]
        assert rec["gate"]["max_abs_logit_diff_vs_forward"] <= cs.SERVE_TOL
        assert rec["timed"]["launches"]["flash_attention"] == 0
        assert rec["flash_launches_expected"] == cfg.n_layers * 3
        prof = cs.phase_profile_serve(cfg, params, 2, 10, CPU)
        assert prof["decode_step"]["device_busy_ms"] == 0
        assert prof["prefill"]["host_self_ms_by_name"]
    q = cs.phase_quantized(cs.as_float32(get_config("kratos-dd").smoke()),
                           CPU, rows=(8, 16))
    assert q["worst_mean_rel_err"] < q["bound"]
    assert set(q["mean_rel_err"]) == {"8", "16"}


def test_ssm_bounds():
    """The SSD bound counts the score tile once per (batch, chunk) (B and
    C are shared by the heads); the binary GEMM's is the int8 tensor-core
    product's, with the __popc figure beside it."""
    b = cs.ssd_bound_ms(2, 4096, 80, 64, 128, 2)
    assert b["flops"] == 2 * 32 * 2 * 128 * 128 * 128 \
        + 2 * 80 * 32 * (2 * 128 * 128 * 64 + 4 * 128 * 64 * 128)
    assert 32e9 < b["flops"] < 33e9 and 0.032 < b["ops_ms"] < 0.033
    assert 172e6 < b["bytes"] < 176e6 and b["bound_by"] == "bytes"
    assert 0.0521 < b["bound_ms"] < 0.0522
    h = cs.ssd_bound_ms(2, 2048, 25, 64, 16, 2)
    assert h["bound_by"] == "bytes" and 0.0080 < h["bound_ms"] < 0.0081
    short = cs.ssd_bound_ms(1, 24, 4, 16, 8, 4)  # one chunk of 24
    assert short["flops"] == 2 * 24 * 24 * 8 + 4 * (2 * 24 * 24 * 16
                                                    + 4 * 24 * 16 * 8)
    p = cs.popcount_bound_ms(4096, 4096, 24)
    assert p["ops"] == 2 * 4096 * 4096 * 32 * 24
    assert p["bytes"] == 4 * (2 * 4096 * 24 + 4096 * 4096)
    assert p["bound_by"] == "bytes" and 0.0202 < p["bound_ms"] < 0.0203
    assert 0.0130 < p["ops_ms"] < 0.0131
    assert p["popc_popcounts"] == 4096 * 4096 * 24
    assert 0.096 < p["popc_bound_ms"] < 0.097


def test_ssm_kernel_parity_rehearsed_on_cpu():
    err = cs.ssd_parity(CPU, cases=cs.SSD_CASES[:2] + cs.SSD_CASES[4:5])
    assert err == {"float32": 0.0, "bfloat16": 0.0}
    assert cs.popcount_parity(CPU, cases=cs.POPCOUNT_CASES[:3]) == 0
    words = torch.tensor([[0b1011, -1]], dtype=torch.int32)
    bits = cs.unpack_signs(words, 40, signed=False)
    assert bits.shape == (1, 40) and bits[0, :4].tolist() == [1, 1, 0, 1]
    signs = cs.unpack_signs(words, 64, signed=True)
    assert signs[0, 31].item() == -1 and signs[0, 32:].eq(1).all()
    # the library yardstick computes the same function on these bits
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    x = cs._random_words(rng, (9, 3), CPU)
    w = cs._random_words(rng, (5, 3), CPU)
    lib = cs.unpack_signs(x, 96, True).float() @ \
        cs.unpack_signs(w, 96, True).float().T
    assert torch.equal(lib.int(), ops.popcount_matmul(x, w, "xnor", 96))


def test_cast_params_keeps_float32_leaves():
    params = {"embed": torch.ones(2), "blocks": {
        "in_proj": torch.ones(2), "dt_bias": torch.ones(2),
        "a_log": torch.ones(2), "d_skip": torch.ones(2)}}
    out = cs.cast_params(params, torch.bfloat16)
    assert out["embed"].dtype == out["blocks"]["in_proj"].dtype == \
        torch.bfloat16
    for name in ("dt_bias", "a_log", "d_skip"):
        assert out["blocks"][name].dtype == torch.float32


@pytest.mark.parametrize("arch,gate,forward,timed", [
    ("mamba2-2.7b", (1, 32, 27, 6), (2, 24), (2, 10, 3)),
    ("hymba-1.5b", (1, 32, 27, 6), (2, 24), (2, 20, 3))])
def test_ssm_phases_rehearsed_on_cpu(arch, gate, forward, timed):
    """The SSM phases at smoke width on the CPU (nothing launches here;
    the expected counts are checked on the card)."""
    from repro_torch.configs.base import get_config

    cfg = get_config(arch).smoke()
    rec, params = cs.phase_ssm("ssm", cfg, CPU, gate=gate, forward=forward,
                               timed=timed)
    assert rec["gate"]["serve"]["tokens_identical"]
    assert rec["gate"]["forward"]["max_abs_logit_diff_vs_plain"] <= \
        cs.SERVE_TOL
    bf16 = rec["gate"]["forward_bf16"]
    assert bf16["max_abs_logit_diff_vs_plain_bf16"] == 0  # one path here
    assert set(bf16["planted_fault"]) >= {"max_abs", "rms", "argmax_flips",
                                          "rejected_by"}
    assert bf16["planted_fault"]["rms"] > 0
    cut = rec["gate"]["forward_bf16_first_layers"]
    assert cut["layers"] == min(cs.BF16_GATE_LAYERS, cfg.n_layers)
    assert cut["planted_fault"]["rms"] > 0
    assert rec["forward"]["tok_per_s"] > 0
    assert rec["launches_expected"]["forward"]["ssd_scan"] == cfg.n_layers
    assert sum(rec["forward"]["launches"].values()) == 0
    prof = cs.phase_profile_ssm(cfg, params, 2, 16, CPU)
    assert prof["decode_step"]["device_busy_ms"] == 0
    assert prof["forward"]["host_self_ms_by_name"]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_first_layers_cuts_depth(arch):
    """The second bf16 gate's model: the first k layers' weights, as
    views, and a config of k layers that the forward runs."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config(arch).smoke()
    params = serve.make_params(cfg, CPU, seed=0)
    cut_cfg, cut = cs.first_layers(cfg, params, 1)
    assert cut_cfg.n_layers == 1 and cfg.n_layers == 2
    for name, v in cut["blocks"].items():
        assert v.shape[0] == 1 and v.data_ptr() == \
            params["blocks"][name].data_ptr()
    toks = serve.make_inputs(cut_cfg, 1, 8, CPU, seed=0)[0]
    logits = lm.forward(cut_cfg, cut, toks, use_kernel=False)[0]
    assert logits.shape == (1, 8, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_train_bounds():
    """Model FLOPs of a tinyllama-1.1b step at B 4 x S 2048: 6 per weight
    (the unembedding's included, the embedding's gather not) and token,
    and causal attention's 6 L (Hq D) S per token; the fused backward's
    bound is ten D-wide products per visible pair."""
    from repro_torch.configs.base import get_config

    cfg = get_config("tinyllama-1.1b")
    per_layer = 2048 * 2048 * 2 + 2048 * 256 * 2 + 2048 * 11264 \
        + 5632 * 2048
    n = 22 * per_layer + 2048 * 32000
    tokens = 4 * 2048
    assert cs.train_model_flops(cfg, 4, 2048) == \
        6 * n * tokens + 6 * 22 * 2048 * 2048 * tokens
    assert 5.4e13 < cs.train_model_flops(cfg, 4, 2048) < 5.6e13
    b = cs.flash_backward_bound_ms(4, 32, 4, 2048, 2048, 64, 2)
    f = cs.flash_bound_ms(4, 32, 4, 2048, 2048, 64, 2, True, None)
    assert b["flops"] == 10 * f["flops"] // 4
    assert b["bound_by"] == f["bound_by"] == "operations"
    assert cs.TRAIN_ATTN == (4, cfg.n_heads, cfg.n_kv_heads, 2048, 2048,
                             cfg.hd)


def test_flash_grad_parity_rehearsed_on_cpu():
    cases = [c for c in cs.FLASH_GRAD_CASES if c[6] == 16]
    assert {c[0] for c in cases} >= {"causal", "tail_ragged_window",
                                     "gqa5_prefill"}
    assert not any(c[4] == 1 for c in cs.FLASH_GRAD_CASES)  # no decode
    assert cs.FLASH_GRAD_CASES[-1][6] == 256
    rec = cs.flash_grad_parity(CPU, cases=cases[:5])
    assert rec["cases"] == 10
    assert rec["max_abs_err"] == {"float32": 0.0, "bfloat16": 0.0}


@pytest.mark.parametrize("route", ["kernel", "autograd route"])
def test_train_forward_parity_rejects_a_wrong_forward(monkeypatch, route):
    """The flash forward at the training shape's layout (GQA 8, causal
    over the full window; cut to CPU size) agrees with the plain version
    by both routes, and a forward that maps query heads to the wrong
    output heads in either route fails."""
    from repro_torch.kernels import ops

    q, k, v, g = cs.train_shape_inputs(CPU, (1, 8, 1, 64, 64, 16))
    assert g.shape == q.shape == (1, 8, 64, 16) and k.shape == (1, 1, 64, 16)
    assert q.dtype == torch.bfloat16
    assert cs.train_forward_parity(q, k, v) == 0.0
    real = ops._flash_forward

    def off(q, *a):
        out = real(q, *a)
        wrong = q.requires_grad == (route != "kernel")
        return out.roll(1, dims=1) if wrong else out

    monkeypatch.setattr(ops, "_flash_forward", off)
    with pytest.raises(cs.SmokeFailure, match=f"the {route}'s forward"):
        cs.train_forward_parity(q, k, v)


def _train_rehearsal(tmp_path, **kw):
    import dataclasses

    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").smoke(),
                              remat=True)
    return cfg, cs.phase_train("train", cfg, CPU, tmp_path,
                               gate=(1, 2, 64), timed=(6, 2, 32),
                               save_at=3, **kw)


def test_train_phase_rehearsed_on_cpu(tmp_path):
    """The training phase at smoke width on the CPU: the gate's readings,
    the step and launch arithmetic the card checks (2 L flash calls a
    step with remat: forwards and recomputes), the checkpoint resume
    (bit for bit here: the CPU's sums run in one order) and the
    profile."""
    cfg, (rec, prof) = _train_rehearsal(tmp_path)
    gate = rec["gate"]
    assert gate["worst_grad_share_of_tol"] <= 1.0
    assert set(gate["grads"]) == {"embed", "lm_head", "ln_f"} | {
        f"blocks/{k}" for k in ("ln1", "wq", "wk", "wv", "wo", "ln2", "wi",
                                "wo_ff")}
    assert all(r["tol"] >= cs.TRAIN_TOL for r in gate["grads"].values())
    assert 0 < gate["loss"]["plain_vs_float64"] < 1e-6
    assert rec["flash_launches_expected"] == {
        "gate": 2, "per_step": 2 * cfg.n_layers,
        "timed": 2 * cfg.n_layers * 6}
    timed = rec["timed"]
    assert len(timed["per_step"]) == 6 and timed["tok_per_s"] > 0
    assert [r["flash_launches"] for r in timed["per_step"]] == [0] * 6
    ck = timed["checkpoint"]
    assert ck["resumed_equal_bitwise"] and len(ck["resumed_losses"]) == 3
    assert (ck["saved_at"], ck["restored_at"]) == (3, 6)
    assert ck["uninterrupted_losses"] == timed["losses"][3:]
    assert ck["leaves_restored_bitwise"] == 3 * 11 + 1  # params, mu, nu
    assert not any(tmp_path.iterdir())  # the checkpoints are removed
    assert prof["attention_backward_recompute_calls"] == cfg.n_layers
    assert prof["optimizer"]["leaves"] == 11


def test_train_gate_rejects_a_wrong_backward(monkeypatch):
    """A flash backward whose dq is 1 % off fails the float32 gate."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops

    real = ops.FlashAttentionFn.backward

    def off(ctx, g):
        dq, *rest = real(ctx, g)
        return (dq * 1.01, *rest)

    monkeypatch.setattr(ops.FlashAttentionFn, "backward", staticmethod(off))
    with pytest.raises(cs.SmokeFailure, match="train gate"):
        cs.train_gate(get_config("tinyllama-1.1b").smoke(), CPU, 1, 2, 64)


# ---------------------------------------------------------------------------
# the MoE, vlm and encdec families and the int8 cache
# ---------------------------------------------------------------------------

MOE_GATE, SMALL_TIMED = (2, 12, 4), (2, 10, 3)


def _bf16(cfg):
    import dataclasses

    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def test_moe_phases_rehearsed_on_cpu():
    """serve_moe (the gates over the cut depth, routing recorded; the
    timed run at full depth), its profile with the dropless products as a
    range, and serve_moe_int8 on the same weights, at smoke width."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import blocks

    cfg = _bf16(get_config("deepseek-moe-16b").smoke())
    rec, state = cs.phase_serve_moe(cfg, CPU, gate=MOE_GATE,
                                    timed=SMALL_TIMED)
    assert rec["gate_layers"] == min(cs.MOE_GATE_LAYERS, cfg.n_layers)
    assert rec["gate"]["tokens_identical"]
    for gate in (rec["gate"], rec["gate_bf16"]):
        routing = gate["routing"]
        assert routing["agree_share"] == 1.0 and routing["choices"] > 0
        assert 0 < routing["min_topk_margin"] < 1
    assert rec["timed"]["tok_per_s"] > 0
    assert rec["flash_launches_expected"] == cfg.n_layers * SMALL_TIMED[2]
    assert state["params"]["blocks"]["we_i"].dtype == torch.bfloat16
    prof = cs.phase_profile_serve(cfg, state["params"], 2, 10, CPU,
                                  ranges=(blocks.EXPERTS_RANGE,))
    assert prof["prefill"]["ranges"][blocks.EXPERTS_RANGE]["calls"] == \
        cfg.n_layers - cfg.n_dense_layers
    i8 = cs.phase_serve_moe_int8(cfg, state, CPU, gate=MOE_GATE,
                                 timed=SMALL_TIMED)
    assert i8["gate"]["max_abs_logit_diff_vs_plain"] <= cs.SERVE_TOL
    assert i8["gate"]["prefill_codes_max_abs_move"] <= 1
    # 1 byte a code and 4 a (token, head) scale against 2 bytes a value
    assert i8["vs_bf16_cache"]["cache_bytes_ratio"] == \
        (cfg.hd + 4) / (2 * cfg.hd)
    assert 0 <= i8["vs_bf16_cache"]["greedy_agreement"] <= 1
    assert i8["timed"]["tok_per_s"] > 0


def test_vlm_and_encdec_phases_rehearsed_on_cpu():
    from repro_torch.configs.base import get_config

    vlm = _bf16(get_config("llava-next-34b").smoke())
    rec = cs.phase_serve_vlm(vlm, CPU, gate=(1, 6, 3), timed=(1, 6, 3))
    assert rec["layers"] == vlm.n_layers
    assert rec["flash_launches_expected"] == vlm.n_layers * 3
    assert rec["gate"]["patch_embeds"] == [1, vlm.n_patches, vlm.d_model]
    assert rec["gate"]["tokens_identical"]
    assert rec["timed"]["patch_embeds"] == [1, vlm.n_patches, vlm.d_model]
    enc = _bf16(get_config("whisper-small").smoke())
    rec = cs.phase_serve_encdec(enc, CPU, gate=(2, 8, 4), forward=(2, 24),
                                timed=(2, 8, 4))
    assert rec["gate"]["encoder_feats"] == [2, enc.encoder_seq, enc.d_model]
    assert rec["gate"]["max_abs_logit_diff_vs_forward"] <= cs.SERVE_TOL
    fwd = rec["forward_bf16"]
    assert fwd["max_abs_logit_diff_vs_plain_bf16"] <= fwd["tol"]
    assert rec["flash_launches_expected"] == enc.n_encoder_layers + \
        enc.n_layers * 4


def test_check_timed_variants():
    run = {"variants": {"flash_attention": {"mma": 0, "split": 5,
                                            "tf32x3": 2}},
           "launches": {"flash_attention": 7}}
    cs.check_timed_variants("x", run, {"split": 5, "tf32x3": 2})
    for want in ({"split": 7}, {"split": 5, "tf32x3": 2, "mma": 1}):
        with pytest.raises(cs.SmokeFailure):
            cs.check_timed_variants("x", run, want)


def test_routing_agreement_counts_choices():
    a = [(torch.tensor([[0, 1], [2, 3]]), torch.tensor([0.2, 0.05]), None)]
    b = [(torch.tensor([[0, 1], [2, 4]]), torch.tensor([0.1, 0.3]), None)]
    r = cs.routing_agreement(a, b)
    assert r == {"routing_calls": 1, "choices": 4, "agree_share": 0.75,
                 "min_topk_margin": pytest.approx(0.05)}
    assert cs.routing_agreement([], []) is None
    with pytest.raises(cs.SmokeFailure):
        cs.routing_agreement(a, [])


def test_route_replay_forces_another_runs_choices():
    """Replaying a run's routing gives its choices (and the gates at
    them) to a run whose router would choose otherwise."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import blocks, lm

    cfg = get_config("deepseek-moe-16b").smoke()
    params = serve.make_params(cfg, CPU, seed=0)
    toks = serve.make_inputs(cfg, 2, 8, CPU, seed=0)[0]
    with cs.route_recorder() as first:
        want = lm.forward(cfg, params, toks)[0]
    other = {**params, "blocks": {**params["blocks"],
                                  "router": -params["blocks"]["router"]}}
    with cs.route_recorder() as free:
        own = lm.forward(cfg, other, toks)[0]
    assert cs.routing_agreement(free, first)["agree_share"] < 0.9
    with cs.route_recorder(first) as forced:
        got = lm.forward(cfg, other, toks)[0]
    # the records keep the choices the run would have made
    assert cs.routing_agreement(forced, free)["agree_share"] == 1.0
    assert not torch.equal(got, own)
    with cs.route_recorder(first):
        same = lm.forward(cfg, params, toks)[0]
    assert torch.equal(same, want)
    assert blocks._moe_route.__name__ == "_moe_route"


def _kernel_route_flag(monkeypatch):
    """Track which route the last self-attention took (the kernel route's
    faults below act only on it, as a kernel's would)."""
    from repro_torch.models import blocks

    state = {"kernel": False}
    attention = blocks.attention

    def tracked(cfg, q, k, v, **kw):
        state["kernel"] = kw.get("use_kernel", True)
        return attention(cfg, q, k, v, **kw)

    monkeypatch.setattr(blocks, "attention", tracked)
    return state


def _plant(monkeypatch, fault: str):
    """A fault on the kernel route only:

    - ``renorm``: the MoE gates not renormalised over the top k;
    - ``int8_scale``: the int8 cache dequantized with scales one code off
      (max / 126 for max / 127);
    - ``softmax_scale``: the flash call's softmax scale 1.25 x too large;
    - ``encoder_causal``: the non-causal (encoder) flash calls causal."""
    import torch as th

    from repro_torch.kernels import ops
    from repro_torch.models import blocks

    if fault == "renorm":
        state = _kernel_route_flag(monkeypatch)
        route = blocks._moe_route

        def unnormalised(cfg, p, ht):
            probs, gates, onehot = route(cfg, p, ht)
            if state["kernel"]:
                gates = th.topk(probs, cfg.top_k, dim=-1).values
            return probs, gates, onehot

        monkeypatch.setattr(blocks, "_moe_route", unnormalised)
    elif fault == "int8_scale":
        cached = blocks._cached_kv

        def off(cache, end, dtype):
            if end is None or "k_scale" not in cache:
                return cached(cache, end, dtype)
            bumped = {**cache, "k_scale": cache["k_scale"] * (127 / 126),
                      "v_scale": cache["v_scale"] * (127 / 126)}
            return cached(bumped, end, dtype)

        monkeypatch.setattr(blocks, "_cached_kv", off)
    else:
        flash = ops.flash_attention

        def faulty(q, k, v, causal=True, window=None, softcap=None,
                   scale=None, use_kernel=True):
            if fault == "softmax_scale":
                scale = 1.25 * q.shape[-1] ** -0.5
            elif not causal:
                causal = True
            return flash(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale, use_kernel=use_kernel)

        monkeypatch.setattr(ops, "flash_attention", faulty)


def _gate_case(gate: str):
    """(run the gate, the fault it must reject) at smoke width."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    arch = {"moe": "deepseek-moe-16b", "moe_bf16": "deepseek-moe-16b",
            "int8": "deepseek-moe-16b", "vlm": "llava-next-34b",
            "vlm_bf16": "llava-next-34b", "encdec": "whisper-small",
            "encdec_bf16": "whisper-small",
            "encdec_forward": "whisper-small"}[gate]
    cfg = _bf16(get_config(arch).smoke())
    if gate == "int8":
        import dataclasses

        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    cfg32 = cs.as_float32(cfg)
    params32 = serve.make_params(cfg32, CPU, seed=0)
    params = cs.cast_params(params32, torch.bfloat16)
    args = (1, 12, 4) if gate.startswith("vlm") else (2, 12, 4)
    run = {"moe": lambda: cs.serve_gate(cfg32, params32, *args, CPU),
           "vlm": lambda: cs.serve_gate(cfg32, params32, *args, CPU),
           "encdec": lambda: cs.serve_gate(cfg32, params32, *args, CPU),
           "int8": lambda: cs.int8_gate(cfg32, params32, *args, CPU),
           "encdec_forward": lambda: cs.forward_gate_inputs_bf16(
               cfg, params, 2, 24, CPU)}.get(
        gate, lambda: cs.serve_gate_bf16(cfg, cfg32, params32, params,
                                         *args, CPU))
    # the bf16 gate replays the float32 run's routing, gates included, so
    # its fault is the kernel's
    fault = {"moe": "renorm", "moe_bf16": "softmax_scale",
             "int8": "int8_scale",
             "vlm": "softmax_scale", "vlm_bf16": "softmax_scale"}.get(
        gate, "encoder_causal")
    return run, fault


GATES = ["moe", "moe_bf16", "int8", "vlm", "vlm_bf16", "encdec",
         "encdec_bf16", "encdec_forward"]


@pytest.mark.parametrize("gate", GATES)
def test_new_gate_rejects_a_planted_fault(monkeypatch, gate):
    """Each gate of the new phases passes on the sound path and fails
    with a fault planted on the kernel route alone."""
    run, fault = _gate_case(gate)
    run()
    _plant(monkeypatch, fault)
    with pytest.raises(cs.SmokeFailure):
        run()
