"""``chip_smoke.py``'s pieces for the kernel variants, rehearsed on the CPU:
the bit-plane tolerance, its fault readings and the bounds, the
forced-token serving run and the bf16 serving gate, and the per-variant
launch checks."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")

@pytest.mark.parametrize("B,atol", [(1, 1e-4), (6, 1e-4), (8, 1e-4),
                                    (9, 2e-4), (10, 4e-4)])
def test_bitplane_atol(B, atol):
    assert cs.bitplane_atol(B) == pytest.approx(atol)


def test_bitplane_design_bound():
    """B <= 8: the bound is the tensor-core design's (3 exact bf16
    passes); the float32 CUDA-core figure stays beside it.  B > 8: the
    float32 figure is the bound."""
    b = cs.bitplane_bound_ms(4096, 768, 4096, 6)
    assert b["flops"] == 3 * 2 * 4096 * 768 * 4096
    assert 0.078 < b["bound_ms"] < 0.079
    assert b["bound_by"] == "operations"
    assert b["fp32_bound_ms"] > b["bound_ms"]
    small = cs.bitplane_bound_ms(8, 768, 4096, 6)
    assert small["bound_by"] == "bytes"
    assert small["bound_ms"] == small["bytes_ms"]
    wide = cs.bitplane_bound_ms(4096, 768, 4096, 10)
    assert wide["flops"] == wide["fp32_flops"] == 2 * 4096 * 768 * 4096
    assert wide["bound_ms"] == wide["fp32_bound_ms"]


def test_flash_bound_counts_visible_keys():
    assert cs.visible_keys(1, 4616, 4096) == 4096
    assert cs.visible_keys(1, 4616, cs.HUGE_WINDOW) == 4616
    assert cs.visible_keys(1, 4616, None) == 4616
    assert cs.visible_keys(4608, 4608, 4096) == 4608
    assert cs.visible_keys(3, 10, 4) == 6  # queries 7..9 see keys 4..9
    local = cs.flash_bound_ms(2, 8, 4, 1, 4616, 256, 2, True, 4096)
    glob = cs.flash_bound_ms(2, 8, 4, 1, 4616, 256, 2, True,
                             cs.HUGE_WINDOW)
    assert local["bytes"] == 2 * (2 * 2 * 8 * 256 + 2 * 2 * 4 * 4096 * 256)
    assert glob["bytes"] == 2 * (2 * 2 * 8 * 256 + 2 * 2 * 4 * 4616 * 256)
    assert local["bound_by"] == glob["bound_by"] == "bytes"
    assert 0.0100 < local["bound_ms"] < 0.0101


def test_bitplane_fault_readings_on_cpu():
    """The B > 8 cases' smallest single-bit fault is rejected by their
    tolerance (on the CPU the sound error is 0)."""
    faults = []
    cases = [c for c in cs.BITPLANE_CASES if c[3] > 8]
    assert cs.bitplane_parity(CPU, cases=cases, faults=faults) == 0.0
    assert [f["shape"] for f in faults] == [list(c) for c in cases]
    for f in faults:
        assert f["sound_err"] == 0.0 and f["fault_err"] > f["atol"]
        assert f["fault_rejected"]


def test_new_cases_cover_every_variant():
    from repro_torch.kernels.bitplane_matmul import variant as bit_variant
    from repro_torch.kernels.flash_attention import variant as flash_variant

    assert {bit_variant(M, B) for M, _, _, B in cs.BITPLANE_CASES} == \
        {"tensor_core", "small_m", "ffma"}
    assert {M for M, _, _, B in cs.BITPLANE_CASES if B <= 8} >= \
        {1, 8, 16, 17}
    kinds = {flash_variant(torch.bfloat16, S, Hq // Hkv)
             for _, _, Hq, Hkv, S, *_ in cs.FLASH_CASES}
    assert kinds == {"mma", "split"}
    assert {Hq // Hkv for _, _, Hq, Hkv, *_ in cs.FLASH_CASES} >= {1, 2, 4, 5}
    # the split plans: many splits, and a single split (no combine launch)
    from repro_torch.kernels.flash_attention import split_plan

    n_splits = {split_plan(B, Hkv, S, T, w)[2]
                for _, B, Hq, Hkv, S, T, _, w, _ in cs.FLASH_CASES
                if flash_variant(torch.bfloat16, S, Hq // Hkv) == "split"}
    assert 1 in n_splits and max(n_splits) > 8
    labels = [c[0] for c in cs.FLASH_MAIN]
    assert {"gemma2-2b decode local", "gemma2-2b decode global",
            "hymba-1.5b prefill local", "hymba-1.5b decode local",
            "hymba-1.5b decode global"} <= set(labels)
    hymba = [c for c in cs.FLASH_MAIN if c[0].startswith("hymba-1.5b decode")]
    for _, B, Hq, Hkv, S, T, D, *_, dt, cache_len in hymba:
        assert flash_variant(torch.bfloat16, S, Hq // Hkv) == "split"
        assert (B, Hq, Hkv, D, dt) == (8, 25, 5, 64, "bfloat16")
        assert cache_len == 2048 + 32 and T <= cache_len


def test_forced_logits_follow_generate():
    """Forcing the greedy run's own tokens reproduces its logits."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    cfg = cs.as_float32(get_config("kratos-dd").smoke())
    params = serve.make_params(cfg, CPU, seed=0)
    prompts = serve.make_inputs(cfg, 2, 9, CPU, seed=0)[0]
    res = serve.generate(cfg, params, prompts, 4, keep_logits=True)
    got = cs.forced_logits(cfg, params, prompts, res["tokens"], True)
    assert got.shape == res["logits"].shape
    assert torch.allclose(got, res["logits"], rtol=1e-5, atol=1e-5)


def test_bf16_gate_rehearsed_on_cpu():
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    # the smoke configs run float32; the gate's point is bfloat16
    cfg = dataclasses.replace(get_config("gemma2-2b").smoke(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    cfg32 = cs.as_float32(cfg)
    params32 = serve.make_params(cfg32, CPU, seed=0)
    params = cs.cast_params(params32, getattr(torch, cfg.param_dtype))
    rec = cs.serve_gate_bf16(cfg, cfg32, params32, params, 1, 12, 3, CPU)
    assert rec["max_abs_logit_diff_vs_float32"] <= rec["tol"]
    assert rec["tol"] >= cs.SERVE_TOL
    # on the CPU both bf16 paths are the plain one
    assert rec["max_abs_logit_diff_vs_plain_bf16"] == 0.0
    assert rec["plain_bf16_vs_float32_activations"] > 0.0
    assert rec["tol_vs_plain_bf16"] >= cs.SERVE_TOL
    assert rec["greedy_agreement_vs_plain_bf16"] == 1.0
    assert sum(rec["launches"].values()) == 0  # nothing launches here


@pytest.mark.parametrize("fault", ["shift", "swap"])
def test_bf16_gate_rejects_a_kernel_path_off_the_plain_bf16_path(
        monkeypatch, fault):
    """A kernel path whose logits move by twice the tolerance against the
    bf16 plain path fails the gate; so does one whose greedy token changes
    at a single position (the top two logits swapped where they are
    closest) even with both logit bounds opened wide."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config("kratos-dd").smoke(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    cfg32 = cs.as_float32(cfg)
    params32 = serve.make_params(cfg32, CPU, seed=0)
    params = cs.cast_params(params32, torch.bfloat16)
    rec = cs.serve_gate_bf16(cfg, cfg32, params32, params, 1, 12, 3, CPU)
    forced = cs.forced_logits

    def off(cfg, params, prompts, tokens, use_kernel, extra=None):
        out = forced(cfg, params, prompts, tokens, use_kernel, extra)
        if not use_kernel:
            return out
        out = out.clone()
        if fault == "shift":
            out[..., 0] += 2 * rec["tol_vs_plain_bf16"]
            return out
        top2 = out.topk(2, dim=-1)
        gap = top2.values[..., 0] - top2.values[..., 1]
        b, t = divmod(int(gap.argmin()), out.shape[1])
        i, j = top2.indices[b, t].tolist()
        out[b, t, i], out[b, t, j] = out[b, t, j].clone(), out[b, t, i].clone()
        return out

    monkeypatch.setattr(cs, "forced_logits", off)
    if fault == "swap":
        monkeypatch.setattr(cs, "NOISE_MARGIN", 1e6)
    with pytest.raises(cs.SmokeFailure,
                       match="differ" if fault == "shift" else "agree"):
        cs.serve_gate_bf16(cfg, cfg32, params32, params, 1, 12, 3, CPU)


def _serve_rec(gate, timed, bf16, launches=None):
    return {"arch": "x", "layers": 2,
            "gate": {"variants": {"flash_attention": gate},
                     "launches": {"flash_attention":
                                  launches if launches is not None
                                  else gate["tf32x3"]}},
            "timed": {"max_new": 4, "variants": {"flash_attention": timed}},
            "gate_bf16": {"variants": {"flash_attention": bf16}}}


def test_check_flash_variants():
    ok = _serve_rec({"mma": 0, "split": 0, "tf32x3": 8},
                    {"mma": 2, "split": 6, "tf32x3": 0},
                    {"mma": 2, "split": 4, "tf32x3": 0})
    cs.check_flash_variants(ok)
    for bad in (_serve_rec({"mma": 0, "split": 0, "tf32x3": 0},
                           {"mma": 2, "split": 6, "tf32x3": 0},
                           {"mma": 2, "split": 4, "tf32x3": 0}),
                _serve_rec({"mma": 0, "split": 0, "tf32x3": 8},
                           {"mma": 0, "split": 8, "tf32x3": 0},
                           {"mma": 2, "split": 4, "tf32x3": 0}),
                _serve_rec({"mma": 0, "split": 0, "tf32x3": 8},
                           {"mma": 2, "split": 6, "tf32x3": 0},
                           {"mma": 2, "split": 0, "tf32x3": 0})):
        with pytest.raises(cs.SmokeFailure):
            cs.check_flash_variants(bad)


@pytest.mark.parametrize("tied", [True, False])
def test_bf16_gate_takes_a_token_tied_in_the_plain_path(monkeypatch, tied):
    """Where the plain path's two top logits tie exactly, the kernel path
    may pick either; a kernel token that is not one of the plain path's
    greedy tokens still fails the gate."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config("kratos-dd").smoke(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    cfg32 = cs.as_float32(cfg)
    params32 = serve.make_params(cfg32, CPU, seed=0)
    params = cs.cast_params(params32, torch.bfloat16)
    forced = cs.forced_logits

    def tie(cfg, params, prompts, tokens, use_kernel, extra=None):
        out = forced(cfg, params, prompts, tokens, use_kernel, extra).clone()
        top2 = out[0, 1].topk(2)
        i, j = top2.indices.tolist()
        if tied or use_kernel:   # the plain path's top two tie
            out[0, 1, j] = out[0, 1, i]
        if use_kernel:           # the kernel path picks the other one
            out[0, 1, j] += 1e-3
        return out

    monkeypatch.setattr(cs, "forced_logits", tie)
    monkeypatch.setattr(cs, "NOISE_MARGIN", 1e6)  # the logit bounds open
    if tied:
        rec = cs.serve_gate_bf16(cfg, cfg32, params32, params, 1, 12, 3, CPU)
        assert rec["greedy_agreement_vs_plain_bf16"] == 1.0
        assert rec["plain_top2_ties"] == 1
        assert rec["greedy_accepted_by_tie"] == 1
    else:
        with pytest.raises(cs.SmokeFailure, match="agree"):
            cs.serve_gate_bf16(cfg, cfg32, params32, params, 1, 12, 3, CPU)
