"""``chip_smoke.py``'s training phases of the MoE, vlm, encdec, ssm and
hybrid families, the serving phases of qwen1.5-0.5b and gemma-2b, and the
float32 train-step gates they share, rehearsed on the CPU at smoke width,
with faults planted where each gate must see them."""
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CPU = torch.device("cpu")
#: the rehearsals' sizes: the gate's (layers, batch, seq) and the bf16
#: run's (layers, steps, batch, seq)
GATE, RUN = (2, 2, 32), (2, 3, 2, 32)
ARCHS = list(cs.FAMILY_TRAIN)


def test_family_table_covers_every_family_but_dense():
    from repro_torch.configs.base import get_config

    assert {get_config(a).family for a in ARCHS} == {
        "moe", "vlm", "encdec", "ssm", "hybrid"}
    assert [p for p, _, _ in cs.FAMILY_TRAIN.values()] == [
        "train_deepseek", "train_llava", "train_whisper", "train_mamba2",
        "train_hymba"]
    whisper = get_config("whisper-small")
    assert cs.FAMILY_TRAIN["whisper-small"][2][0] == whisper.n_layers


def test_deepseek_run_keeps_its_dense_layer_and_three_moe_layers():
    """The donating step fits deepseek-moe-16b's run at 4 layers on the
    card: its dense layer and 3 MoE layers, two flash calls a layer and
    step (the forward and the remat recompute)."""
    from repro_torch.configs.base import get_config

    cfg = get_config("deepseek-moe-16b")
    _, gate, run = cs.FAMILY_TRAIN["deepseek-moe-16b"]
    assert run == (4, 3, 2, 1024)
    cut = cs.cut_depth(cfg, run[0])
    assert (cut.n_layers, cut.n_dense_layers, cut.remat) == (4, 1, True)
    assert 2 * cut.n_layers == 8   # flash launches a step, as the phase
    assert cs.PURE_STEP_PEAKS["train_deepseek"]["float32"][0] == 3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_family_phase_rehearsed_on_cpu(arch, tmp_path):
    """Each family's phase at smoke width: the gate (kernel route against
    plain, or the card's plain step against the host's float64) holds
    its loss, gradients and stepped parameters; the bf16 run (through
    the launcher for encdec, ``fit`` for ssm and hybrid, the train step
    for moe and vlm) holds its losses; the launch arithmetic the card
    checks; nothing left in the work directory."""
    from repro_torch.configs.base import get_config

    cfg = get_config(arch).smoke()
    rec = cs.phase_train_family(arch, CPU, GATE, RUN, tmp_path, smoke=True)
    gate, timed = rec["gate"], rec["timed"]
    kernel = cfg.family not in ("ssm", "hybrid")
    assert rec["phase"] == cs.FAMILY_TRAIN[arch][0]
    assert rec["route"] == ("kernel" if kernel else "plain")
    assert gate["worst_grad_share_of_tol"] <= 1.0
    assert gate["worst_post_step_share_of_tol"] <= 1.0
    assert gate["loss"]["tol"] >= cs.TRAIN_TOL
    assert set(gate["post_step_params"]) == set(gate["grads"])
    assert timed["tol"] == cs.PLAIN_BF16_TOL
    assert all(r <= cs.PLAIN_BF16_TOL for r in timed["rel_vs_float32"])
    if kernel:
        assert 0 < gate["loss"]["plain_vs_float64"] < 1e-6
        assert len(timed["plain_bf16_losses"]) == RUN[1]
        at = timed["at_plain_weights"]
        assert len(at["kernel_bf16"]) == len(at["tol"]) == RUN[1]
        assert at["over"] == []
        bf16 = rec["gate_bf16"]
        assert bf16["worst_grad_share_of_tol"] <= 1.0
        assert bf16["post_step_held"] is False
        assert gate["post_step_held"] is True
        assert bf16["dtype"] == "float32"   # the smoke config's own
    else:
        assert gate["loss"]["card_vs_host_float64"] <= gate["loss"]["tol"]
        assert rec["gate_bf16"] is None
    assert timed["via"] == {"encdec": "launch.train", "ssm": "fit",
                            "hybrid": "fit"}.get(cfg.family, "train.step")
    assert len(timed["losses"]) == len(timed["float32_losses"]) == RUN[1]
    assert timed["peak_bytes"] is None   # no card: not measured
    assert set(rec["peaks"]) == {"bf16", "plain_bf16", "float32"} | (
        {"fp8"} if cfg.is_moe else set())
    assert all(p["peak_bytes"] is None and p["share_of_pure_step"] is None
               for p in rec["peaks"].values())
    assert (rec["fp8_step"] is not None) == cfg.is_moe
    if cfg.is_moe:
        assert rec["fp8_step"]["fp8_expert_gather"] is True
        assert rec["fp8_step"]["steps"] == 1
    encoder = cfg.n_encoder_layers if cfg.family == "encdec" else 0
    assert rec["flash_launches_expected"] == (
        {"gate": GATE[0] + encoder, "per_step": RUN[0] + encoder}
        if kernel else {"gate": 0, "per_step": 0})
    assert [a["where"] for a in rec["attention"]] == (
        [] if not kernel else ["decoder", "encoder"] if encoder
        else ["decoder"])
    for a in rec["attention"]:
        assert a["max_abs_err"] <= cs.FLASH_TOL["bfloat16"]
    if cfg.family == "vlm":
        assert rec["attention"][0]["q"][2] == cfg.n_patches + RUN[3]
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("phase,arch", cs.SERVE_MORE)
def test_serve_more_phase_rehearsed_on_cpu(phase, arch):
    from repro_torch.configs.base import get_config

    cfg = get_config(arch).smoke()
    rec, _ = cs.phase_serve(phase, cfg, CPU, gate=(1, 20, 3),
                            timed=(2, 10, 3))
    assert rec["phase"] == phase and rec["arch"] == cfg.name
    assert rec["gate"]["tokens_identical"]
    assert rec["gate"]["max_abs_logit_diff_vs_forward"] <= cs.SERVE_TOL
    assert rec["gate_bf16"]["greedy_agreement_vs_plain_bf16"] == 1.0
    assert rec["flash_launches_expected"] == cfg.n_layers * 3
    assert rec["timed"]["launches"]["flash_attention"] == 0   # no card
    assert cs.SERVE_MORE_GATE == (1, 4608, 4)


def test_fresh_adamw_state_steps_as_adamw_init():
    """The gates' broadcast zero state gives the step that
    ``optimizer.adamw_init``'s zeros give, bit for bit."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.train import optimizer

    cfg = get_config("deepseek-moe-16b").smoke()
    params = serve.make_params(cfg, CPU, seed=0)
    grads = tree.map(lambda p: torch.randn_like(p), params)
    opt = optimizer.OptConfig(**cs.TRAIN_OPT)
    want = optimizer.adamw_update(opt, grads, optimizer.adamw_init(params),
                                  params)
    got = optimizer.adamw_update(opt, grads, cs._fresh_adamw(params), params)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert torch.equal(a, b)


def _shares(msg: str) -> tuple[float, float, float]:
    m = re.search(r"loss (\S+) \(tol (\S+)\), worst gradient at (\S+) and "
                  r"worst stepped parameter at (\S+) of", msg)
    loss, tol, grad, post = (float(x) for x in m.groups())
    return loss / tol, grad, post


def test_train_gate_rejects_a_stepped_parameter_fault(monkeypatch):
    """The kernel run's AdamW update scaled by 1.01 leaves its loss and
    gradients as they were; the gate rejects it on the stepped
    parameters alone."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config

    cfg = get_config("tinyllama-1.1b").smoke()
    sound = cs.train_gate(cfg, CPU, 1, 2, 64)
    assert sound["worst_post_step_share_of_tol"] <= 1.0
    real = cs.gate_step

    def off(c, tcfg, params, data, use_kernel):
        loss, grads, new = real(c, tcfg, params, data, use_kernel)
        if use_kernel:
            new = tree.map(lambda p, n: p + 1.01 * (n - p), params, new)
        return loss, grads, new

    monkeypatch.setattr(cs, "gate_step", off)
    with pytest.raises(cs.SmokeFailure, match="train gate") as e:
        cs.train_gate(cfg, CPU, 1, 2, 64)
    loss, grad, post = _shares(str(e.value))
    assert loss <= 1.0 and grad <= 1.0 < post


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_host_gate_rejects_a_card_side_fault(monkeypatch, arch):
    """A plain-route family's gate passes as it stands and rejects a scan
    fault (each step's own input dropped) in the card's step alone: the
    host's float32 and float64 steps stay sound."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ref

    cfg = get_config(arch).smoke()
    cs.host_gate(cfg, CPU, *GATE)
    real, calls = cs.gate_step, []

    def card_faulty(*a):
        calls.append(a)
        if len(calls) % 3:   # the host's two steps
            return real(*a)
        with monkeypatch.context() as m:
            m.setattr(ref, "ssd_scan_ref", cs.drop_diagonal(
                ref.ssd_scan_ref))
            return real(*a)

    monkeypatch.setattr(cs, "gate_step", card_faulty)
    with pytest.raises(cs.SmokeFailure, match="host gate"):
        cs.host_gate(cfg, CPU, *GATE)
    assert len(calls) == 3


def test_family_run_rejects_a_kernel_route_fault(monkeypatch, tmp_path):
    """The bf16 run holds the kernel route's losses to the plain route's:
    a softmax scale 1.25 x too large on the kernel route fails it."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops

    cfg = cs.cut_depth(get_config("deepseek-moe-16b").smoke(), RUN[0])
    rec = cs.family_timed(cfg, CPU, *RUN[1:], tmp_path / "run")
    assert rec["at_plain_weights"]["over"] == []
    flash = ops.flash_attention

    def faulty(q, k, v, causal=True, window=None, softcap=None, scale=None,
               use_kernel=True):
        return flash(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=1.25 * q.shape[-1] ** -0.5, use_kernel=use_kernel)

    monkeypatch.setattr(ops, "flash_attention", faulty)
    with pytest.raises(cs.SmokeFailure, match="bf16 training"):
        cs.family_timed(cfg, CPU, *RUN[1:], tmp_path / "run")


def test_bf16_train_gate_rejects_a_kernel_route_fault(monkeypatch):
    """The bf16 gate, in bf16 on the CPU, passes the sound kernel route
    and rejects the same softmax-scale fault on it."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config("llava-next-34b").smoke(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    rec = cs.train_gate_bf16(cfg, CPU, *GATE)
    assert rec["dtype"] == "bfloat16"
    assert rec["loss"]["plain_bf16_vs_float32"] > 0
    flash = ops.flash_attention

    def faulty(q, k, v, causal=True, window=None, softcap=None, scale=None,
               use_kernel=True):
        return flash(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=1.25 * q.shape[-1] ** -0.5, use_kernel=use_kernel)

    monkeypatch.setattr(ops, "flash_attention", faulty)
    with pytest.raises(cs.SmokeFailure, match="bf16 train gate"):
        cs.train_gate_bf16(cfg, CPU, *GATE)


def test_family_run_rejects_a_fault_after_the_first_step(monkeypatch,
                                                         tmp_path):
    """A kernel-route loss that goes wrong only from its second call on
    (the softmax-scale fault, from the second step) passes the first
    step and is rejected at the plain run's later weights."""
    import contextlib

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import step as tstep

    cfg = cs.cut_depth(get_config("deepseek-moe-16b").smoke(), RUN[0])
    flash, make = ops.flash_attention, tstep.make_loss_fn

    def faulty(q, k, v, causal=True, window=None, softcap=None, scale=None,
               use_kernel=True):
        return flash(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=1.25 * q.shape[-1] ** -0.5, use_kernel=use_kernel)

    def make_late_fault(c, tcfg, use_kernel=True):
        fn, calls = make(c, tcfg, use_kernel), []

        def loss_fn(params, batch):
            calls.append(1)
            with (monkeypatch.context() if use_kernel and len(calls) > 1
                  else contextlib.nullcontext()) as m:
                if m is not None:
                    m.setattr(ops, "flash_attention", faulty)
                return fn(params, batch)

        return loss_fn

    monkeypatch.setattr(tstep, "make_loss_fn", make_late_fault)
    with pytest.raises(cs.SmokeFailure, match="bf16 training") as e:
        cs.family_timed(cfg, CPU, *RUN[1:], tmp_path / "run")
    assert re.search(r"over at steps \[1, 2\]", str(e.value))
