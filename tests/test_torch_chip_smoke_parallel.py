"""``chip_smoke.py``'s phases for MoE routing ties, chunked local
attention, the pipeline and the dry run, rehearsed on the CPU at smoke
width, and one planted fault per new gate, which the gate must reject:

- ``moe_topk``: a routing tie broken toward the high index;
- ``chunked``: a block-local mask with no first-block rule (block 0 also
  sees the zero keys standing before it);
- ``pipeline``: a tick that drains the wrong microbatch;
- ``mesh_train`` (on a gloo group of 2, a ``(1, 2)`` mesh, in
  subprocesses): the all-reduce over ``model`` after the row-sharded
  ``wo`` product dropped, each rank keeping its partial sum.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import blocks, layers  # noqa: E402
from repro_torch.parallel import pipeline  # noqa: E402

CPU = torch.device("cpu")
#: the rehearsals' sizes: (batch, sequence) of the chunked forward, four
#: blocks of the smoke window 16; (stages, microbatches, rows, sequence)
CHUNKED = (1, 64)
PIPELINE = (2, 4, 2, 16)


def _bf16(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")


def test_lowest_index_topk_and_tied_rows():
    rows = cs.tied_router_rows(64)
    assert rows.shape == (3 + cs.TOPK_RANDOM_ROWS, 64)
    want = np.asarray([[5, 17, 33, 2, 3, 10], [7, 30, 50, 1, 9, 12],
                       [0, 1, 2, 3, 4, 5]])
    assert np.array_equal(cs.lowest_index_topk(rows[:3], 6), want)
    assert cs.sample_positions(64, 16, n=8) == \
        list(range(8)) + list(range(12, 20)) + list(range(56, 64))
    assert cs.sample_positions(8192, 4096) == list(range(32)) + \
        list(range(4080, 4112)) + list(range(8160, 8192))


def test_moe_topk_phase_rehearsed_on_cpu():
    rec = cs.phase_moe_topk(get_config("deepseek-moe-16b"), CPU)
    assert rec["experts"] == [64, 6] and rec["rows_differing"] == 0
    assert rec["rows_tied_across_k"] > 2 and rec["rows_tied_inside_k"] > 2


def test_serve_chunked_phase_rehearsed_on_cpu():
    cfg = _bf16(get_config("gemma2-2b").smoke())
    rec = cs.phase_serve_chunked(cfg, CPU, forward=CHUNKED)
    gate = rec["gate"]
    assert gate["block_local_calls_plain"] == 1   # layer 0 of the two
    assert gate["attention_windows_kernel"] == {"16": 1, str(cs.HUGE_WINDOW): 1}
    assert gate["max_abs_logit_diff_vs_plain"] <= gate["tol"]
    assert gate["positions"] == 64   # every position at this size
    assert rec["timed"]["batch"] == 1 and rec["timed"]["tok_per_s"] > 0


def test_pipeline_phase_rehearsed_on_cpu():
    cfg = _bf16(dataclasses.replace(get_config("tinyllama-1.1b").smoke(),
                                    n_layers=4))
    rec = cs.phase_pipeline(cfg, CPU, shape=PIPELINE)
    assert rec["bf16"]["bitwise_equal_per_microbatch"]
    assert rec["float32"]["bitwise_equal_per_microbatch"]
    assert rec["float32"]["max_abs_diff_vs_batched"] <= rec["float32"]["tol"]
    assert rec["bubble_fraction"] == pytest.approx(1 / 5)
    assert rec["flash_launches_expected"] == 4 * 4


def test_dryrun_phase_rehearsed_on_cpu():
    """The records of every cell, then the long_500k cell's decode step
    on the smoke-width mamba2 config standing in for the full one."""
    run_cfg = _bf16(get_config("mamba2-2.7b").smoke())
    rec = cs.phase_dryrun(CPU, card_bytes=80 * 2**30, run_cfg=run_cfg)
    assert len(rec["records"]) == 10 * 4
    assert ["mamba2-2.7b", "long_500k"] in rec["fits"]
    assert ["kimi-k2-1t-a32b", "train_4k"] not in rec["fits"]
    run = rec["run"]
    assert run["pos"] == 524287 and run["peak_bytes"] is None
    assert 0 < run["allocated_bytes"]
    ok = [r for r in rec["records"] if r[2] != "skipped"]
    assert len(ok) == 10 * 3 + 2     # long_500k: mamba2 and hymba
    assert all(len(r) == len(rec["columns"]) for r in ok)


def _no_first_block(q, k, v, window, *, softcap=None, scale=None):
    """Block-local attention without the first-block rule: the first
    block's queries see the zero keys of a previous block that does not
    exist."""
    def pad(t):
        return torch.cat([torch.zeros_like(t[:, :window]), t], dim=1)

    return layers.attention_ref(q, pad(k), pad(v), window=window,
                                softcap=softcap, scale=scale)


def _tie_high(x, k):
    """Top-k with ties broken toward the highest index."""
    E = x.shape[-1]
    vals, idx = torch.sort(x.flip(-1), dim=-1, descending=True, stable=True)
    return vals[..., :k], (E - 1 - idx)[..., :k]


def _gate_case(gate: str):
    """(run the gate, plant its fault)."""
    if gate == "moe_topk":
        cfg = get_config("deepseek-moe-16b")
        return (lambda: cs.phase_moe_topk(cfg, CPU),
                (blocks, "topk_lowest_index", _tie_high))
    if gate == "chunked":
        cfg = dataclasses.replace(get_config("gemma2-2b").smoke(),
                                  chunked_local_attn=True)
        from repro_torch.launch import serve

        params = serve.make_params(cfg, CPU, seed=0)
        return (lambda: cs.chunked_gate(cfg, params, *CHUNKED, CPU),
                (layers, "local_chunked_attention", _no_first_block))
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").smoke(),
                              n_layers=4)
    from repro_torch.launch import serve

    params = serve.make_params(cfg, CPU, seed=0)
    return (lambda: cs.pipeline_run(cfg, params, PIPELINE, CPU),
            (pipeline, "drain_index", lambda t, n: max(0, t - n)))


@pytest.mark.parametrize("gate", ["moe_topk", "chunked", "pipeline"])
def test_new_gate_rejects_a_planted_fault(monkeypatch, gate):
    """Each new gate passes on the sound path and fails with its fault."""
    run, (module, name, fault) = _gate_case(gate)
    run()
    monkeypatch.setattr(module, name, fault)
    with pytest.raises(cs.SmokeFailure):
        run()


#: the mesh rehearsal's sizes: gate (layers, batch, sequence) and timed
#: run (steps, batch, sequence)
MESH = ((2, 2, 64), (3, 4, 64))

MESH_SCRIPT = r"""
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
# the heads every attention call gets (the kernel's count is the card's)
from repro_torch.kernels import ref
heads, plain = set(), ref.flash_attention_ref


def seen(q, k, v, **kw):
    heads.add(f"{q.shape[1]}/{k.shape[1]}")
    return plain(q, k, v, **kw)


ref.flash_attention_ref = seen
gate, timed = json.loads(ARGS[3])
try:
    rec = cs.mesh_train_rank("tinyllama-1.1b", torch.device("cpu"), 2,
                             gate, timed, workdir=cs.Path(ARGS[2]),
                             smoke=True)
    out = {"mesh": rec["mesh"], "gate": rec["gate"], "timed": rec["timed"],
           "heads": sorted(heads)}
except cs.SmokeFailure as e:
    out = {"refused": str(e)[:300]}
print(json.dumps(out))
"""


def _mesh_ranks(tmp_path, mode: str) -> list:
    from _torch_ranks import run_ranks

    return run_ranks(MESH_SCRIPT, 2, tmp_path, str(ROOT), mode,
                     str(tmp_path / "ckpt"), json.dumps(MESH), timeout=240)


@pytest.mark.parametrize("cards,shape", [(1, (1, 1)), (2, (1, 2)),
                                         (3, (1, 2)), (4, (2, 2)),
                                         (8, (2, 2))])
def test_mesh_shape_takes_up_to_four_cards_in_pairs(cards, shape):
    assert cs.mesh_shape(cards) == shape


def test_mesh_train_phase_rehearsed_on_cpu(tmp_path):
    """The phase's rank part on a ``(1, 2)`` gloo mesh at smoke width:
    the float32 gate and the timed run through ``launch.train`` pass,
    every flash call on the local heads (tinyllama smoke: 4 query heads
    and 1 kv head, so 2 and 2 once each rank picks the kv head its query
    heads read)."""
    for rec in _mesh_ranks(tmp_path, "sound"):
        assert rec["mesh"] == {"data": 1, "model": 2}
        gate, timed = rec["gate"], rec["timed"]
        assert gate["worst_grad_share_of_tol"] <= 1.0
        assert gate["loss"]["mesh_vs_unsharded"] <= gate["loss"]["tol"]
        # the mesh runs on local heads, the unsharded ones on all 4 / 1
        assert rec["heads"] == ["2/2", "4/1"]
        assert gate["flash_heads"] == timed["flash_heads"] == {}  # no card
        assert all(r <= t for r, t in zip(timed["rel_vs_unsharded"],
                                          timed["tol"]))
        assert len(timed["float32_losses"]) == MESH[1][0]
        assert len(timed["losses"]) == MESH[1][0]
        assert timed["peak_bytes"] is None   # no device: not measured
    assert (tmp_path / "ckpt" / "run" / "step_00000003").is_dir()


def test_mesh_gate_rejects_a_dropped_model_all_reduce(tmp_path):
    for rec in _mesh_ranks(tmp_path, "fault"):
        assert "mesh gate" in rec.get("refused", ""), rec
