"""The GPipe pipeline across 4 gloo ranks, stage s on rank s of the
``stage`` axis, at the shapes of ``tests/parallel/test_pipeline.py``:
4 stages, 8 microbatches of 2 rows; tanh-MLP stages of width 16 (the
reference's seed-0 draws), and transformer stages of 2 tinyllama-1.1b
smoke layers each (8 layers, sequence 8).

Held on every rank: the output bit-equal to the port's one-device
``pipeline_apply`` on the same inputs (the stages in turn), within the
reference test's limits of sequential execution (1e-5 for the MLP, 1e-3
for the transformer), the bubble 3/11; the same with the stack given as
DTensors sharded over the stage axis; and a mesh of one stage running
the one-device form.
"""
import json

import pytest

from _torch_ranks import run_ranks

pytestmark = pytest.mark.slow   # subprocesses: 4 ranks

WORLD = 4
TIMEOUT = 240

SCRIPT = r"""
import dataclasses, json
import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import make_params
from repro_torch.models import blocks
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply

S, n_mb, mb, d = 4, 8, 2, 16
mesh = init_device_mesh("cpu", (S,), mesh_dim_names=("stage",))
one_stage = init_device_mesh("cpu", (S, 1), mesh_dim_names=("data", "stage"))
r = np.random.default_rng(0)
W = torch.from_numpy(r.standard_normal((S, d, d)).astype(np.float32) * 0.3)
b = torch.from_numpy(r.standard_normal((S, d)).astype(np.float32) * 0.1)
x = torch.from_numpy(r.standard_normal((n_mb, mb, d)).astype(np.float32))


def mlp(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def report(stage_fn, stack, xs, seq):
    y = pipeline_apply(stage_fn, stack, xs, mesh)
    one = pipeline_apply(stage_fn, stack, xs, S)
    sharded = tree.map(lambda a: distribute_tensor(a, mesh, [Shard(0)],
                                                   src_data_rank=None), stack)
    y_sh = pipeline_apply(stage_fn, sharded, xs, mesh)
    y_1 = pipeline_apply(stage_fn, stack, xs, one_stage)
    return {"err": float((y - seq).abs().max()),
            "bitwise_one_device": bool(torch.equal(y, one)),
            "bitwise_sharded_stack": bool(torch.equal(y_sh, one)),
            "bitwise_one_stage_mesh": bool(torch.equal(y_1, one))}


seq = x
for s in range(S):
    seq = torch.tanh(seq @ W[s] + b[s])
out = {"mlp": report(mlp, {"w": W, "b": b}, x, seq),
       "bubble": bubble_fraction(n_mb, S)}

cfg8 = dataclasses.replace(get_config("tinyllama-1.1b").smoke(), n_layers=8)
blk = make_params(cfg8, torch.device("cpu"), seed=0)["blocks"]
stack = {k: v.reshape((S, 2) + v.shape[1:]) for k, v in blk.items()}
Sq = 8
xx = torch.from_numpy((r.standard_normal((n_mb, mb, Sq, cfg8.d_model))
                       * 0.1).astype(np.float32))


def layers(p, h, n):
    pos = torch.arange(h.shape[1])[None].expand(h.shape[0], h.shape[1])
    for i in range(n):
        pi = {k: v[i] for k, v in p.items()}
        a, _ = blocks.attn_block(cfg8, pi, h, pos)
        h = h + a
        h = h + blocks.ffn_block(cfg8, pi, h)
    return h


seq2 = layers(blk, xx.reshape(n_mb * mb, Sq, cfg8.d_model), 8)
out["tf"] = report(lambda p, h: layers(p, h, 2), stack, xx,
                   seq2.reshape(n_mb, mb, Sq, cfg8.d_model))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(SCRIPT, WORLD, tmp_path_factory.mktemp("pipeline"),
                     timeout=TIMEOUT)


@pytest.mark.parametrize("stages,tol", [("mlp", 1e-5), ("tf", 1e-3)])
def test_mesh_pipeline_equals_one_device_and_sequential(ranks, stages, tol):
    for rec in ranks:
        got = rec[stages]
        assert got["bitwise_one_device"], json.dumps(got)
        assert got["err"] < tol


@pytest.mark.parametrize("stages", ["mlp", "tf"])
def test_mesh_pipeline_sharded_stack_and_one_stage_mesh(ranks, stages):
    for rec in ranks:
        assert rec[stages]["bitwise_sharded_stack"]
        assert rec[stages]["bitwise_one_stage_mesh"]


def test_mesh_pipeline_bubble(ranks):
    assert all(abs(rec["bubble"] - 3 / 11) < 1e-9 for rec in ranks)
