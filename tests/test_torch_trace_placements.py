"""The placements the port's sharded train step asks DTensor for, and its
per-device FLOPs, from its trace at smoke width on a fake group.

Torch 2.11 refused the train steps of mamba2-2.7b, hymba-1.5b and
whisper-small on ``(16, 16)``: summing the tied embedding table's two
gradients (the lookup's and the unembedding's, of different placements),
its DTensor asked for ``Shard(1)`` -> ``Partial(sum)``, a redistribution
it lacks, where torch 2.13 picked another layout for the same sum.  The
port now names the placement of every gradient at the boundaries it
draws (``parallel.api``: ``redistribute``, ``constrain``, ``hold``,
``local_map``), so gradients meet at one placement and no torch
version's choice decides the step.

Each arch's train step is traced in a process of its own over a fake
group, on a ``(2, 8)`` ``("data", "model")`` mesh (8 does not divide the
smoke configs' 4 heads, as 16 does not divide whisper's 12 or hymba's
25), while every redistribution DTensor is asked for is recorded
(``_redistribute.redistribute_local_tensor`` wrapped) with the op that
asked for it.  Held:

* none is a transition torch 2.11 lacks: a shard (or strided shard) to
  ``Partial``, a strided shard to ``Shard``, a shard or a partial sum to
  a strided shard, one partial reduction to another;
* no sum in the backward asks DTensor to redistribute an operand (the
  parent tree's tied table asked for two on every torch version);
* mamba2-2.7b's per-device FLOPs do not fall when the sequence doubles,
  and 8 x its per-device FLOPs on ``(2, 4)``, where every sharded
  dimension divides its axis, are the mesh of one's within 1 %: no
  product runs replicated where the reference's rules split it.
"""
import json
import os
import subprocess
import sys

import pytest

from _torch_ranks import SRC

pytestmark = pytest.mark.slow   # subprocesses: fake groups, traced steps

ARCHS = ["mamba2-2.7b", "hymba-1.5b", "whisper-small"]
UNEVEN = ([2, 8], ["data", "model"])
EVEN = ([2, 4], ["data", "model"])
ONE = ([1, 1], ["data", "model"])
#: a smoke step: batch 8 (the data axis divides it), S and 2S positions
SHAPE, SHAPE2 = ["train", 8, 64], ["train", 8, 128]
FLOPS_TOL = 0.01
#: each subprocess's time limit, seconds
TIMEOUT = 300

SCRIPT = r"""
import json, sys
import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import _redistribute
from torch.distributed.tensor._dispatch import OpDispatcher
from torch.distributed.tensor._dtensor_spec import DTensorSpec
from torch.distributed.tensor.placement_types import _StridedShard
from repro_torch.configs.base import get_config
from repro_torch.launch import trace

moves, sums = set(), set()
asking = [None]
orig_local = _redistribute.redistribute_local_tensor
orig_args = OpDispatcher.redistribute_local_args


def local(t, current, target, *a, **k):
    moves.add((tuple(map(repr, current.placements)),
               tuple(map(repr, target.placements)), asking[0] or ""))
    return orig_local(t, current, target, *a, **k)


def args(op_info, suggested, *a, **k):
    op = str(suggested.op)
    flat = (tuple(pytree.tree_leaves(suggested.args_schema))
            if op_info.args_tree_spec is not None
            else suggested.args_schema)
    if (op.startswith("aten.add") and torch._C._current_autograd_node()
            is not None):
        for x, y in zip(op_info.flat_args_schema, flat):
            if isinstance(x, DTensorSpec) and x.placements != y.placements:
                sums.add(repr((x.placements, y.placements)))
    asking[0] = op
    try:
        return orig_args(op_info, suggested, *a, **k)
    finally:
        asking[0] = None


for mod in list(sys.modules.values()):
    if getattr(mod, "redistribute_local_tensor", None) is orig_local:
        mod.redistribute_local_tensor = local
OpDispatcher.redistribute_local_args = staticmethod(args)

jobs = json.loads(sys.argv[1])
trace.form_fake_group(max(s[0] * s[1] for _, _, (s, _) in jobs))
for arch, shape, (sizes, names) in jobs:
    moves.clear()
    sums.clear()
    rec = trace.trace_cell(get_config(arch).smoke(), trace.shape_of(shape),
                           trace.fake_mesh(sizes, names))
    print(json.dumps({"arch": arch, "shape": shape, "sizes": sizes,
                      "flops": rec["cost"]["flops"],
                      "moves": sorted(map(list, moves)),
                      "sums": sorted(sums)}), flush=True)
"""


def _is(p: str, kind: str) -> bool:
    return p.startswith(kind)


def lacking_in_2_11(cur: str, tgt: str) -> bool:
    """Whether torch 2.11's ``redistribute_local_tensor`` refuses
    ``cur`` -> ``tgt`` on one mesh dimension (``repr`` of placements)."""
    shard = _is(cur, "Shard") or _is(cur, "_StridedShard")
    if _is(tgt, "Partial"):
        return shard or (_is(cur, "Partial") and cur != tgt)
    if _is(tgt, "_StridedShard"):
        return _is(cur, "Shard") or _is(cur, "Partial")
    if _is(tgt, "Shard"):
        return _is(cur, "_StridedShard")
    return False


@pytest.fixture(scope="module")
def traced():
    jobs = ([[a, SHAPE, UNEVEN] for a in ARCHS]
            + [["mamba2-2.7b", s, EVEN] for s in (SHAPE, SHAPE2)]
            + [["mamba2-2.7b", SHAPE, ONE]])
    env = dict(os.environ, PYTHONPATH=str(SRC))
    p = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(jobs)],
                       capture_output=True, text=True, env=env,
                       timeout=TIMEOUT)
    assert p.returncode == 0, p.stderr[-3000:]
    recs = [json.loads(line) for line in p.stdout.splitlines()
            if line.startswith("{")]
    return {(r["arch"], tuple(r["sizes"]), r["shape"][2]): r for r in recs}


def test_lacking_in_2_11_names_the_refused_transitions():
    assert lacking_in_2_11("Shard(dim=1)", "Partial(sum)")
    assert lacking_in_2_11("Partial(sum)", "Partial(avg)")
    assert not lacking_in_2_11("Partial(sum)", "Partial(sum)")
    assert not lacking_in_2_11("Replicate()", "Partial(sum)")
    assert not lacking_in_2_11("Partial(sum)", "Shard(dim=0)")
    assert not lacking_in_2_11("Shard(dim=0)", "Shard(dim=1)")


@pytest.mark.parametrize("arch", ARCHS)
def test_no_redistribution_torch_2_11_lacks(traced, arch):
    rec = traced[(arch, tuple(UNEVEN[0]), SHAPE[2])]
    assert rec["moves"], "no redistribution recorded: the wrap missed"
    bad = [(cur, tgt, op) for cur, tgt, op in rec["moves"]
           if any(lacking_in_2_11(c, t) for c, t in zip(cur, tgt))]
    assert bad == [], bad


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_meet_at_one_placement(traced, arch):
    rec = traced[(arch, tuple(UNEVEN[0]), SHAPE[2])]
    assert rec["sums"] == [], rec["sums"]


def test_mamba2_flops_do_not_fall_when_the_sequence_doubles(traced):
    short = traced[("mamba2-2.7b", tuple(EVEN[0]), SHAPE[2])]["flops"]
    long = traced[("mamba2-2.7b", tuple(EVEN[0]), SHAPE2[2])]["flops"]
    assert short > 0 and long >= short, (short, long)


def test_mamba2_flops_split_over_the_mesh(traced):
    """Per-device FLOPs x the device count equal the mesh of one's: every
    product runs split, none replicated."""
    per = traced[("mamba2-2.7b", tuple(EVEN[0]), SHAPE[2])]["flops"]
    one = traced[("mamba2-2.7b", tuple(ONE[0]), SHAPE[2])]["flops"]
    n = EVEN[0][0] * EVEN[0][1]
    assert abs(per * n - one) <= FLOPS_TOL * one, (per * n, one)
