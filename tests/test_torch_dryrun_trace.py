"""The dry run's trace (``launch/trace.py``) against the reference's
lowering and compile analyses.

The reference runs in a subprocess on 8 host devices, with its
``make_production_mesh`` replaced (in that process only) by a ``(4, 2)``
``("data", "model")`` mesh built by ``repro.parallel.compat.make_mesh(...,
axis_types=(AXIS_TYPE_AUTO,) * 2)``; its ``lower_cell`` + ``compile_cell``
give each smoke-width cell's ``memory_analysis``.  The port traces the
same cells on a fake process group of 8 ranks and the same ``(4, 2)``
mesh, in a process of its own, and a dense train cell on a mesh of one in
another.

Held: the traced argument bytes equal the reference's
``argument_size_in_bytes`` and the dry run's per-device argument bytes;
the traced FLOPs are per device (8 x the ``(4, 2)`` count within 5 % of
the mesh of one's); one ``Shard(0)`` -> ``Shard(1)`` redistribution is
recorded as one all-to-all (DTensor's CPU groups would gather); a mesh of
one records no collective; no real tensor over 1 MB is made during a
trace; the CLI writes traced records for qwen1.5-0.5b on both production
meshes.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from _torch_ranks import SRC
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import dryrun, trace
from repro_torch.launch.mesh import Mesh

pytestmark = pytest.mark.slow   # subprocesses: an 8-device host, fake groups

CELLS = [("qwen1.5-0.5b", "train_4k"), ("qwen1.5-0.5b", "decode_32k"),
         ("deepseek-moe-16b", "prefill_32k"), ("mamba2-2.7b", "train_4k"),
         ("whisper-small", "prefill_32k"), ("llava-next-34b", "decode_32k"),
         ("hymba-1.5b", "long_500k")]
MESH = ([4, 2], ["data", "model"])
#: each subprocess's time limit, seconds
TIMEOUT = 300
MB = 1 << 20

REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
jax.devices()   # the backend is up: the dry run's own XLA_FLAGS come late
from repro.configs.base import get_config
from repro.launch import dryrun
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh

dryrun.make_production_mesh = lambda multi_pod=False: make_mesh(
    (4, 2), ("data", "model"), axis_types=(AXIS_TYPE_AUTO,) * 2)
for arch, shape in json.loads(sys.argv[1]):
    rec, lowered = dryrun.lower_cell(arch, shape, False,
                                     cfg=get_config(arch).smoke())
    rec = dryrun.compile_cell(rec, lowered)
    print(json.dumps({"cell": arch + "/" + shape, "memory": rec["memory"],
                      "n_devices": rec["n_devices"]}), flush=True)
"""

PORT_SCRIPT = r"""
import json, sys
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import trace

cells, sizes, names = (json.loads(a) for a in sys.argv[1:4])
jobs = [(a, s, sizes, names, True) for a, s in cells]
for job, rec in trace.trace_jobs(jobs):
    print(json.dumps({"cell": job[0] + "/" + job[1], **rec}), flush=True)
if sizes == [4, 2]:
    # one Shard(0) -> Shard(1) redistribution over data
    mesh = trace.fake_mesh(sizes, names)
    x = DTensor.from_local(torch.empty((2, 64), device="meta"), mesh,
                           [Shard(0), Replicate()], run_check=False)
    with trace.counting(trace.Counter()) as counter:
        y = x.redistribute(mesh, [Shard(1), Replicate()])
    print(json.dumps({"cell": "alltoall",
                      "collectives": trace.collective_stats(counter),
                      "local": list(y.to_local().shape)}))
"""


def _run(script: str, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", script, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _lines(proc) -> dict:
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    recs = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    return {r.pop("cell"): r for r in recs}


@pytest.fixture(scope="module")
def runs():
    """``(reference records, (4, 2) traces, mesh-of-one traces)``; the
    slowest cell (the sequential SSD scan) in a process of its own."""
    cells = json.dumps(CELLS)
    slow = [c for c in CELLS if c[0] == "mamba2-2.7b"]
    fast = [c for c in CELLS if c not in slow]
    procs = [_run(REF_SCRIPT, cells),
             _run(PORT_SCRIPT, json.dumps(fast), *map(json.dumps, MESH)),
             _run(PORT_SCRIPT, json.dumps(slow), *map(json.dumps, MESH)),
             _run(PORT_SCRIPT, json.dumps([("qwen1.5-0.5b", "train_4k")]),
                  json.dumps([1, 1]), json.dumps(MESH[1]))]
    try:
        ref, fast_t, slow_t, one = (_lines(p) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return ref, {**fast_t, **slow_t}, one


@pytest.mark.parametrize("arch,shape", CELLS)
def test_traced_argument_bytes_equal_the_reference(runs, arch, shape):
    ref, port, _ = runs
    cell = f"{arch}/{shape}"
    rec = port[cell]
    assert rec["status"] == "ok", rec.get("error")
    assert ref[cell]["n_devices"] == 8
    got = rec["memory"]["argument_size_in_bytes"]
    cfg = get_config(arch).smoke()
    args = dryrun._cell_args(cfg, SHAPES[shape])
    mesh = Mesh.of(*MESH)
    specs = dryrun._arg_specs(cfg, mesh, args)
    assert got == sum(dryrun._sharded_bytes(args[r], specs[r], mesh)
                      for r in args)
    # jax.jit drops the arguments a step does not read (keep_unused=
    # False): the cache's encoder keys and values, which the reference's
    # prefill replaces whole (the port writes them in place), and a vlm
    # model's patch projection at decode
    role, keys = {("prefill", "encdec"): ("cache", ("xk", "xv")),
                  ("decode", "vlm"): ("weights", ("patch_proj",))}.get(
        (SHAPES[shape].kind, cfg.family), ("cache", ()))
    unread = dryrun._sharded_bytes(
        {k: args[role][k] for k in keys},
        {k: specs[role][k] for k in keys}, mesh)
    assert got == ref[cell]["memory"]["argument_size_in_bytes"] + unread
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0


def test_traced_flops_are_per_device(runs):
    """A dense train step on ``(4, 2)``: 8 x its per-device FLOPs within
    5 % of the same step's on a mesh of one, so no count is taken on
    DTensor's global shapes."""
    _, port, one = runs
    sharded = port["qwen1.5-0.5b/train_4k"]["cost"]["flops"]
    whole = one["qwen1.5-0.5b/train_4k"]["cost"]["flops"]
    assert whole > 0
    assert abs(8 * sharded - whole) <= 0.05 * whole, (sharded, whole)


def test_shard_to_shard_is_one_all_to_all(runs):
    _, port, _ = runs
    rec = port["alltoall"]
    assert rec["local"] == [8, 16]
    assert rec["collectives"] == {
        "all-to-all": {"count": 1, "bytes": 8 * 16 * 4},
        "total_bytes": 8 * 16 * 4}


def test_mesh_of_one_records_no_collective(runs):
    _, _, one = runs
    rec = one["qwen1.5-0.5b/train_4k"]
    assert rec["status"] == "ok"
    assert rec["collectives"] == {"total_bytes": 0}


def test_a_sharded_step_records_its_collectives(runs):
    _, port, _ = runs
    coll = port["qwen1.5-0.5b/train_4k"]["collectives"]
    assert set(coll) <= set(trace.KINDS) | {"total_bytes"}
    assert coll["all-gather"]["count"] > 0 and coll["all-reduce"]["count"] > 0
    assert coll["total_bytes"] == sum(v["bytes"] for k, v in coll.items()
                                      if k != "total_bytes")


def test_trace_allocates_nothing(runs):
    _, port, one = runs
    for cell, rec in {**port, **one}.items():
        if "largest_real_bytes" in rec:
            assert rec["largest_real_bytes"] < MB, cell


def test_scan_budget():
    """The sequential SSD scans' Python steps: layers x sequence (1 at
    decode; none where the chunked form serves training)."""
    m = get_config("mamba2-2.7b")
    assert trace.scan_steps(m, SHAPES["train_4k"]) == 64 * 4096
    assert trace.scan_steps(dataclasses.replace(m, ssd_chunk=256),
                            SHAPES["train_4k"]) == 0
    assert trace.scan_steps(m, SHAPES["long_500k"]) == 64
    assert trace.scan_steps(get_config("qwen1.5-0.5b"),
                            SHAPES["prefill_32k"]) == 0
    assert trace.scan_steps(m.smoke(), SHAPES["train_4k"]) <= \
        trace.MAX_SCAN_STEPS < trace.scan_steps(m, SHAPES["train_4k"])


def test_cli_traces_both_meshes(tmp_path, capsys):
    """qwen1.5-0.5b's decode cell at full width on both production meshes
    (its train cell's trace takes minutes on the 512-rank mesh, where
    DTensor plans its redistributions over three mesh dimensions)."""
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                 "--mesh", "both", "--device", "cpu", "--out",
                 str(tmp_path)])
    ok = 0
    for path in sorted(tmp_path.iterdir()):
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            continue
        ok += 1
        for tag in ("single", "multi"):
            dev = rec["per_device"][tag]
            assert dev["status"] == "ok", dev.get("error")
            assert dev["memory"]["argument_size_in_bytes"] == \
                dev["argument_bytes"]
            assert dev["cost"]["flops"] > 0
            assert dev["collectives"]["total_bytes"] > 0
            assert dev["fits_card_traced"] is None
    assert ok == 1
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].count("(traced:") == 2
