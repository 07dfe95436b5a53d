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
meshes.  A sequential SSD scan's closed-form trace equals its stepwise
trace in every count, the temporaries' peak included, for prefill and
train (with remat, as the production configs train), for mamba2 and
hymba, on a mesh of one and on ``(4, 2)``; its record says how its scan
was counted.
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
         ("hymba-1.5b", "long_500k"), ("mamba2-2.7b", "prefill_32k"),
         ("hymba-1.5b", "train_4k")]
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


#: the closed-form vs stepwise cases: (arch, [kind, batch, seq_len]) at
#: smoke width, long enough that the scans' storages set the train
#: step's peak (a scan's step count past ``trace.STEPWISE_MAX``)
SCAN_CASES = [(arch, [kind, 8, seq]) for arch in ("mamba2-2.7b", "hymba-1.5b")
              for kind, seq in (("prefill", 96), ("train", 160))]
SCAN_MESHES = {"1x1": [1, 1], "4x2": MESH[0]}

SCAN_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs.base import get_config
from repro_torch.launch import trace

cases, sizes, names = (json.loads(a) for a in sys.argv[1:4])
trace.form_fake_group(max(2, sizes[0] * sizes[1]))
mesh = trace.fake_mesh(sizes, names)
stepwise_max = trace.STEPWISE_MAX
for arch, spec in cases:
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              remat=spec[0] == "train")
    for how, most in (("stepwise", 1 << 30), ("closed form", stepwise_max)):
        trace.STEPWISE_MAX = most
        rec = trace.trace_cell(cfg, trace.shape_of(spec), mesh)
        print(json.dumps({"cell": arch + "/" + spec[0], "how": how, **rec}),
              flush=True)
"""


def _run(script: str, *args) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", script, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _records(proc) -> list:
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def _gather(procs: list) -> list:
    """Each process's records (:func:`_records`); every process is
    stopped before this returns."""
    try:
        return [_records(p) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def runs():
    """``(reference records, (4, 2) traces, mesh-of-one traces)``."""
    return tuple({r.pop("cell"): r for r in recs} for recs in _gather([
        _run(REF_SCRIPT, json.dumps(CELLS)),
        _run(PORT_SCRIPT, json.dumps(CELLS), *map(json.dumps, MESH)),
        _run(PORT_SCRIPT, json.dumps([("qwen1.5-0.5b", "train_4k")]),
             json.dumps([1, 1]), json.dumps(MESH[1]))]))


@pytest.fixture(scope="module")
def scans():
    """``{mesh tag: {cell: {"stepwise": record, "closed form": record}}}``
    of ``SCAN_CASES``, one process per mesh."""
    out = {tag: {} for tag in SCAN_MESHES}
    for tag, recs in zip(SCAN_MESHES, _gather([
            _run(SCAN_SCRIPT, json.dumps(SCAN_CASES), json.dumps(sizes),
                 json.dumps(MESH[1])) for sizes in SCAN_MESHES.values()])):
        for rec in recs:
            out[tag].setdefault(rec.pop("cell"), {})[rec.pop("how")] = rec
    return out


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


def test_scan_budget(runs):
    """No cell is refused for its scans' length any more: the sequential
    SSD scan's steps per layer (the sequence, 1 at decode, none where the
    chunked form serves training), which each record of a step with such
    a scan states beside how it was counted."""
    m = get_config("mamba2-2.7b")
    assert trace.scan_steps(m, SHAPES["train_4k"]) == 4096
    assert trace.scan_steps(dataclasses.replace(m, ssd_chunk=256),
                            SHAPES["train_4k"]) == 0
    assert trace.scan_steps(m, SHAPES["long_500k"]) == 1
    assert trace.scan_steps(m, SHAPES["prefill_32k"]) == 32768
    assert trace.scan_steps(get_config("qwen1.5-0.5b"),
                            SHAPES["prefill_32k"]) == 0
    _, port, one = runs
    for cell, steps, how in (("mamba2-2.7b/train_4k", 4096, "closed form"),
                             ("mamba2-2.7b/prefill_32k", 32768,
                              "closed form"),
                             ("hymba-1.5b/train_4k", 4096, "closed form"),
                             ("hymba-1.5b/long_500k", 1, "stepwise")):
        rec = port[cell]
        assert rec["status"] == "ok", rec.get("error")
        # smoke width: 2 layers, no remat, so one scan a layer
        assert rec["scan"] == {"steps_per_layer": steps, "layers": 2,
                               "traced_calls": 2, "counted": [how]}, cell
        assert rec["flops_are"].startswith("per step x steps")
    assert "scan" not in port["qwen1.5-0.5b/train_4k"]
    assert "flops_are" not in one["qwen1.5-0.5b/train_4k"]


@pytest.mark.parametrize("mesh", list(SCAN_MESHES))
@pytest.mark.parametrize("arch,spec", SCAN_CASES)
def test_closed_form_scan_equals_stepwise(scans, mesh, arch, spec):
    """The closed-form trace of a step with sequential SSD scans equals
    the same step traced step by step: FLOPs, transcendentals, bytes
    accessed, collectives, the argument, output and alias bytes and the
    temporaries' peak, each exactly."""
    got = scans[mesh][f"{arch}/{spec[0]}"]
    step, closed = got["stepwise"], got["closed form"]
    train = spec[0] == "train"
    assert step["scan"]["counted"] == ["stepwise"]
    assert closed["scan"] == {"steps_per_layer": spec[2], "layers": 2,
                              # remat: the forward and its recompute
                              "traced_calls": 4 if train else 2,
                              "counted": ["closed form"]}
    assert closed["memory"] == step["memory"]
    assert closed["cost"] == step["cost"]
    assert closed["collectives"] == step["collectives"]
    assert closed["memory"]["temp_size_in_bytes"] > 0


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
