"""Dry run of every (arch x shape) cell on one card (the port of
``repro/launch/dryrun.py``), allocating nothing.

    python -m repro_torch.launch.dryrun --all [--mesh both]
        [--out build/dryrun] [--force] [--device cpu]

For each cell a record ``<out>/<arch>__<shape>.json``: the parameter
count, the active parameters (a MoE layer's experts discounted to the k
chosen), the model FLOPs (6 N T for train, 2 N T for prefill, 2 N B for
decode), and the bytes of the arguments a step takes at their leaf
types — weights, optimizer state (AdamW; Adafactor for ``kimi*``, whose
AdamW state fits no mesh), cache and batch — taken from ``meta`` tensors
(:mod:`repro_torch.launch.specs`).  ``fits_one_card`` holds those bytes
against the card's memory (None with ``--device cpu``: no card to hold
them against); activations and workspace are not counted, so it is a
lower bound: a cell that does not fit by it fits by nothing (the traced
peak below counts the step's own bytes).
Beside them, the per-device argument bytes under the production
``(16, 16)`` and ``(2, 16, 16)`` meshes' specs
(:mod:`repro_torch.parallel.sharding`): each leaf's bytes divided by the
product of the sizes of the axes its spec shards it over.

The reference lowers and compiles each cell with XLA and reads its
memory and cost analyses and the collectives of the partitioned HLO.
The port traces each cell's real step instead (:mod:`.trace`, in worker
processes of their own, each over a fake process group of the mesh's
size; one for each two of the host's cores at once): ``per_device[mesh]``
gains the reference's ``memory`` (``argument_size_in_bytes``, equal to
``argument_bytes``; ``output_size_in_bytes``, ``alias_size_in_bytes``,
``temp_size_in_bytes``), ``cost`` (``flops``, ``transcendentals``,
``bytes accessed``, all per device) and ``collectives`` (count and result
bytes by kind, ``total_bytes``), with ``trace_s``, the trace's
``status`` (``"error"`` and its message where it failed) and
``fits_card_traced``: whether arguments and the step's peak together fit
the card (None with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .. import tree
from ..configs.base import (SHAPES, ModelConfig, get_config, list_configs,
                            shape_applicable)
from ..device import resolve_device
from ..parallel.sharding import (Spec, batch_specs, cache_specs, dp_axes,
                                 opt_specs, param_specs, spec_paths,
                                 spec_shards)
from ..train.optimizer import OptConfig, make_optimizer
from .mesh import Mesh, make_production_mesh
from .specs import count_params, decode_specs, input_specs, params_shape

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = {"single": False, "multi": True}


def _active_params(cfg: ModelConfig, pshape) -> int:
    """6 N D convention: activated parameters only (a MoE layer's experts
    count ``top_k / n_experts`` of their weights)."""
    total = 0
    for path, leaf in tree.flatten_with_path(pshape):
        key = "/".join(str(k) for k in path)
        n = math.prod(leaf.shape)
        if cfg.is_moe and ("we_i" in key or "we_o" in key):
            n = int(n * cfg.top_k / cfg.n_experts)
        total += n
    return total


def _opt_config(cfg: ModelConfig) -> OptConfig:
    # AdamW's two float32 moments of a 1T-parameter model fit no mesh of
    # the production size: kimi takes factored second moments
    if cfg.name.startswith("kimi"):
        return OptConfig(name="adafactor")
    return OptConfig(name="adamw")


def nbytes(t) -> int:
    """The bytes of every leaf of a tree of (meta) tensors."""
    return sum(x.numel() * x.element_size() for x in tree.leaves(t))


def _sharded_bytes(shapes, specs, mesh: Mesh) -> int:
    """Per-device bytes of ``shapes`` laid out by ``specs`` on ``mesh``."""
    by_path = dict(spec_paths(specs))
    return sum(-(-x.numel() * x.element_size()
                 // spec_shards(by_path[path], mesh))
               for path, x in tree.flatten_with_path(shapes))


def _cell_args(cfg: ModelConfig, shape):
    """The step's arguments as meta tensors, by role: ``weights``,
    ``optimizer`` (train), ``cache`` (prefill, decode), ``batch``."""
    pshape = params_shape(cfg)
    args = {"weights": pshape}
    if shape.kind == "train":
        opt_init, _ = make_optimizer(_opt_config(cfg))
        args["optimizer"] = opt_init(pshape)
        args["batch"] = input_specs(cfg, shape)
    elif shape.kind == "prefill":
        from ..serve.kvcache import init_cache

        extra_len = cfg.n_patches if cfg.family == "vlm" else 0
        args["cache"] = init_cache(cfg, shape.global_batch,
                                   shape.seq_len + extra_len,
                                   encoder_len=cfg.encoder_seq or None,
                                   device="meta")
        args["batch"] = input_specs(cfg, shape)
    else:
        dspec = decode_specs(cfg, shape)
        args["cache"] = dspec["cache"]
        args["batch"] = {"tokens": dspec["tokens"], "pos": dspec["pos"]}
    return args


def _arg_specs(cfg: ModelConfig, mesh: Mesh, args: dict) -> dict:
    """Specs of every argument on ``mesh``, as the reference's
    ``in_shardings``: a prefill's frames or patches over the data axes,
    a decode step's position replicated."""
    out = {"weights": param_specs(cfg, mesh, args["weights"])}
    if "optimizer" in args:
        out["optimizer"] = opt_specs(cfg, mesh, out["weights"],
                                     args["optimizer"])
    if "cache" in args:
        out["cache"] = cache_specs(cfg, mesh, args["cache"])
    batch = dict(args["batch"])
    pos = batch.pop("pos", None)
    extras = {}
    if "cache" in args:   # prefill: frames / patches over the data axes
        extras = {k: batch.pop(k) for k in ("encoder_feats", "patch_embeds")
                  if k in batch}
    bspec = batch_specs(cfg, mesh, batch)
    bspec.update({k: Spec(dp_axes(mesh), None, None) for k in extras})
    if pos is not None:
        bspec["pos"] = Spec()
    out["batch"] = bspec
    return out


def cell_record(arch: str, shape_name: str, card_bytes: int | None = None,
                meshes=("single", "multi")) -> dict:
    """The record of one cell (``status`` "skipped" where the reference
    skips it)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    args = _cell_args(cfg, shape)
    n_params = count_params(args["weights"])
    n_active = _active_params(cfg, args["weights"])
    if shape.kind == "decode":
        flops = 2 * n_active * shape.global_batch
    else:
        T = shape.global_batch * shape.seq_len
        flops = (6 if shape.kind == "train" else 2) * n_active * T
    by_role = {role: nbytes(t) for role, t in args.items()}
    arg_bytes = sum(by_role.values())
    per_device = {}
    for tag in meshes:
        mesh = make_production_mesh(multi_pod=MESHES[tag])
        specs = _arg_specs(cfg, mesh, args)
        per_device[tag] = {
            "mesh": dict(mesh.shape), "n_devices": mesh.size,
            **{role: _sharded_bytes(args[role], specs[role], mesh)
               for role in args}}
        per_device[tag]["argument_bytes"] = sum(
            per_device[tag][role] for role in args)
    return {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "status": "ok", "global_batch": shape.global_batch,
        "seq_len": shape.seq_len, "n_params": n_params,
        "n_active_params": n_active, "model_flops": flops,
        "optimizer": (_opt_config(cfg).name if shape.kind == "train"
                      else None),
        "bytes": by_role, "argument_bytes": arg_bytes,
        "card_bytes": card_bytes,
        "fits_one_card": (None if card_bytes is None
                          else arg_bytes <= card_bytes),
        "activations_counted": False,
        "per_device": per_device}


def card_bytes_of(device) -> int | None:
    """The total memory of a CUDA ``device``; None for the host."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def run_cell(arch: str, shape_name: str, out_dir, card_bytes=None,
             meshes=("single", "multi"), force: bool = False) -> dict:
    """The cell's record, written to ``out_dir`` (read back from there
    unless ``force``)."""
    os.makedirs(out_dir, exist_ok=True)
    path = Path(out_dir) / f"{arch}__{shape_name}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())
    record = cell_record(arch, shape_name, card_bytes, meshes)
    path.write_text(json.dumps(record, indent=1))
    return record


#: trace processes at once: one for each two of the host's cores (a
#: trace runs one thread of Python)
TRACE_PROCESSES = max(1, (os.cpu_count() or 2) // 2)


def trace_records(cells: list, meshes=("single", "multi")) -> dict:
    """The trace of every ``(arch, shape)`` cell on every mesh,
    ``{(arch, shape, mesh): record}``: each mesh's cells split among
    ``TRACE_PROCESSES`` processes (:func:`.trace.start`), that many of
    them running at once."""
    from . import trace

    n = TRACE_PROCESSES
    tasks = [(tag, cells[i::n]) for tag in meshes for i in range(n)
             if cells[i::n]]

    def run(task):
        tag, part = task
        recs = trace.collect(trace.start(part, mesh=tag), part)
        return [(a, s, tag, r) for (a, s), r in zip(part, recs)]

    out = {}
    with ThreadPoolExecutor(n) as pool:
        for rows in pool.map(run, tasks):
            out.update({(a, s, tag): r for a, s, tag, r in rows})
    return out


def add_trace(record: dict, tag: str, trace: dict) -> dict:
    """``record`` with ``trace`` (a mesh's traced step) beside its
    per-device argument bytes, and whether the two fit the card."""
    dev = record["per_device"][tag]
    dev.update(trace)
    mem = trace.get("memory")
    card = record["card_bytes"]
    dev["fits_card_traced"] = None if (card is None or mem is None) else (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] <= card)
    return record


def _traced(record: dict, meshes) -> bool:
    return all("status" in record["per_device"].get(t, {}) for t in meshes)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--device", default=None,
                    help="the card whose memory fits_one_card is taken "
                         "against (default: the CUDA card; cpu: none)")
    args = ap.parse_args(argv)

    card = card_bytes_of(args.device)
    archs = list_configs() if args.all or not args.arch else [args.arch]
    archs = [a for a in archs if a != "kratos-dd"]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": ("single",), "multi": ("multi",),
              "both": ("single", "multi")}[args.mesh]
    records = {(arch, shape): run_cell(arch, shape, args.out, card, meshes,
                                       force=args.force)
               for arch in archs for shape in shapes}
    todo = [c for c, r in records.items() if r["status"] == "ok"
            and (args.force or not _traced(r, meshes))]
    for (arch, shape, tag), t in trace_records(todo, meshes).items():
        r = add_trace(records[(arch, shape)], tag, t)
        (Path(args.out) / f"{arch}__{shape}.json").write_text(
            json.dumps(r, indent=1))
    for r in records.values():
        print(f"[{r['arch']:18s} {r['shape']:12s}] {r['status']}: "
              f"{_summary(r)}", flush=True)


def _summary(r: dict) -> str:
    """A record in a line: counts and argument bytes, then each mesh's
    traced step where there is one."""
    if r["status"] != "ok":
        return r.get("reason", "")
    out = [f"params={r['n_params']:.4g} flops={r['model_flops']:.3g} "
           f"args={r['argument_bytes'] / 2**30:.2f}GiB "
           f"fits={r['fits_one_card']}"]
    for tag, d in r["per_device"].items():
        out.append(f"{tag}/dev={d['argument_bytes'] / 2**30:.2f}GiB")
        if d.get("status") == "ok":
            mem = d["memory"]
            peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            out.append(f"(traced: flops={d['cost']['flops']:.3g} "
                       f"peak={peak / 2**30:.2f}GiB coll="
                       f"{d['collectives']['total_bytes'] / 2**20:.1f}MiB "
                       f"in {d['trace_s']:.1f}s)")
        elif d.get("status") == "error":
            out.append(f"(trace error: {d['error'][:120]})")
    return " ".join(out)


if __name__ == "__main__":
    main()
