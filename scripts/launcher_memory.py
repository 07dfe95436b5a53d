"""What the train launcher holds through a step: a model's bf16 train
steps on a ``(1, 1)`` mesh over a group of one (the launcher's set-up:
seed-0 weights placed by ``param_specs``, AdamW at its defaults, the
activation rules, no checkpoint), run twice through ``fit``, each step
after the first read by ``chip_smoke.StepMemory`` (peak above the
start, temporaries, arguments):

- ``held``: the caller keeps its weights and hands ``fit`` a copy of
  them to step, as the launcher's weights lived beside ``fit``'s own copy
  before ``fit`` donated the caller's;
- ``donated``: ``fit`` steps the caller's weights in place, as the
  launcher's run does now and the reference's donation does.

    python scripts/launcher_memory.py [--arch deepseek-moe-16b]
        [--layers 4] [--steps 2] [--batch 2] [--seq-len 1024]
        [--device cuda]

One JSON line a mode, then one with the peaks' difference beside the
weights' bytes.  Off the card (``--device cpu``) only the losses.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def run(cfg, device, mode: str, steps: int, batch: int, seq: int) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch import tree
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import make_params
    from repro_torch.launch.train import PLAIN_PATH_FAMILIES
    from repro_torch.parallel.api import sharding_rules
    from repro_torch.parallel.sharding import (activation_rules, distribute,
                                               param_specs)
    from repro_torch.train.loop import FitConfig, fit
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import TrainConfig

    memory = cs.StepMemory(device)
    mesh = make_host_mesh(1, device)
    params = make_params(cfg, device)
    params = distribute(params, param_specs(cfg, mesh, params), mesh)
    weights = dryrun.nbytes(params)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5,
                                     decay_steps=max(steps, 10)))
    # no checkpoint written, and none to resume from: an empty directory
    fitc = FitConfig(steps=steps, seq_len=seq, global_batch=batch,
                     ckpt_every=0, ckpt_dir=tempfile.mkdtemp())
    given = params if mode == "donated" else tree.map(torch.clone, params)
    with sharding_rules(activation_rules(cfg, mesh)):
        res = fit(cfg, given, fitc, tcfg, hooks=[memory],
                  use_kernel=cfg.family not in PLAIN_PATH_FAMILIES)
    del res, params, given
    shutil.rmtree(fitc.ckpt_dir)
    cs._reset_peak(device)
    return {"mode": mode, "arch": cfg.name, "layers": cfg.n_layers,
            "weight_bytes": weights, **memory.worst(),
            "per_step": memory.per_step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--device", default=None)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)

    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import close_group, init_group

    cfg = get_config(args.arch)
    cfg = cs.cut_depth(cfg.smoke() if args.smoke else cfg, args.layers)
    device = init_group(args.device)
    try:
        recs = {m: run(cfg, device, m, args.steps, args.batch, args.seq_len)
                for m in ("held", "donated")}
    finally:
        close_group()
    for r in recs.values():
        print(json.dumps(r), flush=True)
    held, donated = recs["held"], recs["donated"]
    if "peak_bytes" in held:
        print(json.dumps({
            "peak_held_less_donated":
                held["peak_bytes"] - donated["peak_bytes"],
            "arguments_held_less_donated":
                held["argument_bytes"] - donated["argument_bytes"],
            "temp_held_less_donated":
                held["temp_bytes"] - donated["temp_bytes"],
            "weight_bytes": donated["weight_bytes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
