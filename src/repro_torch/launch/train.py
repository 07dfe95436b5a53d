"""End-to-end training driver (the port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b [--smoke]
        [--steps 60] [--seq-len 128] [--batch 8] [--lr 3e-3]
        [--grad-accum 1] [--model-parallel 1] [--ckpt-dir DIR]
        [--device cuda]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch tinyllama-1.1b --model-parallel 2

Builds the ``(data, model)`` mesh over every rank of the process group
(``launch.mesh.make_host_mesh``: one rank per card under ``torchrun``, a
mesh of one for a single process), places the parameters by
``parallel.sharding.param_specs`` as DTensors, and runs the
fault-tolerant loop under the activation rules, as the reference runs
``fit`` under ``sharding_rules`` (its step donating the train state,
which it updates in place).  Random weights from a seeded generator
on each rank's device (every rank draws the same ones and keeps its
shards), the synthetic data stream (with frames for encdec and patch
embeddings for vlm), AdamW with the reference launcher's schedule (warmup
5 steps, cosine decay over the run); the loop resumes from the latest
checkpoint under ``--ckpt-dir``.  Self-attention runs through the flash
kernel under autograd for the dense, moe, encdec and vlm families, each
rank on its own heads (MoE layers on the capacity-dropped dispatch, their
load-balance loss folded in); the ssm and hybrid families train through
the plain path (the SSD kernel has no backward, in the reference as
here).  ``--model-parallel`` must divide the number of ranks.  The
default device is the card (``cuda:<LOCAL_RANK>`` under ``torchrun``,
NCCL between ranks); without one it raises unless ``--device cpu`` is
given (gloo).  Rank 0 prints the loss and gradient norm every 10 steps and
the final loss.
"""
from __future__ import annotations

import argparse
import logging

import torch.distributed as dist

from ..configs.base import get_config
from ..parallel.api import sharding_rules
from ..parallel.sharding import activation_rules, distribute, param_specs
from ..train.loop import FitConfig, default_ckpt_dir, fit
from ..train.optimizer import OptConfig
from ..train.step import TrainConfig
from .mesh import close_group, init_group, make_host_mesh
from .serve import make_params

#: families whose forward has a kernel without a backward (``ssd_scan``)
PLAIN_PATH_FAMILIES = ("ssm", "hybrid")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    formed = not dist.is_initialized()
    try:
        return _train(args)
    finally:
        if formed:
            close_group()


def _train(args):
    device = init_group(args.device)
    world = dist.get_world_size()
    if args.model_parallel < 1 or world % args.model_parallel:
        raise ValueError(f"--model-parallel {args.model_parallel} does not "
                         f"divide the {world} ranks")
    mesh = make_host_mesh(args.model_parallel, device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = make_params(cfg, device)
    params = distribute(params, param_specs(cfg, mesh, params), mesh)
    lead = dist.get_rank() == 0
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=5,
                      decay_steps=max(args.steps, 10)),
        grad_accum=args.grad_accum)
    fitc = FitConfig(steps=args.steps, seq_len=args.seq_len,
                     global_batch=args.batch, ckpt_dir=args.ckpt_dir)
    with sharding_rules(activation_rules(cfg, mesh)):
        result = fit(cfg, params, fitc, tcfg,
                     hooks=[lambda s, m: print(
                         f"step {s:5d} loss {float(m['loss']):.4f} "
                         f"gnorm {float(m['grad_norm']):.3f}", flush=True)
                         if s % 10 == 0 and lead else None],
                     use_kernel=cfg.family not in PLAIN_PATH_FAMILIES)
    if lead:
        print(f"final loss: {result['losses'][-1]:.4f} "
              f"(from {result['losses'][0]:.4f})")
    return result


if __name__ == "__main__":
    main()
