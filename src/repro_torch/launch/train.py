"""End-to-end training driver (the port of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b [--smoke]
        [--steps 60] [--seq-len 128] [--batch 8] [--lr 3e-3]
        [--grad-accum 1] [--ckpt-dir DIR] [--device cuda]

Random weights from a seeded generator on the device, the synthetic data
stream (with frames for encdec and patch embeddings for vlm), AdamW with
the reference launcher's schedule (warmup 5 steps, cosine decay over the
run), and the fault-tolerant loop, which resumes from the latest
checkpoint under ``--ckpt-dir``.  Self-attention runs through the flash
kernel under autograd for the dense, moe, encdec and vlm families (MoE
layers on the capacity-dropped dispatch, their load-balance loss folded
in); the ssm and hybrid families train through the plain path (the SSD
kernel has no backward, in the reference as here).  On one card there is no mesh: ``--model-parallel`` takes only
1.  The default device is the card; without one it raises unless
``--device cpu`` is given.  Prints the loss and gradient norm every 10
steps and the final loss.
"""
from __future__ import annotations

import argparse
import logging

from ..configs.base import get_config
from ..device import resolve_device
from ..train.loop import FitConfig, default_ckpt_dir, fit
from ..train.optimizer import OptConfig
from ..train.step import TrainConfig
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
    if args.model_parallel != 1:
        raise ValueError("--model-parallel: one card has no mesh; only 1 "
                         f"is taken, got {args.model_parallel}")

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = make_params(cfg, device)
    tcfg = TrainConfig(
        opt=OptConfig(lr=args.lr, warmup_steps=5,
                      decay_steps=max(args.steps, 10)),
        grad_accum=args.grad_accum)
    fitc = FitConfig(steps=args.steps, seq_len=args.seq_len,
                     global_batch=args.batch, ckpt_dir=args.ckpt_dir)
    result = fit(cfg, params, fitc, tcfg,
                 hooks=[lambda s, m: print(
                     f"step {s:5d} loss {float(m['loss']):.4f} "
                     f"gnorm {float(m['grad_norm']):.3f}", flush=True)
                     if s % 10 == 0 else None],
                 use_kernel=cfg.family not in PLAIN_PATH_FAMILIES)
    print(f"final loss: {result['losses'][-1]:.4f} "
          f"(from {result['losses'][0]:.4f})")
    return result


if __name__ == "__main__":
    main()
