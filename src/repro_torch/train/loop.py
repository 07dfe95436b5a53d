"""Fault-tolerant training loop (the port of ``repro/train/loop.py``).

* periodic atomic checkpointing (params + optimizer state + step),
* restart from the latest checkpoint on entry (crash -> relaunch ->
  resume),
* non-finite-loss quarantine: restore the last good checkpoint, skip the
  offending data window, continue; give up after ``max_bad_restarts``,
* straggler watch: a per-step wall-time EMA; steps slower than
  ``straggler_factor`` x EMA are logged,
* deterministic data: the pipeline is a pure function of the step, so
  recovery replays or skips exactly.

The step is eager.  The counterpart of the reference's donated buffers is
that params and optimizer state are rebound every step, so the previous
step's tensors are freed as soon as the new ones exist.
"""
from __future__ import annotations

import logging
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from .. import tree
from ..checkpoint import ckpt
from ..configs.base import ModelConfig
from ..data.pipeline import batch_for_step, to_device
from .step import TrainConfig, make_train_step

log = logging.getLogger("repro_torch.train")


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class FitConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = field(default_factory=default_ckpt_dir)
    keep_last: int = 3
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    straggler_factor: float = 3.0
    max_bad_restarts: int = 3


def fit(cfg: ModelConfig, params, fitc: FitConfig,
        tcfg: TrainConfig | None = None, hooks=None,
        use_kernel: bool = True) -> dict:
    """Train from ``params`` (or the latest checkpoint under
    ``fitc.ckpt_dir``) to step ``fitc.steps`` on the device the params
    lie on.  ``hooks``: callables ``h(step, metrics)`` after each good
    step.  Returns ``params``, ``opt_state``, the good steps' ``losses``,
    ``final_step`` and ``step_s``, each good step's wall in seconds (host
    clock from the batch's upload to the loss on the host, which waits
    for the device)."""
    tcfg = tcfg or TrainConfig()
    train_step, opt_init = make_train_step(cfg, tcfg, use_kernel=use_kernel)
    device = tree.leaves(params)[0].device
    opt_state = opt_init(params)

    start = 0
    if ckpt.latest_step(fitc.ckpt_dir) is not None:
        (params, opt_state), start = ckpt.restore(fitc.ckpt_dir,
                                                  (params, opt_state))
        log.info("resumed from step %d", start)

    ema = None
    bad_restarts = 0
    losses, walls = [], []
    step = start
    while step < fitc.steps:
        t0 = time.perf_counter()
        batch = to_device(batch_for_step(cfg, fitc.seq_len,
                                         fitc.global_batch, step,
                                         seed=fitc.seed), device)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        if not np.isfinite(loss):
            bad_restarts += 1
            log.warning("non-finite loss at step %d (restart %d)", step,
                        bad_restarts)
            if bad_restarts > fitc.max_bad_restarts:
                raise RuntimeError("too many non-finite-loss restarts")
            if ckpt.latest_step(fitc.ckpt_dir) is not None:
                (params, opt_state), good = ckpt.restore(
                    fitc.ckpt_dir, (params, opt_state))
                step = good + 1  # skip the bad window
                continue
            step += 1
            continue
        losses.append(loss)
        walls.append(dt)
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        if dt > fitc.straggler_factor * ema:
            log.warning("straggler step %d: %.3fs vs ema %.3fs", step, dt,
                        ema)
        if hooks:
            for h in hooks:
                h(step, metrics)
        step += 1
        if step % fitc.ckpt_every == 0 or step == fitc.steps:
            ckpt.save(fitc.ckpt_dir, step, (params, opt_state),
                      keep_last=fitc.keep_last)
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "final_step": step, "step_s": walls}
