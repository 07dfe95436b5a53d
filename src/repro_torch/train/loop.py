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

The step is eager and donates, as the reference's ``fit`` jits its step
with ``donate_argnums=(0, 1)``: the weights and the optimizer state are
updated in place (:func:`make_train_step`), so a step holds one train
state, not two.  ``fit`` steps the caller's weights themselves, as the
reference's donation consumes its caller's arrays: a caller that wants
its weights as they were hands ``fit`` a copy.

On a mesh the params are DTensors (``parallel.sharding.distribute``) and
the caller installs the activation rules; every rank builds the same
global batch and keeps its rows, reads the same metrics (they are
replicated), so every rank takes the same quarantine decisions, and the
checkpoints are gathered and written by rank 0 (``checkpoint.ckpt``).
"""
from __future__ import annotations

import logging
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import tree
from ..checkpoint import ckpt
from ..configs.base import ModelConfig
from ..data.pipeline import batch_for_step, to_device
from ..parallel.api import is_distributed
from . import step as _step
from .step import TrainConfig

log = logging.getLogger("repro_torch.train")


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    use_kernel: bool = True):
    """The step ``fit`` runs: :func:`repro_torch.train.step.make_train_step`
    with ``donate=True`` (the reference's ``jax.jit(train_step,
    donate_argnums=(0, 1))``)."""
    return _step.make_train_step(cfg, tcfg, use_kernel, donate=True)


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class FitConfig:
    """``ckpt_every``: save every that many steps and at the last; 0 saves
    none (a run whose train state is too large to write, such as a
    capacity check)."""
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
    """Train from ``params`` (the weights stepped in place) or the latest
    checkpoint under ``fitc.ckpt_dir`` to step ``fitc.steps`` on the
    device (or the mesh) the params lie on.  ``hooks``: callables
    ``h(step, metrics)`` after each good step.  Returns ``params``,
    ``opt_state``, the good steps' ``losses``, ``final_step`` and
    ``step_s``, each good step's wall in
    seconds (host clock from the batch's upload to the loss on the host,
    which waits for the device)."""
    tcfg = tcfg or TrainConfig()
    train_step, opt_init = make_train_step(cfg, tcfg, use_kernel=use_kernel)
    leaf = tree.leaves(params)[0]
    mesh = leaf.device_mesh if is_distributed(leaf) else None
    device = leaf.to_local().device if mesh is not None else leaf.device
    del leaf
    start = 0
    resume = ckpt.latest_step(fitc.ckpt_dir) is not None
    opt_state = opt_init(params)
    if resume:       # restored into new tensors, fit's own
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
                                         seed=fitc.seed), device, mesh)
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
        if fitc.ckpt_every > 0 and (step % fitc.ckpt_every == 0
                                    or step == fitc.steps):
            ckpt.save(fitc.ckpt_dir, step, (params, opt_state),
                      keep_last=fitc.keep_last)
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "final_step": step, "step_s": walls}
