"""Checkpoints with atomic commits, on the reference's on-disk format (the
port of ``repro/checkpoint/ckpt.py``), so a checkpoint written by either
package restores in the other.

Layout::

    <dir>/step_<N:08d>/
        manifest.json      # step, leaf paths, shapes, dtypes, extra
        arrays.npz         # one entry per leaf

A leaf's key is its path joined with ``/`` as the reference's
``jax.tree_util.tree_flatten_with_path`` names it (dict keys, tuple
indices): ``0/blocks/wq``, ``1/mu/embed``, ``1/count`` for ``(params,
opt_state)``.  bfloat16 leaves are stored as float32 (exact; numpy has no
bfloat16).  A save writes into a temporary directory and renames it into
place, so a crash mid-write never leaves a partial ``step_`` directory;
the ``keep_last`` newest are kept.

On a mesh (DTensor leaves) a save gathers each leaf whole
(``full_tensor()``, a collective every rank joins), rank 0 alone writes
the same files, and every rank waits at a barrier before the old steps are
collected, so no rank reads a step that is not yet in place.  A restore
places each leaf as its template leaf lies: a DTensor template leaf on its
mesh in its placements (the reference's ``shardings``), which may differ
from the mesh the checkpoint was saved from; a plain one on its device or
on ``device``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .. import tree
from ..device import resolve_device
from ..parallel.api import is_distributed

SEP = "/"


def _flatten(nested) -> dict:
    return {SEP.join(str(k) for k in path): leaf
            for path, leaf in tree.flatten_with_path(nested)}


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()  # lossless upcast for npz
        return t.numpy()
    return np.asarray(t)


def save(directory: str, step: int, nested, keep_last: int = 3,
         extra: dict | None = None) -> str:
    flat = _flatten(nested)
    final = os.path.join(directory, f"step_{step:08d}")
    on_mesh = any(is_distributed(v) for v in flat.values())
    writer = not on_mesh or dist.get_rank() == 0
    arrays = {}
    for k, v in flat.items():   # one leaf gathered at a time
        v = v.full_tensor() if is_distributed(v) else v
        if writer:
            arrays[k] = _to_numpy(v)
        del v
    if writer:
        _write(directory, final, step, arrays, extra)
    if on_mesh:
        dist.barrier()
    if writer:
        _gc(directory, keep_last)
    return final


def _write(directory: str, final: str, step: int, arrays: dict,
           extra: dict | None) -> None:
    """The arrays and manifest into a temporary directory, renamed into
    place as ``final``."""
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                       for k, a in arrays.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _gc(directory: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def restore(directory: str, template, step: int | None = None,
            device=None):
    """``(tree, step)``: the checkpoint at ``step`` (the latest by
    default) in ``template``'s nesting, each leaf in its template leaf's
    type, on ``device`` (resolved by :func:`repro_torch.device.
    resolve_device`) or, by default, on its template leaf's device; a
    DTensor template leaf's on its mesh in its placements, each rank
    keeping its own piece.  Leaves are read one at a time, each moved to
    its device before the next is read, so the host holds one leaf, not
    the whole state."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    dev = None if device is None else resolve_device(device)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        stored = set(z.files)
        for key, tmpl in _flatten(template).items():
            if key not in stored:
                raise KeyError(f"checkpoint missing leaf {key}")
            a = z[key]
            if list(a.shape) != list(tmpl.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{a.shape} vs {tuple(tmpl.shape)}")
            leaves.append(_place(torch.from_numpy(a), tmpl, dev))
            del a
    return tree.unflatten(template, leaves), step


def _place(t: torch.Tensor, tmpl, dev):
    """A restored leaf in its template leaf's type, where the template
    leaf lies (or on ``dev``)."""
    if is_distributed(tmpl):
        from torch.distributed.tensor import distribute_tensor

        local_dev = tmpl.to_local().device if dev is None else dev
        return distribute_tensor(t.to(device=local_dev, dtype=tmpl.dtype),
                                 tmpl.device_mesh, tmpl.placements,
                                 src_data_rank=None)
    return t.to(device=tmpl.device if dev is None else dev, dtype=tmpl.dtype)
