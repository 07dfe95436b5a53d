"""Carry model weights across packages as numpy.

The JAX package's parameters are nested dicts of arrays with the same
names and stacked ``[L, ...]`` shapes as this package's, so they cross as
a dict map: :func:`params_from_numpy` turns nested dicts of numpy arrays
(``np.asarray`` of each jax array) into tensors, and
:func:`params_to_numpy` is its inverse.  Optimizer states cross the same
way (:func:`opt_state_from_numpy`, :func:`opt_state_to_numpy`): AdamW's
``{mu, nu, count}`` and Adafactor's ``{v, count}``, ``v`` holding each
parameter's ``{vr, vc}`` or ``{v}``.  The tests use them so that both
packages compute with the same weights and start from the same state.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (cast to ``dtype`` when given).  bfloat16 arrays (numpy's
    ``ml_dtypes`` extension type) are widened to float32 before they cross
    and keep their type on this side unless ``dtype`` says otherwise.
    Without ``dtype`` every leaf keeps its own type, so the SSD's float32
    ``dt_bias``, ``a_log`` and ``d_skip`` stay float32 beside bfloat16
    weights, as in the reference."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    a = np.asarray(tree)
    want = dtype
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        want = dtype or torch.bfloat16
    t = torch.from_numpy(np.array(a)).to(device)  # a writable copy
    return t if want is None else t.to(want)


def params_to_numpy(tree):
    """Nested dicts of tensors -> the same dicts of numpy arrays on the
    host.  bfloat16 tensors come back as float32 (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _check_opt_state(tree) -> None:
    if not isinstance(tree, dict) or set(tree) not in (
            {"mu", "nu", "count"}, {"v", "count"}):
        raise ValueError("not an AdamW {mu, nu, count} or Adafactor "
                         f"{{v, count}} state: keys {sorted(tree)}")


def opt_state_from_numpy(tree, device):
    """An AdamW or Adafactor state as nested dicts of numpy arrays ->
    the same dicts of tensors on ``device``, each leaf in its own type
    (float32 moments, the int32 step count)."""
    _check_opt_state(tree)
    return params_from_numpy(tree, device)


def opt_state_to_numpy(tree):
    """The inverse of :func:`opt_state_from_numpy`."""
    _check_opt_state(tree)
    return params_to_numpy(tree)
