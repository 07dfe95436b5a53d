"""Dispatch for the LUT-evaluation kernels (the port of
``repro/kernels/ops.py``'s ``lut_eval`` / ``lut_eval6``).

``use_kernel`` mirrors the reference's ``use_pallas``:

* a CUDA tensor with ``use_kernel=True`` launches the CUDA kernel — or
  raises; there is no fallback;
* a CUDA tensor with ``use_kernel=False`` runs the plain-torch version on
  the card (only the parity checks ask for this);
* a CPU tensor runs the plain-torch version.

Each wrapper counts its kernel launches in a plain integer attribute
(``lut_eval6.launches``, ``lut_eval.launches``), incremented where the
kernel launches and nowhere else, so a run can show which path it took.
Lanes are int32 bit patterns (see :mod:`repro_torch.kernels.ref`).
"""
from __future__ import annotations

import torch

from . import ref


def _wants_kernel(inputs: torch.Tensor, use_kernel: bool) -> bool:
    return use_kernel and inputs.device.type == "cuda"


def lut_eval(inputs: torch.Tensor, tts: torch.Tensor,
             use_kernel: bool = True) -> torch.Tensor:
    """``inputs[M, K, N]`` int32 lanes (K <= 5) + ``tts[M]`` ->
    ``out[M, N]``."""
    if _wants_kernel(inputs, use_kernel):
        from .lut_eval import lut_eval_cuda

        out = lut_eval_cuda(inputs, tts)
        if out.numel():  # an empty call launches nothing
            lut_eval.launches += 1
        return out
    return ref.lut_eval_ref(inputs, tts)


def lut_eval6(inputs: torch.Tensor, tt_lo: torch.Tensor, tt_hi: torch.Tensor,
              use_kernel: bool = True) -> torch.Tensor:
    """``inputs[M, 6, N]`` int32 lanes + split 64-entry tables ->
    ``out[M, N]``."""
    if _wants_kernel(inputs, use_kernel):
        from .lut_eval import lut_eval6_cuda

        out = lut_eval6_cuda(inputs, tt_lo, tt_hi)
        if out.numel():  # an empty call launches nothing
            lut_eval6.launches += 1
        return out
    return ref.lut_eval6_ref(inputs, tt_lo, tt_hi)


lut_eval.launches = 0
lut_eval6.launches = 0


def reset_launch_counts() -> None:
    lut_eval.launches = 0
    lut_eval6.launches = 0


def launch_counts() -> dict[str, int]:
    return {"lut_eval6": lut_eval6.launches, "lut_eval": lut_eval.launches}
