"""Plain-torch versions of the LUT-evaluation kernels.

They compute exactly what ``repro/kernels/ref.py`` computes (a sum of
minterms; for the 6-input layout a Shannon select on pin 5) on int32 bit
patterns: lanes cross into torch as ``np.uint32 -> .view(np.int32)``
because torch's uint32 lacks ``~``, ``>>`` and ``index_copy_``.  They are
the CPU path of :mod:`repro_torch.kernels.ops` and the yardstick the CUDA
kernels are held to, bit for bit, on the card.
"""
from __future__ import annotations

import torch


def lut_eval_ref(inputs: torch.Tensor, tts: torch.Tensor) -> torch.Tensor:
    """``inputs[M, K, N]`` int32 lanes, ``tts[M]`` int32 truth tables
    (K <= 5) -> ``out[M, N]`` int32: out bit = tt[idx] where idx is the
    K-bit assignment read from the input lanes."""
    M, K, N = inputs.shape
    if K > 5:
        raise ValueError(f"lut_eval takes K <= 5 inputs, got {K}")
    out = torch.zeros((M, N), dtype=torch.int32, device=inputs.device)
    inv = ~inputs
    for m in range(1 << K):
        # 0 or -1 (all ones) per row: bit m of the table
        bit = -((tts >> m) & 1)
        term = torch.full((M, N), -1, dtype=torch.int32, device=inputs.device)
        for j in range(K):
            term = term & (inputs[:, j, :] if (m >> j) & 1 else inv[:, j, :])
        out = out | (bit[:, None] & term)
    return out


def lut_eval6_ref(inputs: torch.Tensor, tt_lo: torch.Tensor,
                  tt_hi: torch.Tensor) -> torch.Tensor:
    """Fused-layout 6-input LUT evaluation: ``inputs[M, 6, N]`` with the
    64-entry table split into pin5=0 (``tt_lo``) / pin5=1 (``tt_hi``)
    int32 words."""
    if inputs.shape[1] != 6:
        raise ValueError(f"lut_eval6 takes 6 input pins, got {inputs.shape}")
    g5 = inputs[:, :5, :]
    sel = inputs[:, 5, :]
    lo = lut_eval_ref(g5, tt_lo)
    hi = lut_eval_ref(g5, tt_hi)
    return (sel & hi) | (~sel & lo)
