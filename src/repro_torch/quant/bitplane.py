"""Double-Duty bitplane quantization (the port of
``repro/quant/bitplane.py``).

``quantize_bitplanes`` decomposes a weight matrix into b binary planes and
a per-column scale (two's complement, top plane weighted -2^(b-1)): the
selector-bit decomposition of the paper's unrolled constant-weight
multiplication.  ``bitplane_linear`` runs ``x @ W`` through
:func:`repro_torch.kernels.ops.bitplane_matmul` (the CUDA kernel on a CUDA
tensor).  ``plane_sparsity`` is the fraction of zero selector bits, the
quantity the paper's row-skip optimization exploits.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.ref import bitplane_coeffs


def quantize_bitplanes(w: torch.Tensor, bits: int = 4):
    """w ``[K, N]`` float -> (planes ``[bits, K, N]`` in {0, 1} float32,
    scale ``[N]`` float32)."""
    maxq = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(w.abs().amax(dim=0), min=1e-8) / maxq
    q = torch.clamp(torch.round(w / scale[None, :]), -(maxq + 1), maxq)
    q_uint = q.to(torch.int32) % (1 << bits)
    planes = torch.stack([(q_uint >> b) & 1 for b in range(bits)]).float()
    return planes, scale.float()


def dequantize(planes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    w = torch.zeros(planes.shape[1:], dtype=torch.float32,
                    device=planes.device)
    for b, c in enumerate(bitplane_coeffs(planes.shape[0])):
        w = w + c * planes[b]
    return w * scale[None, :]


def bitplane_linear(x: torch.Tensor, planes: torch.Tensor,
                    scale: torch.Tensor, use_kernel: bool = True
                    ) -> torch.Tensor:
    """``y = x @ W_quant`` through the bit-plane kernel; x ``[..., K]``."""
    shp = x.shape
    x2 = x.reshape(-1, shp[-1]).float().contiguous()
    y = ops.bitplane_matmul(x2, planes, scale, use_kernel=use_kernel)
    return y.reshape(*shp[:-1], planes.shape[-1])


def plane_sparsity(planes: torch.Tensor) -> torch.Tensor:
    """Fraction of zero selector bits (the paper's row-skip opportunity)."""
    return 1.0 - planes.mean()


def quantize_tree(params, bits: int = 4, min_size: int = 1 << 16):
    """Quantize every large 2-D weight in nested dicts of tensors; returns
    the same dicts with each such weight replaced by
    ``{"planes", "scale"}`` and everything else passed through."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, bits, min_size)
                for k, v in params.items()}
    if params.dim() == 2 and params.numel() >= min_size:
        planes, scale = quantize_bitplanes(params.float(), bits)
        return {"planes": planes, "scale": scale}
    return params
