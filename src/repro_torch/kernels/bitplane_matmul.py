"""Launcher for the CUDA bit-plane product (``csrc/bitplane_matmul.cu``),
which replaces the Pallas ``bitplane_matmul`` in
``repro/kernels/bitplane_matmul.py``.

``bitplane_matmul_cuda`` checks what the kernel takes — contiguous float32
CUDA tensors on one device, ``x[M, K]``, ``planes[B, K, N]`` with B >= 1,
``scale[N]`` — raises on anything else, allocates the output, launches on
PyTorch's current stream and raises if the launch is refused.  The
dispatch and the launch counter live in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: rows of x per CTA (the grid's second axis counts row tiles)
BLOCK_M = 64

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = build.load("bitplane_matmul")
    if not getattr(lib, "_typed", False):
        lib.bitplane_matmul_launch.argtypes = [_P, _P, _P, _P, _I64, _I64,
                                               _I64, _I64, _P]
        lib.bitplane_matmul_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def bitplane_matmul_cuda(x: torch.Tensor, planes: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """``x[M, K]``, ``planes[B, K, N]`` in {0, 1}, ``scale[N]`` ->
    ``y[M, N] = (x @ sum_b c_b planes[b]) * scale``, float32 on the card."""
    for name, t in (("x", x), ("planes", planes), ("scale", scale)):
        if t.device.type != "cuda":
            raise ValueError(f"bitplane_matmul_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or planes.dim() != 3 or scale.dim() != 1:
        raise ValueError("bitplane_matmul_cuda takes x[M, K], "
                         "planes[B, K, N], scale[N]")
    M, K = x.shape
    B, Kp, N = planes.shape
    if Kp != K or scale.shape[0] != N or B < 1:
        raise ValueError(f"shapes x {tuple(x.shape)}, planes "
                         f"{tuple(planes.shape)}, scale "
                         f"{tuple(scale.shape)} do not match")
    if -(-M // BLOCK_M) > 65535:
        raise ValueError(f"M = {M} exceeds the grid")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().bitplane_matmul_launch(
        x.data_ptr(), planes.data_ptr(), scale.data_ptr(), y.data_ptr(),
        M, K, N, B, stream)
    if err != 0:
        raise RuntimeError(f"bitplane_matmul launch failed: CUDA error {err}")
    return y
