"""Launcher for the CUDA binary matrix product
(``csrc/popcount_matmul.cu``), which replaces the Pallas
``popcount_matmul`` in ``repro/kernels/popcount_matmul.py``.

``popcount_matmul_cuda`` checks what the kernel takes — contiguous int32
CUDA tensors (packed words as bit patterns) on one device, ``x[M, W]``,
``w[N, W]``, mode "and" or "xnor" (with ``k_bits``) — raises on anything
else, allocates the output, launches on PyTorch's current stream and
raises if the launch is refused.  It has one kernel, :func:`variant`'s
``"tensor_core"``: the exact integer product of the unpacked 0/1 bits on
the int8 tensor cores, with mode "xnor" from the identity of
:func:`repro_torch.kernels.ref.popcount_matmul_bits_ref`, at every M,
N, W and k_bits.  The dispatch, the launch counter and the per-variant count live in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: rows of x per CTA (the grid's second axis counts row tiles)
BLOCK_M = 128

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_MODES = {"and": 0, "xnor": 1}


def variant(M: int, N: int, W: int) -> str:
    """The kernel a call of ``[M, W] x [N, W]`` words launches: the
    tensor-core product at every shape."""
    return "tensor_core"


def _lib() -> ctypes.CDLL:
    lib = build.load("popcount_matmul")
    if not getattr(lib, "_typed", False):
        lib.popcount_matmul_launch.argtypes = [
            _P, _P, _P, _I64, _I64, _I64, ctypes.c_int, ctypes.c_int, _P]
        lib.popcount_matmul_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def popcount_matmul_cuda(x_packed: torch.Tensor, w_packed: torch.Tensor,
                         mode: str = "and", k_bits: int | None = None
                         ) -> torch.Tensor:
    """``x_packed[M, W]``, ``w_packed[N, W]`` int32 words ->
    ``int32[M, N]`` on the card."""
    if mode not in _MODES:
        raise ValueError(mode)
    if mode == "xnor" and k_bits is None:
        raise ValueError("mode 'xnor' needs k_bits")
    for name, t in (("x_packed", x_packed), ("w_packed", w_packed)):
        if t.device.type != "cuda":
            raise ValueError(f"popcount_matmul_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.device != x_packed.device:
            raise ValueError(f"{name} is on {t.device}, x_packed on "
                             f"{x_packed.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 bit patterns, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x_packed.dim() != 2 or w_packed.dim() != 2 \
            or x_packed.shape[1] != w_packed.shape[1]:
        raise ValueError(f"popcount_matmul_cuda takes x[M, W], w[N, W]; got "
                         f"{tuple(x_packed.shape)}, {tuple(w_packed.shape)}")
    M, W = x_packed.shape
    N = w_packed.shape[0]
    if -(-M // BLOCK_M) > 65535:
        raise ValueError(f"M = {M} exceeds the grid")
    y = torch.empty((M, N), dtype=torch.int32, device=x_packed.device)
    if W == 0:
        raise ValueError("popcount_matmul_cuda needs W >= 1 words")
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x_packed.device).cuda_stream
    err = _lib().popcount_matmul_launch(
        x_packed.data_ptr(), w_packed.data_ptr(), y.data_ptr(), M, N, W,
        _MODES[mode], int(k_bits or 0), stream)
    if err != 0:
        raise RuntimeError(f"popcount_matmul launch failed: CUDA error {err}")
    return y
