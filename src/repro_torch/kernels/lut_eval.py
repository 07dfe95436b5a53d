"""Launchers for the CUDA LUT-evaluation kernels (``csrc/lut_eval.cu``).

``lut_eval6_cuda`` runs the kernel that replaces the Pallas ``lut_eval6``
and ``lut_eval_cuda`` the one that replaces ``lut_eval`` (both in
``repro/kernels/lut_eval.py``).  Each checks what the kernel takes —
contiguous int32 CUDA tensors on one device, the right shapes — raises on
anything else, allocates the output, launches on PyTorch's current stream
and raises if the launch is refused.  The dispatch (and the launch
counters) live in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = build.load("lut_eval")
    if not getattr(lib, "_typed", False):
        lib.lut_eval6_launch.argtypes = [_P, _P, _P, _P, _I64, _I64, _P]
        lib.lut_eval6_launch.restype = ctypes.c_int
        lib.lut_eval_launch.argtypes = [_P, _P, _P, _I64, _I64, _I64, _P]
        lib.lut_eval_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, device: torch.device,
           shape: tuple) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32 bit patterns, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def lut_eval6_cuda(inputs: torch.Tensor, tt_lo: torch.Tensor,
                   tt_hi: torch.Tensor) -> torch.Tensor:
    """``inputs[M, 6, N]``, ``tt_lo[M]``, ``tt_hi[M]`` -> ``out[M, N]``,
    all int32 on one CUDA device."""
    if inputs.device.type != "cuda":
        raise ValueError(f"lut_eval6_cuda needs CUDA tensors, got "
                         f"{inputs.device}")
    if inputs.dim() != 3 or inputs.shape[1] != 6:
        raise ValueError(f"inputs must be [M, 6, N], got {tuple(inputs.shape)}")
    M, _, N = inputs.shape
    dev = inputs.device
    _check("inputs", inputs, dev, (M, 6, N))
    _check("tt_lo", tt_lo, dev, (M,))
    _check("tt_hi", tt_hi, dev, (M,))
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    if M * N:
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(_lib().lut_eval6_launch(
            inputs.data_ptr(), tt_lo.data_ptr(), tt_hi.data_ptr(),
            out.data_ptr(), M, N, stream), "lut_eval6")
    return out


def lut_eval_cuda(inputs: torch.Tensor, tts: torch.Tensor) -> torch.Tensor:
    """``inputs[M, K, N]`` (1 <= K <= 5), ``tts[M]`` -> ``out[M, N]``, all
    int32 on one CUDA device."""
    if inputs.device.type != "cuda":
        raise ValueError(f"lut_eval_cuda needs CUDA tensors, got "
                         f"{inputs.device}")
    if inputs.dim() != 3 or not 1 <= inputs.shape[1] <= 5:
        raise ValueError(f"inputs must be [M, K<=5, N], got "
                         f"{tuple(inputs.shape)}")
    M, K, N = inputs.shape
    dev = inputs.device
    _check("inputs", inputs, dev, (M, K, N))
    _check("tts", tts, dev, (M,))
    out = torch.empty((M, N), dtype=torch.int32, device=dev)
    if M * N:
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(_lib().lut_eval_launch(
            inputs.data_ptr(), tts.data_ptr(), out.data_ptr(), M, K, N,
            stream), "lut_eval")
    return out
