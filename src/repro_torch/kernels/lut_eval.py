"""Launchers for the CUDA LUT-evaluation kernels (``csrc/lut_eval.cu``).

``lut_eval6_cuda`` runs the kernel that replaces the Pallas ``lut_eval6``
and ``lut_eval_cuda`` the one that replaces ``lut_eval`` (both in
``repro/kernels/lut_eval.py``); ``lut_eval6_level_cuda`` runs one whole
LUT level of the fused evaluator in place on the value buffer (the
reference's gather -> ``lut_eval6`` -> scatter, one launch).  Each checks
what the kernel takes — contiguous CUDA tensors on one device, int32 lane
words, int64 indices, the right shapes — raises on anything else, launches
on PyTorch's current stream and raises if the launch is refused.  The
6-input kernels stream four lane words per 128-bit access where
:func:`vector_width` allows it, one word otherwise.  The dispatch (and the
launch counters) live in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("lut_eval")
    if not getattr(lib, "_typed", False):
        lib.lut_eval6_launch.argtypes = [_P, _P, _P, _P, _I64, _I64, _INT,
                                         _P]
        lib.lut_eval6_launch.restype = _INT
        lib.lut_eval6_level_launch.argtypes = [_P, _P, _P, _P, _P, _I64,
                                               _I64, _INT, _P]
        lib.lut_eval6_level_launch.restype = _INT
        lib.lut_eval6_words_per_thread.argtypes = [_INT]
        lib.lut_eval6_words_per_thread.restype = _INT
        lib.lut_eval_launch.argtypes = [_P, _P, _P, _I64, _I64, _I64, _P]
        lib.lut_eval_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(name: str, t: torch.Tensor, device: torch.device,
           shape: tuple, dtype: torch.dtype = torch.int32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def vector_width(N: int, *lanes: torch.Tensor) -> int:
    """Lane words per access of the 6-input kernels: 4 (128-bit loads and
    stores) when every row of ``N`` words of each lane tensor starts
    16-byte aligned, else 1."""
    if N % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in lanes):
        return 4
    return 1


def words_per_thread(vec: int) -> int:
    """Lane words each thread of a 6-input kernel evaluates, as the
    compiled library reports it."""
    return int(_lib().lut_eval6_words_per_thread(vec))


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
        vec = vector_width(N, inputs, out)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(_lib().lut_eval6_launch(
            inputs.data_ptr(), tt_lo.data_ptr(), tt_hi.data_ptr(),
            out.data_ptr(), M, N, vec, stream), "lut_eval6")
    return out


def lut_eval6_level_cuda(vals: torch.Tensor, ins_idx: torch.Tensor,
                         tt_lo: torch.Tensor, tt_hi: torch.Tensor,
                         out_idx: torch.Tensor) -> torch.Tensor:
    """One LUT level in place: ``vals[out_idx[m]] = LUT_m(vals[ins_idx[m,
    0..5]])`` for the ``M`` LUTs of ``ins_idx[M, 6]`` / ``out_idx[M]``
    (int64) with tables ``tt_lo[M]`` / ``tt_hi[M]`` (int32), over the
    value buffer ``vals[R, N]`` (int32), all on one CUDA device.  Returns
    ``vals``.

    The caller guarantees what the evaluator's plans hold: every index
    lies in ``[0, R)``, and no LUT reads a row that a LUT of the same call
    writes; rows written more than once (the padding's sink) must receive
    the same value from every writer."""
    if vals.device.type != "cuda":
        raise ValueError(f"lut_eval6_level_cuda needs CUDA tensors, got "
                         f"{vals.device}")
    if vals.dim() != 2 or ins_idx.dim() != 2 or ins_idx.shape[1] != 6:
        raise ValueError(f"vals must be [R, N] and ins_idx [M, 6], got "
                         f"{tuple(vals.shape)} and {tuple(ins_idx.shape)}")
    R, N = vals.shape
    M = ins_idx.shape[0]
    dev = vals.device
    _check("vals", vals, dev, (R, N))
    _check("ins_idx", ins_idx, dev, (M, 6), torch.int64)
    _check("tt_lo", tt_lo, dev, (M,))
    _check("tt_hi", tt_hi, dev, (M,))
    _check("out_idx", out_idx, dev, (M,), torch.int64)
    if M * N:
        vec = vector_width(N, vals)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(_lib().lut_eval6_level_launch(
            vals.data_ptr(), ins_idx.data_ptr(), tt_lo.data_ptr(),
            tt_hi.data_ptr(), out_idx.data_ptr(), M, N, vec, stream),
            "lut_eval6_level")
    return vals


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
