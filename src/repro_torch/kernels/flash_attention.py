"""Launcher for the CUDA attention kernel (``csrc/flash_attention.cu``),
which replaces the Pallas ``_flash_fwd`` in
``repro/kernels/flash_attention.py``.

``flash_attention_cuda`` checks what the kernel takes — CUDA tensors on one
device, float32 or bfloat16, ``q[B, Hq, S, D]`` and ``k/v[B, Hkv, T, D]``
with ``Hq % Hkv == 0``, ``T >= S``, an instantiated head dimension and a
contiguous last axis — and raises on anything else.  The other axes may
have any strides, so a KV cache sliced along time (and viewed as
``[B, H, T, D]``) is read in place.  It allocates the output, launches on
PyTorch's current stream and raises if the launch is refused.  The
dispatch and the launch counter live in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: head dimensions the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: query rows per CTA (the grid's second axis counts query tiles)
BLOCK_Q = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = [
            _I32, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
            ctypes.POINTER(_I64), _F32, _I32, _F32, _I32, _I32, _I64, _P]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int | None) -> tuple[int, int, int, int, int, int]:
    """``(B, Hq, Hkv, S, T, D)`` of a call the kernel takes; raises
    ``ValueError`` otherwise."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, S, D]")
    B, Hq, S, D = q.shape
    Bk, Hkv, T, Dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or Bk != B or Dk != D:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq = {Hq} is not a multiple of Hkv = {Hkv}")
    if T < S:
        raise ValueError(f"T = {T} < S = {S}: the queries sit at the tail "
                         "of the keys")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dimension {D} is not instantiated "
                         f"(kernel takes {HEAD_DIMS})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return B, Hq, Hkv, S, T, D


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Attention of ``q[B, Hq, S, D]`` over ``k/v[B, Hkv, T, D]`` on the
    card -> ``[B, Hq, S, D]`` in q's type.  The result is a view of a
    ``[B, S, Hq, D]`` tensor (the port's activation layout), so
    ``.transpose(1, 2)`` of it is contiguous."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                        f"got {q.dtype}")
    B, Hq, Hkv, S, T, D = check_shapes(q, k, v, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    n_q_tiles = -(-S // BLOCK_Q)
    if B * Hq >= 2**31 or n_q_tiles > 65535:
        raise ValueError(f"grid too large: B * Hq = {B * Hq}, "
                         f"{n_q_tiles} query tiles")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    if scale is None:
        scale = D ** -0.5
    strides = (_I64 * 12)(*(s for t in (q, k, v, out)
                            for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, S, T, D, strides, float(scale),
        int(softcap is not None), float(softcap or 0.0), int(bool(causal)),
        int(window is not None), int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
