"""Launcher for the CUDA bit-plane product (``csrc/bitplane_matmul.cu``),
which replaces the Pallas ``bitplane_matmul`` in
``repro/kernels/bitplane_matmul.py``.

``bitplane_matmul_cuda`` checks what the kernels take — contiguous float32
CUDA tensors on one device, ``x[M, K]``, ``planes[B, K, N]`` with B >= 1,
``scale[N]`` — raises on anything else, allocates the output and the
scratch, launches on PyTorch's current stream and raises if a launch is
refused.  :func:`variant` picks the kernel from B and M:

* ``"tensor_core"`` (B <= 8, M > 16): bf16 tensor-core passes over the
  exact three-way bf16 split of x (``ref.split_bf16x3``) and the planes
  folded into a bf16 W.  It assumes that ``planes`` holds only 0 and 1, as
  the function's contract says: then W is an integer in [-128, 127] and
  bfloat16 holds it exactly.  Other values are not checked (a check would
  cost a pass over the planes) and would be rounded.
* ``"small_m"`` (B <= 8, M <= 16): a streaming kernel over (N slice x K
  slice) CTAs (:func:`small_m_splits`) and a fixed-order sum of the
  slices.
* ``"ffma"`` (B > 8): the float32 FFMA tiled product.

The dispatch, the launch counter and the per-variant counts live in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import sm_count
from . import build

#: rows of x up to which the streaming small-M kernel runs
SMALL_M = 16
#: planes up to which W fits bfloat16 exactly (|W| <= 128)
MAX_BF16_PLANES = 8
#: the tensor-core kernel's CTA tile (M, N) and its k step
TC_TILE_M, TC_TILE_N, TC_TILE_K = 128, 256, 32
#: the FFMA kernel's rows per CTA (the grid's second axis counts row tiles)
BLOCK_M = 64
#: threads per small-M CTA, each owning 4 (or 1) columns
SMALL_M_THREADS = 64
#: small-M CTAs wanted per SM, and the longest K slice (x rows of a slice
#: sit in shared memory: 16 x 512 floats = 32 KB)
SMALL_M_CTAS_PER_SM = 4
SMALL_M_MAX_SLICE = 512

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def variant(M: int, B: int) -> str:
    """The kernel a call with ``M`` rows and ``B`` planes launches."""
    if B > MAX_BF16_PLANES:
        return "ffma"
    return "small_m" if M <= SMALL_M else "tensor_core"


def small_m_splits(K: int, N: int, vec: int, n_sm: int = 132
                   ) -> tuple[int, int]:
    """``(n_splits, rows_per_split)`` of the small-M kernel's K slices:
    enough slices that the (column block x slice) grid holds
    ``SMALL_M_CTAS_PER_SM`` CTAs per SM, and none longer than
    ``SMALL_M_MAX_SLICE``."""
    col_blocks = -(-N // (SMALL_M_THREADS * vec))
    want = max(-(-SMALL_M_CTAS_PER_SM * n_sm // col_blocks),
               -(-K // SMALL_M_MAX_SLICE))
    kps = max(1, K // want)
    return -(-K // kps), kps


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _lib() -> ctypes.CDLL:
    lib = build.load("bitplane_matmul")
    if not getattr(lib, "_typed", False):
        lib.bitplane_ffma_launch.argtypes = [_P, _P, _P, _P, _I64, _I64,
                                             _I64, _I64, _P]
        lib.bitplane_tc_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I64,
                                           _I64, _I64, _I64, _I64, _I64,
                                           _I64, _P]
        lib.bitplane_small_m_launch.argtypes = [_P, _P, _P, _P, _P, _I64,
                                                _I64, _I64, _I64, _I64,
                                                _I64, ctypes.c_int, _P]
        for fn in (lib.bitplane_ffma_launch, lib.bitplane_tc_launch,
                   lib.bitplane_small_m_launch):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def bitplane_matmul_cuda(x: torch.Tensor, planes: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """``x[M, K]``, ``planes[B, K, N]`` in {0, 1}, ``scale[N]`` ->
    ``y[M, N] = (x @ sum_b c_b planes[b]) * scale``, float32 on the card,
    through the kernel :func:`variant` names."""
    card = x.get_device()  # -1 on the host; comparing ints is cheap
    for name, t in (("x", x), ("planes", planes), ("scale", scale)):
        if not t.is_cuda:
            raise ValueError(f"bitplane_matmul_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.get_device() != card:
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
    if Kp != K or scale.shape[0] != N or B < 1 or K < 1:
        raise ValueError(f"shapes x {tuple(x.shape)}, planes "
                         f"{tuple(planes.shape)}, scale "
                         f"{tuple(scale.shape)} do not match")
    kind = variant(M, B)
    row_tile = {"ffma": BLOCK_M, "tensor_core": TC_TILE_M}.get(kind, 1)
    if -(-M // row_tile) > 65535:
        raise ValueError(f"M = {M} exceeds the grid")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    if kind == "ffma":
        err = lib.bitplane_ffma_launch(
            x.data_ptr(), planes.data_ptr(), scale.data_ptr(), y.data_ptr(),
            M, K, N, B, stream)
    elif kind == "tensor_core":
        Mp, Kp, Np = (_round_up(M, TC_TILE_M), _round_up(K, TC_TILE_K),
                      _round_up(N, TC_TILE_N))
        x3 = torch.empty((3, Mp, Kp), dtype=torch.bfloat16, device=x.device)
        w = torch.empty((Kp, Np), dtype=torch.bfloat16, device=x.device)
        err = lib.bitplane_tc_launch(
            x.data_ptr(), planes.data_ptr(), scale.data_ptr(), y.data_ptr(),
            x3.data_ptr(), w.data_ptr(), M, K, N, B, Mp, Kp, Np, stream)
    else:
        vec = 4 if N % 4 == 0 and planes.data_ptr() % 16 == 0 else 1
        n_splits, kps = small_m_splits(K, N, vec, sm_count(card))
        part = torch.empty((n_splits, M, N), dtype=torch.float32,
                           device=x.device)
        err = lib.bitplane_small_m_launch(
            x.data_ptr(), planes.data_ptr(), scale.data_ptr(), y.data_ptr(),
            part.data_ptr(), M, K, N, B, kps, n_splits, vec, stream)
    if err != 0:
        raise RuntimeError(f"bitplane_matmul ({kind}) launch failed: CUDA "
                           f"error {err}")
    return y
