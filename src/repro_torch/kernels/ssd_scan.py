"""Launcher for the CUDA SSD scan (``csrc/ssd_scan.cu``), which replaces
the Pallas ``ssd_scan`` in ``repro/kernels/ssd_scan.py``.

``ssd_scan_cuda`` checks what the kernels take — CUDA tensors on one
device, ``x[Bb, L, H, P]``, ``B / C[Bb, L, N]`` of one type (float32 or
bfloat16), ``dt[Bb, L, H]`` and ``A[H]`` float32, a length that the chunk
``min(128, L)`` divides and a state width whose tiles fit in shared memory
— and raises on anything else.  x, dt, B and C are read in place through
their strides (B and C are column slices of the model's projection); A is
made contiguous.  It allocates the contiguous output, launches on
PyTorch's current stream and raises if a launch is refused.
:func:`variant` picks the kernel from the type and N:

* ``"mma"`` (bfloat16, N <= 128, the models' path): the chunk's products
  on the tensor cores, with the weight tile, x w_u and the copy of the
  state that C . h^T reads rounded to bfloat16
  (:func:`repro_torch.kernels.ref.ssd_scan_mma_ref` rounds alike).  The
  score tile C . B^T is formed once per (batch, chunk) by a first launch
  into a scratch that the CTAs of every head read.  A CTA owns
  :func:`p_block` P columns of one (batch, head).
* ``"ffma"`` (float32, or N > 128): float32 FFMA throughout.

The dispatch, the launch counter and the per-variant counts live in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import sm_count
from . import build

#: the reference kernel's chunk (``repro/kernels/ssd_scan.py``)
CHUNK = 128
#: the widest state the mma variant's registers hold
MMA_MAX_N = 128
#: shared memory a CTA may use on Hopper (227 KB)
MAX_SMEM = 232448

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    if not getattr(lib, "_typed", False):
        lib.ssd_scan_launch.argtypes = [
            ctypes.c_int, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
            _I64, _I64, ctypes.POINTER(_I64), _P]
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [_I64]
        lib.ssd_scan_smem_bytes.restype = _I64
        lib.ssd_scan_mma_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
            ctypes.POINTER(_I64), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            _P, _P]
        lib.ssd_scan_mma_launch.restype = ctypes.c_int
        lib.ssd_scan_mma_smem_bytes.argtypes = [_I64, _I64]
        lib.ssd_scan_mma_smem_bytes.restype = _I64
        lib.ssd_scan_scores_floats.argtypes = [_I64, _I64]
        lib.ssd_scan_scores_floats.restype = _I64
        lib._typed = True
    return lib


def variant(dtype: torch.dtype, N: int) -> str:
    """The kernel a call with inputs of ``dtype`` and state width ``N``
    launches."""
    return "mma" if dtype == torch.bfloat16 and N <= MMA_MAX_N else "ffma"


def p_block(Bb: int, H: int, P: int, n_sm: int = 132) -> int:
    """P columns per CTA of the mma variant: 32, or 16 where 32-wide
    blocks would give fewer than two CTAs per SM (hymba's 50 heads)."""
    return 32 if Bb * H * -(-P // 32) >= 2 * n_sm else 16


def staged_16b(t: torch.Tensor) -> bool:
    """Whether the mma variant may stage the rows of ``t`` (a bfloat16
    ``[..., cols]`` operand; x's P blocks start at multiples of 16) in
    16-byte pieces: unit stride along the last axis,
    16-byte aligned start and row strides, and whole pieces of
    columns."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.shape[-1] % 8 == 0)


def chunk_of(L: int) -> int:
    """The chunk of a scan of length L, ``min(128, L)``; raises
    ``ValueError`` unless it divides L, as the reference's kernel
    requires."""
    chunk = min(CHUNK, L)
    if chunk and L % chunk:
        raise ValueError(f"ssd_scan: sequence length {L} is not a multiple "
                         f"of the chunk {chunk}")
    return chunk


def check_shapes(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor
                 ) -> tuple[int, int, int, int, int]:
    """``(Bb, L, H, P, N)`` of a call the kernel takes; raises
    ``ValueError`` otherwise."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 \
            or C.dim() != 3:
        raise ValueError("ssd_scan takes x[Bb, L, H, P], dt[Bb, L, H], "
                         "A[H], B[Bb, L, N], C[Bb, L, N]")
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    if tuple(dt.shape) != (Bb, L, H) or tuple(A.shape) != (H,) \
            or tuple(B.shape) != (Bb, L, N) or tuple(C.shape) != (Bb, L, N):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)} do not match")
    chunk_of(L)
    return Bb, L, H, P, N


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The SSD scan on the card -> contiguous ``y[Bb, L, H, P]`` in x's
    type."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan_cuda needs CUDA tensors, {name} is "
                             f"on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan_cuda takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    Bb, L, H, P, N = check_shapes(x, dt, A, B, C)
    # the grid's second axis counts P blocks of 32 (ffma) or p_block (mma)
    if Bb * H >= 2**31 or -(-P // 16) > 65535:
        raise ValueError(f"grid too large: Bb * H = {Bb * H}, P = {P}")
    y = torch.empty((Bb, L, H, P), dtype=x.dtype, device=x.device)
    if N == 0:
        raise ValueError("ssd_scan_cuda needs a state width N >= 1")
    if y.numel() == 0:
        return y
    lib = _lib()
    kind = variant(x.dtype, N)
    pb = p_block(Bb, H, P, sm_count(x.device.index))
    smem = lib.ssd_scan_mma_smem_bytes(N, pb) if kind == "mma" \
        else lib.ssd_scan_smem_bytes(N)
    if smem > MAX_SMEM:
        raise ValueError(f"state width N = {N} needs {smem} bytes of shared "
                         f"memory per CTA, above {MAX_SMEM}")
    A = A.contiguous()
    strides = (_I64 * 13)(*x.stride(), *dt.stride(), *B.stride(),
                          *C.stride())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    Q = chunk_of(L)
    if kind == "mma":
        scores = torch.empty((lib.ssd_scan_scores_floats(Bb, L // Q),),
                             dtype=torch.float32, device=x.device)
        vec = (ctypes.c_int * 3)(*(int(staged_16b(t)) for t in (x, B, C)))
        err = lib.ssd_scan_mma_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), Bb, L, H, P, N, Q, strides, vec, pb,
            scores.data_ptr(), stream)
    else:
        err = lib.ssd_scan_launch(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), Bb, L, H, P, N, Q,
            strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    return y
