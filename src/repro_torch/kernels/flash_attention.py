"""Launcher for the CUDA attention kernels (``csrc/flash_attention.cu``),
which replace the Pallas ``_flash_fwd`` in
``repro/kernels/flash_attention.py``.

``flash_attention_cuda`` checks what the kernels take — CUDA tensors on one
device, float32 or bfloat16, ``q[B, Hq, S, D]`` and ``k/v[B, Hkv, T, D]``
with ``Hq % Hkv == 0``, ``T >= S``, an instantiated head dimension, a
contiguous last axis and rows that start on 16-byte boundaries (every
variant copies them with 16-byte ``cp.async``) — and raises on anything
else.  The other axes may have any strides, so a KV cache
sliced along time (and viewed as ``[B, H, T, D]``) is read in place.  It
allocates the output (and the split variant's partials), launches on
PyTorch's current stream and raises if a launch is refused.
:func:`variant` picks the kernel:

* ``"tf32x3"`` (float32): tensor cores at float32 accuracy, 128 query
  rows per CTA up to D = 64 (two 16-row tiles a warp), 64 above
  (:func:`block_q`): each operand split into two tf32 parts
  (:func:`repro_torch.kernels.ref.split_tf32`), each product three tf32
  passes that drop only lo x lo, each tile's P.V summed apart before it
  joins the running output;
* ``"mma"`` (bfloat16, ``G * S > 16``): tensor cores, 64 query rows per
  CTA;
* ``"split"`` (bfloat16, ``G * S <= 16``, i.e. decode): the keys split
  over CTAs of one kv group each (:func:`split_plan`), then a fixed-order
  combine (:func:`repro_torch.kernels.ref.flash_attention_split_ref` is
  its plain version).

The dispatch, the launch counter and the per-variant counts live in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..device import sm_count
from . import build

#: head dimensions the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: query rows per CTA of the mma variant and of tf32x3 from D = 128 (the
#: grid's second axis counts query tiles; see :func:`block_q`)
BLOCK_Q = 64
#: query rows one split CTA holds (G * S of them: one 16-row mma tile)
SPLIT_ROWS = 16
#: keys per split are a multiple of one warp's 16-key share of a tile
SPLIT_KEY_QUANTUM = 16
#: split CTAs wanted per SM, where that many fit at once
SPLIT_CTAS_PER_SM = 2

_VARIANTS = {"tf32x3": 0, "mma": 1, "split": 2}
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float


def variant(dtype: torch.dtype, S: int, G: int) -> str:
    """The kernel a call launches: ``"tf32x3"`` for float32, else
    ``"split"`` when the ``G * S`` query rows of a kv group fit one
    16-row tile (decode), else ``"mma"``."""
    if dtype == torch.float32:
        return "tf32x3"
    return "split" if G * S <= SPLIT_ROWS else "mma"


def block_q(kind: str, D: int) -> int:
    """Query rows per CTA of the ``mma`` and ``tf32x3`` variants: tf32x3
    up to D = 64 gives each of its 4 warps two 16-row tiles, so that each
    K and V fragment is split once for both; the rest one."""
    return 2 * BLOCK_Q if kind == "tf32x3" and D <= 64 else BLOCK_Q


def split_plan(B: int, Hkv: int, S: int, T: int, window: int | None,
               slots: int = 2 * 132) -> tuple[int, int, int]:
    """``(k_first, keys_per_split, n_splits)`` of the split variant.

    ``k_first`` is the first key any of the S tail queries can see (keys
    before it are masked for all of them).  The ``T - k_first`` keys are
    cut into splits of a multiple of 16 keys, as few as fill the ``slots``
    CTAs wanted at a time (:func:`split_slots`) with the grid of
    ``B * Hkv * n_splits`` CTAs and no more: one wave, each CTA streaming
    as many keys as the others (one split per group when the groups alone
    outnumber the slots; a single split writes the output itself)."""
    k_first = max(0, T - S - window + 1) if window is not None else 0
    n_keys = T - k_first
    want = max(1, slots // (B * Hkv))
    per_split = -(-n_keys // want)
    kps = -(-per_split // SPLIT_KEY_QUANTUM) * SPLIT_KEY_QUANTUM
    return k_first, kps, -(-n_keys // kps)


@functools.lru_cache(maxsize=None)
def split_slots(index: int, D: int) -> int:
    """Split CTAs wanted at once on card ``index`` at head dimension
    ``D``: ``SPLIT_CTAS_PER_SM`` per SM, or as many as fit (the kernel's
    blocks per SM from the CUDA occupancy calculator: one at D = 256)."""
    per_sm = _lib().flash_split_blocks_per_sm(D)
    if per_sm < 1:
        raise RuntimeError(f"flash split kernel: no occupancy at D = {D} "
                           f"({per_sm})")
    return min(SPLIT_CTAS_PER_SM, per_sm) * sm_count(index)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = [
            _I32, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
            ctypes.POINTER(_I64), _F32, _I32, _F32, _I32, _I32, _I64, _I64,
            _I64, _I64, _P, _P, _P, _P]
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_split_blocks_per_sm.argtypes = [_I64]
        lib.flash_split_blocks_per_sm.restype = ctypes.c_int
        lib._typed = True
    return lib


def check_row_alignment(*named: tuple[str, torch.Tensor]) -> None:
    """Raise unless every row of each ``[B, H, S, D]`` tensor starts on a
    16-byte boundary: an aligned base pointer, and strides that are
    multiples of 16 bytes on the axes longer than 1."""
    for name, t in named:
        nbytes = t.element_size()
        shape, stride = t.shape, t.stride()
        bad = [ax for ax in range(3)
               if shape[ax] > 1 and (stride[ax] * nbytes) % 16]
        if t.data_ptr() % 16 or bad:
            raise ValueError(
                f"{name}: the kernels copy rows with 16-byte loads; "
                f"its data pointer is {t.data_ptr() % 16} bytes past a "
                f"16-byte boundary and the strides {t.stride()[:3]} of its "
                f"axes {bad} are not multiples of 16 bytes")


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
    card = q.get_device()  # -1 on the host; comparing ints is cheap
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.get_device() != card:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_cuda takes float32 or bfloat16, "
                        f"got {q.dtype}")
    B, Hq, Hkv, S, T, D = check_shapes(q, k, v, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    kind = variant(q.dtype, S, Hq // Hkv)
    check_row_alignment(("q", q), ("k", k), ("v", v))
    if T >= 2**31 - 1:
        raise ValueError(f"T = {T} keys exceed the kernels' int positions")
    if window is not None:
        window = min(window, T + 1)  # a wider window masks nothing
    out = torch.empty((B, S, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    plan, parts = (0, 0, 0), (0, 0, 0)
    if kind == "split":
        plan = split_plan(B, Hkv, S, T, window, split_slots(card, D))
        n_slots = B * Hkv * plan[2] * (Hq // Hkv) * S
        grid = (B * Hkv, plan[2])
        if plan[2] > 1:  # one split writes the output itself
            # one float32 buffer: m [n_slots], l [n_slots], acc [n_slots, D]
            buf = torch.empty(n_slots * (D + 2), dtype=torch.float32,
                              device=q.device)
            base = buf.data_ptr()
            parts = (base, base + 4 * n_slots, base + 8 * n_slots)
    else:
        grid = (B * Hq, -(-S // block_q(kind, D)))
    if grid[0] >= 2**31 or grid[1] > 65535:
        raise ValueError(f"grid too large for the {kind} variant: {grid}")
    if scale is None:
        scale = D ** -0.5
    strides = (_I64 * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                          *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        _VARIANTS[kind], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, S, T, D, strides, float(scale),
        int(softcap is not None), float(softcap or 0.0), int(bool(causal)),
        int(window is not None), int(window or 0), *plan, *parts, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention ({kind}) launch failed: CUDA "
                           f"error {err}")
    return out
