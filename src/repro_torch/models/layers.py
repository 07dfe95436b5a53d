"""Model primitives (the port of ``repro/models/layers.py``).

Activations keep the reference's layout, ``[B, S, H, D]`` for heads, and
its order of operations and float32 upcasts.  ``attention`` is the
dispatch: by default every call goes through
:func:`repro_torch.kernels.ops.flash_attention`, which launches the CUDA
kernel on a CUDA tensor and runs the plain version on a CPU tensor;
``use_kernel=False`` runs :func:`attention_ref`, the reference's masked
attention, and exists for the parity checks.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "float64": torch.float64}[name]


def wide_type(dtype: torch.dtype) -> torch.dtype:
    """float32, the reference's upcast, or float64 for float64: the plain
    dense path then runs wholly in float64 for the training gate's
    yardstick (``compute_dtype="float64"``)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def wide(t: torch.Tensor) -> torch.Tensor:
    return t.to(wide_type(t.dtype))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = wide(x)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + wide(w))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """x: ``[..., S, H, D]``; positions: ``[..., S]``."""
    d = x.shape[-1]
    half = d // 2
    ft = wide_type(x.dtype)
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=ft,
                                          device=x.device) / half))
    ang = positions[..., :, None].to(ft) * freqs[None, :]
    cos = torch.cos(ang)[..., :, None, :]   # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None, kv_len=None, q_positions=None):
    """Masked multi-head attention on ``[B, S, H, D]`` layout with GQA.

    ``kv_len``: optional ``[B]`` active cache lengths (decode).
    ``q_positions``: optional ``[B, Sq]`` absolute positions of queries.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    T = k.shape[1]
    dev = q.device
    if scale is None:
        scale = D ** -0.5
    qh = q.reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bskgd,btkd->bkgst", wide(qh), wide(k)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if q_positions is None:
        qpos = torch.arange(Sq, device=dev)[None, :] + (T - Sq)
        qpos = qpos.expand(B, Sq)
    else:
        qpos = q_positions
    kpos = torch.arange(T, device=dev)[None, :]
    mask = torch.ones((B, Sq, T), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        mask = mask & (kpos[:, None, :] > qpos[:, :, None] - window)
    if kv_len is not None:
        mask = mask & (kpos[:, None, :] < kv_len[:, None, None])
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.tensor(-1e30, device=dev))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, wide(v))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _prefix_len(kv_len, q_positions, S: int) -> int:
    """The kv prefix a cached call attends over, for the kernel route.

    The kernel places the queries at the tail of the keys it is given, so
    the reference's masked attention over a cache equals the kernel over
    the cache's first ``kv_len`` keys exactly when ``kv_len`` is the same
    for every row and the queries sit at ``kv_len - S + arange(S)``.
    Anything else raises: there is no fallback."""
    if kv_len is None:
        raise ValueError("the kernel route needs kv_len with q_positions")
    lens = kv_len.tolist() if isinstance(kv_len, torch.Tensor) else [kv_len]
    if len(set(lens)) != 1:
        raise ValueError(f"kv_len is not uniform across the batch: {lens}")
    end = int(lens[0])
    if q_positions is not None:
        want = torch.arange(end - S, end, device=q_positions.device)
        if not bool((q_positions == want).all()):
            raise ValueError("q_positions must be kv_len - S + arange(S) on "
                             "every row for the kernel route")
    return end


def attention(cfg: ModelConfig, q, k, v, *, causal=True, window=None,
              softcap=None, scale=None, kv_len=None, q_positions=None,
              use_kernel: bool = True):
    """Attention on ``[B, S, H, D]``: the flash kernel (plain version on a
    CPU tensor) over the first ``kv_len`` keys, or with
    ``use_kernel=False`` the reference's :func:`attention_ref`."""
    if cfg.chunked_local_attn:
        raise NotImplementedError(
            "chunked_local_attn (local_chunked_attention) is not ported")
    if not use_kernel:
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, kv_len=kv_len,
                             q_positions=q_positions)
    if kv_len is not None or q_positions is not None:
        end = _prefix_len(kv_len, q_positions, q.shape[1])
        k, v = k[:, :end], v[:, :end]
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, softcap=softcap, scale=scale)
    return out.transpose(1, 2)


def glu_ffn(x, wi, wo, act: str):
    """wi: ``[d, 2F]`` fused gate+up; wo: ``[F, d]``."""
    h = x @ wi
    gate, up = torch.chunk(h, 2, dim=-1)
    if act == "swiglu":
        g = F.silu(wide(gate)).to(x.dtype)
    elif act == "geglu":
        g = F.gelu(wide(gate), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(act)
    return (g * up) @ wo


#: a stacked leaf with more elements than this (8 GiB as float32) is drawn
#: one layer slice at a time into a tensor of its own type: llava-next-34b's
#: FFN ``wi`` would be a 70 GB float32 draw.  No leaf of the dense, ssm or
#: hybrid configs is that large, so their draws are whole leaves.
SLICE_DRAW_NUMEL = 1 << 31


def init_dense(gen: torch.Generator, shape, dtype, scale=None):
    """Normal weights scaled by ``fan_in ** -0.5`` (or ``scale``), drawn
    in float32 from ``gen`` on its device and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = fan_in ** -0.5

    def draw(sh):
        w = torch.randn(sh, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (w * scale).to(dtype)

    if len(shape) < 3 or math.prod(shape) <= SLICE_DRAW_NUMEL:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = draw(shape[1:])
    return out
