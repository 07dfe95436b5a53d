"""Plain-torch versions of the port's kernels.

They compute what ``repro/kernels/ref.py`` computes.  The LUT evaluators
(a sum of minterms; for the 6-input layout a Shannon select on pin 5) work
on int32 bit patterns: lanes cross into torch as
``np.uint32 -> .view(np.int32)`` because torch's uint32 lacks ``~``, ``>>``
and ``index_copy_``.  ``bitplane_matmul_ref`` and ``flash_attention_ref``
keep the reference's float32 arithmetic and order of operations.  These
functions are the CPU path of :mod:`repro_torch.kernels.ops` and the
yardstick the CUDA kernels are held to on the card.
"""
from __future__ import annotations

import torch


def lut_eval_ref(inputs: torch.Tensor, tts: torch.Tensor) -> torch.Tensor:
    """``inputs[M, K, N]`` int32 lanes, ``tts[M]`` int32 truth tables
    (K <= 5) -> ``out[M, N]`` int32: out bit = tt[idx] where idx is the
    K-bit assignment read from the input lanes."""
    M, K, N = inputs.shape
    if K > 5:
        raise ValueError(f"lut_eval takes K <= 5 inputs, got {K}")
    out = torch.zeros((M, N), dtype=torch.int32, device=inputs.device)
    inv = ~inputs
    for m in range(1 << K):
        # 0 or -1 (all ones) per row: bit m of the table
        bit = -((tts >> m) & 1)
        term = torch.full((M, N), -1, dtype=torch.int32, device=inputs.device)
        for j in range(K):
            term = term & (inputs[:, j, :] if (m >> j) & 1 else inv[:, j, :])
        out = out | (bit[:, None] & term)
    return out


def lut_eval6_ref(inputs: torch.Tensor, tt_lo: torch.Tensor,
                  tt_hi: torch.Tensor) -> torch.Tensor:
    """Fused-layout 6-input LUT evaluation: ``inputs[M, 6, N]`` with the
    64-entry table split into pin5=0 (``tt_lo``) / pin5=1 (``tt_hi``)
    int32 words."""
    if inputs.shape[1] != 6:
        raise ValueError(f"lut_eval6 takes 6 input pins, got {inputs.shape}")
    g5 = inputs[:, :5, :]
    sel = inputs[:, 5, :]
    lo = lut_eval_ref(g5, tt_lo)
    hi = lut_eval_ref(g5, tt_hi)
    return (sel & hi) | (~sel & lo)


def bitplane_coeffs(n_planes: int) -> list[float]:
    """Two's-complement plane weights: ``2^b``, the top plane ``-2^(B-1)``."""
    return [-(2.0 ** (n_planes - 1)) if b == n_planes - 1 else 2.0 ** b
            for b in range(n_planes)]


def bitplane_matmul_ref(x: torch.Tensor, planes: torch.Tensor,
                        scale: torch.Tensor | None = None) -> torch.Tensor:
    """``x[M, K] @ W[K, N]`` where ``W = sum_b c_b * planes[b]`` (see
    :func:`bitplane_coeffs`).  planes: ``[B, K, N]`` in {0, 1}; scale:
    optional ``[N]`` dequantization scale.  Float32 throughout, W formed
    first in plane order, as the reference does."""
    w = torch.zeros(planes.shape[1:], dtype=torch.float32,
                    device=planes.device)
    for b, c in enumerate(bitplane_coeffs(planes.shape[0])):
        w = w + c * planes[b].float()
    y = x.float() @ w
    if scale is not None:
        y = y * scale[None, :]
    return y


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """``q[B, Hq, S, D]``, ``k/v[B, Hkv, T, D]`` with ``Hq % Hkv == 0``
    (query head h reads kv head ``h // (Hq // Hkv)``).  The queries sit at
    the tail of the sequence: query i is at position ``i + T - S``.
    Float32 logits: ``scale`` -> softcap ``c * tanh(s / c)`` -> mask with
    -1e30 -> softmax -> cast to q's dtype."""
    S, D = q.shape[2], q.shape[3]
    T = k.shape[2]
    G = q.shape[1] // k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kk) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[None, None], logits,
                         torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vv).to(q.dtype)
