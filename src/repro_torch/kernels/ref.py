"""Plain-torch versions of the port's kernels.

They compute what ``repro/kernels/ref.py`` computes.  The LUT evaluators
(a sum of minterms; for the 6-input layout a Shannon select on pin 5) and
``popcount_matmul_ref`` work on int32 bit patterns: lanes and packed words
cross into torch as ``np.uint32 -> .view(np.int32)`` because torch's
uint32 lacks ``~``, ``>>`` and ``index_copy_``.  ``bitplane_matmul_ref``,
``flash_attention_ref`` and the SSD scans keep the reference's float32
arithmetic and order of operations; ``flash_attention_split_ref``,
``popcount_matmul_bits_ref`` and ``ssd_scan_mma_ref`` are the same
functions summed and rounded as the split attention, the tensor-core
binary product and the tensor-core SSD scan compute them;
``split_bf16x3`` and ``split_tf32`` are the operand splits of the exact
bit-plane product and of the float32 attention.  These
functions are the CPU path of :mod:`repro_torch.kernels.ops` and the
yardstick the CUDA kernels are held to on the card; they are never
``torch.compile``d.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _popc64(v: torch.Tensor) -> torch.Tensor:
    """SWAR population count of int64 values below 2^32."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def popcount_matmul_ref(x_packed: torch.Tensor, w_packed: torch.Tensor,
                        mode: str = "and", k_bits: int | None = None
                        ) -> torch.Tensor:
    """``x_packed[M, W]`` and ``w_packed[N, W]`` int32 bit patterns hold K
    bits packed into W = ceil(K/32) words -> ``int32[M, N]``.

    mode "and":  y[m, n] = sum_k x[m, k] & w[n, k]   (0/1 weights)
    mode "xnor": y[m, n] = K - 2 * popcount(x ^ w)   (+/-1 weights)

    The words are widened to int64 (the low 32 bits, so no sign bit) and
    counted word by word, as the reference's kernel loops over W."""
    if mode not in ("and", "xnor"):
        raise ValueError(mode)
    if mode == "xnor" and k_bits is None:
        raise ValueError("mode 'xnor' needs k_bits")
    M, W = x_packed.shape
    N, W2 = w_packed.shape
    if W != W2:
        raise ValueError(f"word counts differ: {W} and {W2}")
    x = x_packed.to(torch.int64) & _M32
    w = w_packed.to(torch.int64) & _M32
    acc = torch.zeros((M, N), dtype=torch.int64, device=x_packed.device)
    for i in range(W):
        xi, wi = x[:, i, None], w[None, :, i]
        acc += _popc64(xi & wi if mode == "and" else xi ^ wi)
    if mode == "xnor":
        acc = k_bits - 2 * acc
    return acc.to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Packed int32 words ``[R, W]`` -> their ``32 W`` bits ``[R, 32 W]``
    as int64 0 / 1, bit k of word j at column ``32 j + k``."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = ((words.to(torch.int64) & _M32)[:, :, None] >> shifts) & 1
    return bits.reshape(words.shape[0], -1)


def popcount_matmul_bits_ref(x_packed: torch.Tensor, w_packed: torch.Tensor,
                             mode: str = "and", k_bits: int | None = None
                             ) -> torch.Tensor:
    """:func:`popcount_matmul_ref` summed as the tensor-core kernel sums
    it: the integer product of the unpacked 0 / 1 bits, ``a = x . w``
    over all ``32 W`` bits, and for mode "xnor" the identity
    ``popc(x ^ w) = popc(x) + popc(w) - 2 popc(x & w)``, so
    ``y = k_bits - 2 (popc(x row) + popc(w row)) + 4 a``.  The product
    runs in float64, exact for sums below 2^53."""
    if mode not in ("and", "xnor"):
        raise ValueError(mode)
    if mode == "xnor" and k_bits is None:
        raise ValueError("mode 'xnor' needs k_bits")
    if x_packed.shape[1] != w_packed.shape[1]:
        raise ValueError(f"word counts differ: {x_packed.shape[1]} and "
                         f"{w_packed.shape[1]}")
    xb, wb = unpack_bits(x_packed), unpack_bits(w_packed)
    a = (xb.double() @ wb.double().T).to(torch.int64)
    if mode == "xnor":
        a = k_bits - 2 * (xb.sum(1)[:, None] + wb.sum(1)[None, :]) + 4 * a
    return a.to(torch.int32)


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


def lut_eval6_level_ref(vals: torch.Tensor, ins_idx: torch.Tensor,
                        tt_lo: torch.Tensor, tt_hi: torch.Tensor,
                        out_idx: torch.Tensor) -> torch.Tensor:
    """One LUT level of the fused evaluator in place on ``vals[R, N]``:
    gather the pins ``vals[ins_idx]`` (``[M, 6, N]``), evaluate them with
    :func:`lut_eval6_ref` and ``index_copy_`` the rows to ``out_idx``
    (the reference's ``_fused_body`` LUT half).  Returns ``vals``."""
    return vals.index_copy_(0, out_idx,
                            lut_eval6_ref(vals[ins_idx], tt_lo, tt_hi))


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


def split_bf16x3(x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor-core bit-plane product's split of float32 ``x`` into
    bfloat16 ``hi, mid, lo`` (the kernel's ``split_x_kernel`` does the same
    arithmetic): ``hi + (mid + lo) == x`` exactly for normal floats whose
    ``lo`` is not subnormal in bfloat16, since each difference is exact in
    float32 and three parts hold 24 significant bits."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Finite float32 ``x`` rounded to tf32 (10 stored significand bits)
    to nearest, ties away from zero, as ``cvt.rna.tf32.f32`` and the
    kernels' ``sm90::tf32_rna`` round: on the int32 bit pattern, half a
    tf32 ulp added and the 13 low bits cleared.  Float32 out."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tf32x3 attention's split of float32 ``x`` (``sm90::split_tf32``
    does the same arithmetic): ``hi = tf32(x)``, ``lo = tf32(x - hi)``,
    both float32 with their 13 low significand bits zero.  ``x - hi`` is
    exact, so ``hi + lo`` is x to within half a tf32 ulp of ``lo``
    (about 2^-22 |x|)."""
    x = x.float()
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _attention_logits(q, k, causal, window, softcap, scale):
    """Float32 ``[B, Hq, S, T]`` logits of the tail queries: ``scale`` ->
    softcap ``c * tanh(s / c)`` -> mask with -1e30."""
    S, D = q.shape[2], q.shape[3]
    T = k.shape[2]
    G = q.shape[1] // k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kk = k.repeat_interleave(G, dim=1).float()
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
    return torch.where(mask[None, None], logits,
                       torch.tensor(-1e30, device=q.device))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """``q[B, Hq, S, D]``, ``k/v[B, Hkv, T, D]`` with ``Hq % Hkv == 0``
    (query head h reads kv head ``h // (Hq // Hkv)``).  The queries sit at
    the tail of the sequence: query i is at position ``i + T - S``.
    Float32 logits: ``scale`` -> softcap ``c * tanh(s / c)`` -> mask with
    -1e30 -> softmax -> cast to q's dtype."""
    G = q.shape[1] // k.shape[1]
    vv = v.repeat_interleave(G, dim=1).float()
    p = torch.softmax(_attention_logits(q, k, causal, window, softcap,
                                        scale), dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, vv).to(q.dtype)


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              window: int | None = None,
                              softcap: float | None = None,
                              scale: float | None = None, k_first: int = 0,
                              keys_per_split: int | None = None
                              ) -> torch.Tensor:
    """:func:`flash_attention_ref` computed as the split (decode) kernel
    computes it: the keys ``[k_first, T)`` cut into splits of
    ``keys_per_split`` (the last one ragged), each split's float32 partial
    ``(m, l, acc)`` over the same logits, then the partials combined in
    split order: ``m = max m_i``, ``l = sum l_i exp(m_i - m)``, ``acc =
    sum acc_i exp(m_i - m)``, out ``acc / max(l, 1e-30)``.  ``k_first``
    must not pass a key any query can see (the launcher's ``split_plan``
    gives the first such key)."""
    T = k.shape[2]
    G = q.shape[1] // k.shape[1]
    if keys_per_split is None:
        keys_per_split = T - k_first
    vv = v.repeat_interleave(G, dim=1).float()
    logits = _attention_logits(q, k, causal, window, softcap, scale)
    parts = []
    for a in range(k_first, T, keys_per_split):
        s = logits[..., a:a + keys_per_split]
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bhst,bhtd->bhsd", p,
                                   vv[:, :, a:a + keys_per_split])))
    m = torch.stack([mi for mi, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        f = torch.exp(mi - m)
        l = l + li * f
        acc = acc + ai * f
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def ssd_recurrence(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   h: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence step by step from the float32 state ``h``
    ``[Bb, H, P, N]`` (zeros when None): for each t,
    ``h = h * exp(A dt_t) + (dt_t x_t) B_t^T`` and ``y_t = h C_t``.
    Returns ``(y [Bb, L, H, P] float32, h)``.  The per-step factors are
    elementwise, so they are formed for all steps at once; the loop carries
    only the state."""
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    if h is None:
        h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    dtf = dt.float()
    decay = torch.exp(A.float()[None, None, :] * dtf)        # [Bb, L, H]
    dtx = dtf[..., None] * x.float()                          # [Bb, L, H, P]
    Bf, Cf = B.float(), C.float()
    ys = []
    # each input split into its L steps at once: a gradient then comes
    # back as one stack, not as L full-size tensors of one step each
    for dtx_t, dec_t, B_t, C_t in zip(dtx.unbind(1), decay.unbind(1),
                                      Bf.unbind(1), Cf.unbind(1)):
        upd = dtx_t[..., None] * B_t[:, None, None, :]
        h = h * dec_t[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_t))
    return torch.stack(ys, dim=1), h


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Sequential SSD (Mamba-2) scan, scalar A per head, B / C shared by
    the heads (G = 1): ``x[Bb, L, H, P]``, ``dt[Bb, L, H]`` > 0, ``A[H]``
    < 0, ``B / C[Bb, L, N]`` -> ``y[Bb, L, H, P]`` in x's type, with a
    float32 state carried over the L steps."""
    return ssd_recurrence(x, dt, A, B, C)[0].to(x.dtype)


def ssd_scan_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor,
                         chunk: int = 128) -> torch.Tensor:
    """Chunked (state-space dual) form of :func:`ssd_scan_ref`: L / chunk
    steps of dense intra-chunk products plus the state hand-off between
    chunks (arXiv:2405.21060 sec. 6).  Falls back to the sequential form
    when ``chunk`` does not divide L, as the reference does."""
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    if L % chunk:
        return ssd_scan_ref(x, dt, A, B, C)
    nc = L // chunk
    xf = x.float().reshape(Bb, nc, chunk, H, P)
    dtf = dt.float().reshape(Bb, nc, chunk, H)
    Bf = B.float().reshape(Bb, nc, chunk, N)
    Cf = C.float().reshape(Bb, nc, chunk, N)
    Af = A.float()
    t_idx = torch.arange(chunk, device=x.device)
    causal = t_idx[:, None] >= t_idx[None, :]
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(Af[None, None, :] * dtc, dim=1)     # [Bb, Q, H]
        y_state = torch.einsum("bqn,bhpn->bqhp", Cc, h) \
            * torch.exp(cum)[..., None]
        scores = torch.einsum("btn,bun->btu", Cc, Bc)           # [Bb, Q, Q]
        seg = cum[:, :, None, :] - cum[:, None, :, :]           # [Bb, Q, Q, H]
        # the masked branch is formed as the reference forms it; exp of the
        # unselected (positive) segments may overflow and is discarded
        w = torch.where(causal[None, :, :, None],
                        torch.exp(seg) * scores[..., None],
                        torch.zeros((), device=x.device)) \
            * dtc[:, None, :, :]
        ys.append(y_state + torch.einsum("btuh,buhp->bthp", w, xc))
        wu = torch.exp(cum[:, -1:, :] - cum) * dtc              # [Bb, Q, H]
        h = torch.exp(cum[:, -1])[..., None, None] * h \
            + torch.einsum("buhp,bun->bhpn", xc * wu[..., None], Bc)
    return torch.stack(ys, dim=1).reshape(Bb, L, H, P).to(x.dtype)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to bfloat16 (nearest even) and back."""
    return t.to(torch.bfloat16).float()


def ssd_scan_mma_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The chunked SSD scan (chunk ``min(128, L)``, which must divide L)
    rounded where the CUDA kernel's ``mma`` variant rounds: per chunk the
    weight tile ``W = where(t >= u, exp(cum[t] - cum[u]) s, 0) dt[u]``
    (exp formed only where t >= u), ``x w_u`` and the state that
    ``C . h^T`` reads are rounded to bfloat16; x, B and C enter as
    given (bfloat16 on the models' path), every product and sum is
    float32, and the carried state stays float32.  ``y = (C . h^T)
    exp(cum) + W . x`` in x's type."""
    Bb, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(128, L)
    if L % Q:
        raise ValueError(f"sequence length {L} is not a multiple of the "
                         f"chunk {Q}")
    nc = L // Q
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dtf = dt.float().reshape(Bb, nc, Q, H)
    Bf = B.float().reshape(Bb, nc, Q, N)
    Cf = C.float().reshape(Bb, nc, Q, N)
    t_idx = torch.arange(Q, device=x.device)
    causal = (t_idx[:, None] >= t_idx[None, :])[None, :, :, None]
    zero = torch.zeros((), device=x.device)
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(A.float()[None, None, :] * dtc, dim=1)  # [Bb, Q, H]
        y_state = torch.einsum("bqn,bhpn->bqhp", Cc, _bf16(h)) \
            * torch.exp(cum)[..., None]
        scores = torch.einsum("btn,bun->btu", Cc, Bc)[..., None]
        seg = torch.where(causal, cum[:, :, None, :] - cum[:, None, :, :],
                          zero)
        w = _bf16(torch.where(causal, torch.exp(seg) * scores, zero)
                  * dtc[:, None, :, :])                         # [Bb, Q, Q, H]
        ys.append(y_state + torch.einsum("btuh,buhp->bthp", w, xc))
        wu = torch.exp(cum[:, -1:, :] - cum) * dtc              # [Bb, Q, H]
        h = torch.exp(cum[:, -1])[..., None, None] * h \
            + torch.einsum("buhp,bun->bhpn", _bf16(xc * wu[..., None]), Bc)
    return torch.stack(ys, dim=1).reshape(Bb, L, H, P).to(x.dtype)
