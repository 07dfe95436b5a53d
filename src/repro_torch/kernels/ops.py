"""Dispatch for the port's kernels (the port of ``repro/kernels/ops.py``'s
``lut_eval``, ``lut_eval6``, ``bitplane_matmul``, ``flash_attention``,
``ssd_scan`` and ``popcount_matmul``).

``use_kernel`` mirrors the reference's ``use_pallas``:

* a CUDA tensor with ``use_kernel=True`` launches the CUDA kernel — or
  raises; there is no fallback;
* a CUDA tensor with ``use_kernel=False`` runs the plain-torch version on
  the card (only the parity checks ask for this);
* a CPU tensor runs the plain-torch version.

Gradients: ``flash_attention`` is differentiable on every route.  When
grad mode is on and an input requires grad it runs as
:class:`FlashAttentionFn`, the counterpart of the reference's
``custom_vjp``: the forward is the kernel (its plain version on a CPU
tensor), the backward recomputes through the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`) and differentiates
that, as the reference's ``_bwd`` does.  The other kernels have no
backward, in the reference as here (their ``pallas_call`` has no VJP): on
the kernel route they raise ``NotImplementedError`` when asked for a
gradient instead of returning a tensor without one.

Each wrapper counts its kernel launches in a plain integer attribute
(``lut_eval6.launches``, ``lut_eval.launches``, ...), incremented where the
kernel launches and nowhere else, so a run can show which path it took.
The count is of calls of the op, however many launches a call takes (the
tensor-core bit-plane product folds and splits first; the split attention
combines after; the shared-score SSD scan forms its scores first).
``bitplane_matmul``, ``flash_attention``, ``ssd_scan`` and
``popcount_matmul`` name their kernels, chosen by shape and type alone
(each launcher's ``variant``); ``lut_eval6`` names its entry point (the
op, ``"op"``, or the evaluator's fused level, ``"level"``, both counted
in ``lut_eval6.launches``); each call also adds one to its variant's
count in ``.variants`` (:func:`variant_counts`).  Lanes
are int32 bit patterns (see :mod:`repro_torch.kernels.ref`).
"""
from __future__ import annotations

import torch

from . import ref


def _wants_kernel(inputs: torch.Tensor, use_kernel: bool) -> bool:
    return use_kernel and inputs.device.type == "cuda"


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The kernel route of an op with no backward: raise rather than hand
    back a tensor with no gradient (everything upstream of it would get
    zeros)."""
    if not _needs_grad(*tensors):
        return
    hint = ("the ssm and hybrid families train with use_kernel=False, as "
            "the reference's default use_kernels=False does"
            if name == "ssd_scan" else
            "call it under torch.no_grad() or with use_kernel=False")
    raise NotImplementedError(
        f"{name}'s kernel has no backward (the reference's Pallas {name} "
        f"has no VJP either); {hint}")


def lut_eval(inputs: torch.Tensor, tts: torch.Tensor,
             use_kernel: bool = True) -> torch.Tensor:
    """``inputs[M, K, N]`` int32 lanes (K <= 5) + ``tts[M]`` ->
    ``out[M, N]``."""
    if _wants_kernel(inputs, use_kernel):
        _refuse_grad("lut_eval", inputs)
        from .lut_eval import lut_eval_cuda

        out = lut_eval_cuda(inputs, tts)
        if out.numel():  # an empty call launches nothing
            lut_eval.launches += 1
        return out
    return ref.lut_eval_ref(inputs, tts)


def lut_eval6(inputs: torch.Tensor, tt_lo: torch.Tensor, tt_hi: torch.Tensor,
              use_kernel: bool = True) -> torch.Tensor:
    """``inputs[M, 6, N]`` int32 lanes + split 64-entry tables ->
    ``out[M, N]``."""
    if _wants_kernel(inputs, use_kernel):
        _refuse_grad("lut_eval6", inputs)
        from .lut_eval import lut_eval6_cuda

        out = lut_eval6_cuda(inputs, tt_lo, tt_hi)
        if out.numel():  # an empty call launches nothing
            lut_eval6.launches += 1
            lut_eval6.variants["op"] += 1
        return out
    return ref.lut_eval6_ref(inputs, tt_lo, tt_hi)


def lut_eval6_level(vals: torch.Tensor, ins_idx: torch.Tensor,
                    tt_lo: torch.Tensor, tt_hi: torch.Tensor,
                    out_idx: torch.Tensor, use_kernel: bool = True
                    ) -> torch.Tensor:
    """One fused LUT level of the evaluator, in place on the value buffer
    ``vals[R, N]``: ``vals[out_idx] = lut_eval6(vals[ins_idx], tt_lo,
    tt_hi)`` with ``ins_idx[M, 6]`` / ``out_idx[M]`` int64.  On the card
    one launch of the level kernel, counted in ``lut_eval6.launches``
    (variant ``"level"``); its plain version is that composition
    (:func:`repro_torch.kernels.ref.lut_eval6_level_ref`).  Returns
    ``vals``."""
    if _wants_kernel(vals, use_kernel):
        _refuse_grad("lut_eval6", vals)
        from .lut_eval import lut_eval6_level_cuda

        lut_eval6_level_cuda(vals, ins_idx, tt_lo, tt_hi, out_idx)
        if out_idx.numel() and vals.shape[1]:
            lut_eval6.launches += 1
            lut_eval6.variants["level"] += 1
        return vals
    return ref.lut_eval6_level_ref(vals, ins_idx, tt_lo, tt_hi, out_idx)


def bitplane_matmul(x: torch.Tensor, planes: torch.Tensor,
                    scale: torch.Tensor, use_kernel: bool = True
                    ) -> torch.Tensor:
    """``x[M, K]`` float32, ``planes[B, K, N]`` in {0, 1}, ``scale[N]`` ->
    ``y[M, N] = (x @ W) * scale`` with W the two's-complement sum of the
    planes."""
    if _wants_kernel(x, use_kernel):
        _refuse_grad("bitplane_matmul", x, scale)
        from .bitplane_matmul import bitplane_matmul_cuda, variant

        out = bitplane_matmul_cuda(x, planes, scale)
        if out.numel():
            bitplane_matmul.launches += 1
            bitplane_matmul.variants[variant(x.shape[0],
                                             planes.shape[0])] += 1
        return out
    return ref.bitplane_matmul_ref(x, planes, scale)


def _flash_forward(q, k, v, causal, window, softcap, scale, use_kernel):
    if _wants_kernel(q, use_kernel):
        from .flash_attention import flash_attention_cuda, variant

        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
        if out.numel():
            flash_attention.launches += 1
            flash_attention.variants[variant(q.dtype, q.shape[2],
                                             q.shape[1] // k.shape[1])] += 1
            heads = f"{q.shape[1]}/{k.shape[1]}"
            flash_attention.heads[heads] = \
                flash_attention.heads.get(heads, 0) + 1
        return out
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with the kernel forward and a recomputing backward (the
    reference's ``custom_vjp`` of ``flash_attention``: ``_fwd`` saves
    q, k, v; ``_bwd`` differentiates ``flash_attention_ref`` at them).

    ``apply(q, k, v, causal, window, softcap, scale)``.  The forward is
    :func:`flash_attention`'s: the CUDA kernel on a CUDA tensor (counted),
    the plain version on a CPU tensor.  The backward builds the
    plain version's graph at the saved inputs under ``enable_grad`` and
    returns ``torch.autograd.grad`` of it against the incoming gradient:
    the ``[B, Hq, S, T]`` float32 logits live only inside it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.attn = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return _flash_forward(q, k, v, causal, window, softcap, scale, True)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.flash_attention_ref(*inputs, **ctx.attn)
            dq, dk, dv = torch.autograd.grad(out, inputs, g)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """``q[B, Hq, S, D]``, ``k/v[B, Hkv, T, D]`` -> ``[B, Hq, S, D]``:
    attention with the queries at the tail of the keys (causal, GQA,
    sliding window, logit softcap).  With grad mode on and an input that
    requires grad, the kernel route runs as :class:`FlashAttentionFn`;
    ``use_kernel=False`` is the plain version, differentiated as it
    stands."""
    if use_kernel and _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                      scale)
    return _flash_forward(q, k, v, causal, window, softcap, scale,
                          use_kernel)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             use_kernel: bool = True) -> torch.Tensor:
    """Mamba-2 SSD scan: ``x[Bb, L, H, P]``, ``dt[Bb, L, H]`` float32,
    ``A[H]`` float32, ``B / C[Bb, L, N]`` -> ``y[Bb, L, H, P]`` in x's
    type (see :func:`repro_torch.kernels.ref.ssd_scan_ref`).  The
    reference kernel's contract holds on every device: L must be a
    multiple of its chunk ``min(128, L)``."""
    from .ssd_scan import chunk_of, ssd_scan_cuda, variant

    chunk_of(x.shape[1])
    if _wants_kernel(x, use_kernel):
        _refuse_grad("ssd_scan", x, dt, A, B, C)
        out = ssd_scan_cuda(x, dt, A, B, C)
        if out.numel():
            ssd_scan.launches += 1
            ssd_scan.variants[variant(x.dtype, B.shape[-1])] += 1
        return out
    return ref.ssd_scan_ref(x, dt, A, B, C)


def popcount_matmul(x_packed: torch.Tensor, w_packed: torch.Tensor,
                    mode: str = "and", k_bits: int | None = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """Binary GEMM over packed int32 words: ``x_packed[M, W]``,
    ``w_packed[N, W]`` -> ``int32[M, N]``, ``sum popc(x & w)`` (mode
    "and") or ``k_bits - 2 sum popc(x ^ w)`` (mode "xnor")."""
    if _wants_kernel(x_packed, use_kernel):
        _refuse_grad("popcount_matmul", x_packed, w_packed)
        from .popcount_matmul import popcount_matmul_cuda, variant

        out = popcount_matmul_cuda(x_packed, w_packed, mode=mode,
                                   k_bits=k_bits)
        if out.numel():
            popcount_matmul.launches += 1
            popcount_matmul.variants[variant(
                x_packed.shape[0], w_packed.shape[0], x_packed.shape[1])] += 1
        return out
    return ref.popcount_matmul_ref(x_packed, w_packed, mode=mode,
                                   k_bits=k_bits)


_COUNTED = (lut_eval6, lut_eval, flash_attention, bitplane_matmul, ssd_scan,
            popcount_matmul)
#: the kernels of the ops that name theirs (each call counted per kernel)
_VARIANTS = {lut_eval6: ("op", "level"),
             flash_attention: ("mma", "split", "tf32x3"),
             bitplane_matmul: ("tensor_core", "small_m", "ffma"),
             ssd_scan: ("mma", "ffma"),
             popcount_matmul: ("tensor_core",)}


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
    for fn, names in _VARIANTS.items():
        fn.variants = dict.fromkeys(names, 0)
    flash_attention.heads = {}


reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _COUNTED}


def flash_head_counts() -> dict[str, int]:
    """The flash kernel's launches since the last
    :func:`reset_launch_counts` by the heads they got, ``"Hq/Hkv"`` (on a
    mesh, each rank's local heads)."""
    return dict(flash_attention.heads)


def variant_counts() -> dict[str, dict[str, int]]:
    """Calls per kernel variant of ``lut_eval6``, ``flash_attention``,
    ``bitplane_matmul``, ``ssd_scan`` and ``popcount_matmul`` since the
    last :func:`reset_launch_counts`."""
    return {fn.__name__: dict(fn.variants) for fn in _VARIANTS}
