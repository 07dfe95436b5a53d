"""Model primitives (the port of ``repro/models/layers.py``).

Activations keep the reference's layout, ``[B, S, H, D]`` for heads, and
its order of operations and float32 upcasts.  ``attention`` is the
dispatch: by default every call goes through
:func:`repro_torch.kernels.ops.flash_attention`, which launches the CUDA
kernel on a CUDA tensor and runs the plain version on a CPU tensor;
``use_kernel=False`` runs :func:`attention_ref`, the reference's masked
attention, or, under ``cfg.chunked_local_attn`` and the reference's
conditions (:func:`chunked_applies`), :func:`local_chunked_attention`.

On a mesh the activations and weights are DTensors.  Attention runs
under ``local_map`` (:func:`attention_on_mesh`): each rank attends with
its own batch rows (``data``) and heads (``model``), through the same
route as on one device; RMSNorm likewise on its own rows.  A product
with a weight goes through :func:`linear`, which settles the weight's
split over the data axes, so its operands meet at placements that leave
DTensor no layout to choose; :func:`reduce_model` sums a row-sharded
product's partial results over ``model``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from ..parallel.api import (all_reduce, grad_placements, is_distributed,
                            local_map, redistribute)


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
    if is_distributed(x):
        return _rms_norm_on_mesh(x, w, eps)
    return _rms_norm_local(x, w, eps)


def _rms_norm_local(x, w, eps: float, mesh=None, split=(), width=None):
    """:func:`rms_norm` of local tensors; where ``x``'s last dimension is
    split over ``mesh``'s dimensions ``split``, its sum of squares is
    summed over those ranks (``width`` wide in all)."""
    x32 = wide(x)
    if split:
        ss = torch.sum(x32 * x32, dim=-1, keepdim=True)
        for m in split:
            ss = all_reduce(ss, mesh, m)
        var = ss / width
    else:
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + wide(w))).to(x.dtype)


def _rms_norm_on_mesh(x, w, eps: float):
    """:func:`rms_norm` of a DTensor under ``local_map``, each rank on its
    own rows: ``x`` at its own placements (a partial sum there made whole
    first), the output alike and ``x``'s gradient at them, so the
    residual stream's gradients meet at one placement.  Where ``x``'s
    last dimension is split (the SSD block's heads over ``model``) the
    sum of squares is summed over those ranks, a ``[..., 1]`` all-reduce,
    as the reference's partitioner does.  ``w`` is split as that
    dimension is; its gradient is partial over the mesh dimensions that
    split the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, last = x.device_mesh, x.ndim - 1
    x_pl = grad_placements(x.placements)
    split = [m for m, p in enumerate(x_pl) if p.is_shard(last)]
    w_pl = [Shard(0) if m in split else Replicate()
            for m in range(mesh.ndim)]
    w_grad = [Partial() if p.is_shard() and not p.is_shard(last) else q
              for p, q in zip(x_pl, w_pl)]
    local = functools.partial(_rms_norm_local, eps=eps, mesh=mesh,
                              split=split, width=x.shape[-1])
    return local_map(local, out_placements=x_pl, in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_pl, w_grad),
                     device_mesh=mesh)(x, w)


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

    ``kv_len``: optional ``[B]`` active cache lengths (decode), or an
    int, the same for every row.
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
    if isinstance(kv_len, int):
        kv_len = torch.full((B,), kv_len, dtype=torch.int64, device=dev)
    if kv_len is not None:
        mask = mask & (kpos[:, None, :] < kv_len[:, None, None])
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.tensor(-1e30, device=dev))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, wide(v))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def local_chunked_attention(q, k, v, window: int, *, softcap=None,
                            scale=None):
    """Exact sliding-window causal attention, computed block-locally: each
    block of ``window`` queries forms scores over its own key block and
    the one before it (zeros before block 0, masked), O(S * 2w) instead
    of O(S^2).  Requires ``S % window == 0``.  The mask is
    ``kpos <= qpos`` and ``kpos > qpos - window``, the one
    :func:`attention_ref` applies for ``window``."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    w = window
    nb = S // w
    dev = q.device
    if scale is None:
        scale = D ** -0.5
    kk = k.repeat_interleave(G, dim=2)
    vv = v.repeat_interleave(G, dim=2)
    qb = q.reshape(B, nb, w, Hq, D)
    kb = kk.reshape(B, nb, w, Hq, D)
    vb = vv.reshape(B, nb, w, Hq, D)
    # previous block (zeros before block 0)
    kprev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kprev, kb], dim=2)               # [B, nb, 2w, Hq, D]
    v2 = torch.cat([vprev, vb], dim=2)
    logits = torch.einsum("bnqhd,bnkhd->bnhqk", wide(qb), wide(k2)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(w, device=dev)[:, None] + w   # within-pair position
    kpos = torch.arange(2 * w, device=dev)[None, :]
    blk = torch.arange(nb, device=dev)
    valid = (kpos <= qpos) & (kpos > qpos - w)
    # block 0 has no previous block
    first = (kpos >= w) & (kpos <= qpos) & (kpos > qpos - w)
    mask = torch.where(blk[:, None, None] == 0, first[None], valid[None])
    logits = torch.where(mask[None, :, None, :, :], logits,
                         torch.tensor(-1e30, device=dev))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p, wide(v2))
    return out.reshape(B, S, Hq, D).to(q.dtype)


def chunked_applies(cfg: ModelConfig, q, k, *, window=None, kv_len=None,
                    causal=True) -> bool:
    """The reference's condition for the block-local path: the flag set,
    a static int window, no ``kv_len``, as many queries as keys, at least
    two whole blocks and causal attention.  Every other call (decode,
    cached prefill, a ragged S, the global layers' huge window) takes the
    ordinary route."""
    S = q.shape[1]
    return bool(cfg.chunked_local_attn and isinstance(window, int)
                and kv_len is None and S == k.shape[1]
                and window * 2 <= S and S % window == 0 and causal)


def _prefix_len(kv_len, q_positions, S: int) -> int:
    """The kv prefix a cached call attends over, for the kernel route.

    The kernel places the queries at the tail of the keys it is given, so
    the reference's masked attention over a cache equals the kernel over
    the cache's first ``kv_len`` keys exactly when ``kv_len`` is the same
    for every row and the queries sit at ``kv_len - S + arange(S)``.
    Anything else raises: there is no fallback.  An int ``kv_len`` is
    the host's own count, read without a device sync (or, on a mesh, a
    gather)."""
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


def split_heads(t, *shape):
    """``t [..., H * D]`` as ``shape`` (``[..., H, D]``).  On a mesh a last
    dimension sharded over ranks whose count does not divide H (llava's
    56 heads, hymba's 25, tinyllama's 4 kv heads over a ``model`` axis of
    16) is gathered first: DTensor splits no sharded dimension unevenly,
    and attention then runs every head on each rank, as
    :func:`attention_on_mesh` does when ``model`` does not divide them."""
    if is_distributed(t):
        from torch.distributed.tensor import Replicate

        mesh, last = t.device_mesh, t.ndim - 1
        n = math.prod(mesh.size(m) for m, p in enumerate(t.placements)
                      if p.is_shard(last))
        if shape[-2] % n:
            t = redistribute(t, [Replicate() if p.is_shard(last) else p
                                 for p in t.placements])
    return t.reshape(*shape)


def merge_heads(t, *shape):
    """``t [..., H, D]`` as ``shape`` (``[..., H * D]``).  On a mesh where
    the heads were not sharded (:func:`split_heads`) the gradient is held
    to the merged tensor's layout: a product's gradient may come back
    sharded over ``model``, which the reshape's backward could not split
    into the heads."""
    out = t.reshape(*shape)
    if is_distributed(out) and not any(p.is_shard(out.ndim - 1)
                                       for p in out.placements):
        out = redistribute(out, out.placements)
    return out


def mesh_axes(mesh) -> tuple[list[str], int, int]:
    """``(data axes, their total size, the model axis's size)`` of a
    ``DeviceMesh``: every axis but ``model`` is a data axis."""
    names = mesh.mesh_dim_names
    dp = [n for n in names if n != "model"]
    n_dp = math.prod(mesh.size(names.index(n)) for n in dp)
    mp = mesh.size(names.index("model")) if "model" in names else 1
    return dp, n_dp, mp


def mesh_placements(mesh, dims: dict):
    """Placements on ``mesh``: ``Shard(dims[name])`` on each mesh
    dimension whose name ``dims`` maps to a tensor dimension,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(dims[n]) if dims.get(n) is not None else Replicate()
            for n in mesh.mesh_dim_names]


def attention_on_mesh(fn, q, k, v):
    """``fn(q, k, v)`` (one device's attention on ``[B, S, H, D]``) on
    DTensors, under ``local_map``: every rank runs ``fn`` on its own batch
    rows (over the data axes, when they divide B) and its own query heads
    (over ``model``, when it divides Hq) and holds its part of the output.
    Keys and values are sharded alike when ``model`` divides their heads;
    otherwise each rank gets every kv head and picks, for each of its
    query heads, the one the query head reads (grouped-query attention on
    local heads), so the grouping is the one-device grouping whatever the
    split.  The local tensors are made contiguous, the layout the kernel
    reads."""
    from torch.distributed.tensor import Partial

    mesh = q.device_mesh
    B, _, Hq, _ = q.shape
    Hkv = k.shape[2]
    dp, n_dp, mp = mesh_axes(mesh)
    bdim = 0 if B % n_dp == 0 else None
    hq = 2 if Hq % mp == 0 else None
    hk = 2 if (hq is not None and Hkv % mp == 0) else None
    q_pl = mesh_placements(mesh, {**{n: bdim for n in dp}, "model": hq})
    kv_pl = mesh_placements(mesh, {**{n: bdim for n in dp}, "model": hk})
    G = Hq // Hkv

    def local(ql, kl, vl):
        ql, kl, vl = ql.contiguous(), kl.contiguous(), vl.contiguous()
        if hq is not None and hk is None and mp > 1:
            hl = ql.shape[2]
            first = mesh.get_local_rank("model") * hl
            pick = torch.arange(first, first + hl, device=ql.device) // G
            kl, vl = kl[:, :, pick], vl[:, :, pick]
        return fn(ql, kl, vl)

    # picked kv heads: each rank's kv gradient covers its own query heads
    # only, a partial sum over model
    kv_grad = kv_pl if hk is not None or hq is None else [
        Partial() if n == "model" else p
        for n, p in zip(mesh.mesh_dim_names, kv_pl)]
    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


def cross_attention(q, k, v):
    """The reference's masked attention, non-causal (cross-attention over
    the encoder's keys and values); on DTensors per rank on its own rows
    and heads (:func:`attention_on_mesh`)."""
    if is_distributed(q):
        return attention_on_mesh(
            lambda ql, kl, vl: attention_ref(ql, kl, vl, causal=False),
            q, k, v)
    return attention_ref(q, k, v, causal=False)


def reduce_model(x):
    """The all-reduce over ``model`` that ends a row-sharded product (the
    contraction dimension split over ``model``, so each rank holds a
    partial sum): a DTensor's partial placements become replicas.  A plain
    tensor, or a DTensor with nothing partial, comes back as it is."""
    if not is_distributed(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return redistribute(x, [Replicate() if p.is_partial() else p
                            for p in x.placements])


def gathered(w):
    """A weight DTensor gathered over the data axes for a product (FSDP:
    every mesh dimension but ``model`` made replicated, as the reference
    gathers its ``d``-sharded weights), its gradient returned to the
    weight's own placements (a reduce-scatter over them); a plain tensor
    as it is.  The product's operands then meet at placements that leave
    DTensor no layout to choose."""
    if not is_distributed(w):
        return w
    from torch.distributed.tensor import Replicate

    want = [p if n == "model" else Replicate()
            for n, p in zip(w.device_mesh.mesh_dim_names, w.placements)]
    return redistribute(w, want)


def linear(x, w):
    """``x @ w`` for a weight ``w [d, n]``.  On a mesh the data axes'
    split of the weight (FSDP: its rows for a column-parallel weight, its
    columns for a row-parallel one) is settled here, by the elements a
    rank receives each way: the weight gathered over them
    (:func:`gathered`), or, where that moves less (a decode step's few
    rows), the product taken on the weight's own shards, its result then
    moved to ``x``'s row placement.  Split rows are contracted: ``x``'s
    last dimension split as them, the partial sums reduced.  Split
    columns are kept: ``x``'s rows made whole over those axes, the
    output's column blocks moved back.  Both are taken only outside
    autograd: the rule counts the forward's moves alone, and their
    backward would move the output's gradient over the data axes
    besides.  Either way the product's operands meet at placements that
    leave DTensor no layout to choose."""
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if grad or not (is_distributed(x) and is_distributed(w)) or w.ndim != 2:
        return x @ gathered(w)
    mesh, last = w.device_mesh, x.ndim - 1
    names = mesh.mesh_dim_names
    data = [m for m, (n, p) in enumerate(zip(names, w.placements))
            if n != "model" and p.is_shard()]
    if not data:
        return x @ gathered(w)
    x_pl = grad_placements(x.placements)
    k = w.placements[data[0]].dim     # 0: rows split, 1: columns
    if any(w.placements[m].dim != k for m in data) or any(
            x_pl[m].is_shard(last)
            and (m in data or not w.placements[m].is_shard(0))
            for m in range(mesh.ndim)):
        return x @ gathered(w)
    n = math.prod(mesh.size(m) for m in data)
    shards = math.prod(mesh.size(m) for m, p in enumerate(w.placements)
                       if p.is_shard())
    rows = x.numel() // x.shape[-1]
    split_rows = any(x_pl[m].is_shard() for m in data)
    # elements a rank receives: the weight's other blocks over the data
    # axes; or x and the product moved
    gather = w.numel() // shards * (n - 1)
    if k == 0:
        # x's rows moved to a split last dimension, the partial sums
        # reduced (scattered back to split rows, or whole)
        cols = w.shape[1] * n // shards
        contract = ((rows * x.shape[-1] // n if split_rows else 0)
                    + rows * cols * (1 if split_rows else 2))
    else:
        # x's split rows gathered, the product's column blocks moved back
        # to them (or gathered whole)
        width = w.shape[0] * n // shards
        contract = ((rows * width if split_rows else 0)
                    + rows * w.shape[1] // n * (1 if split_rows else n - 1))
    if gather <= contract:
        return x @ gathered(w)
    from torch.distributed.tensor import Replicate, Shard

    # x at the weight's shards: over the data axes its last dimension
    # split (rows) or its rows whole (columns); over model its last
    # dimension split where the weight's rows are
    want = [(Shard(last) if k == 0 else Replicate()) if m in data
            else Shard(last) if w.placements[m].is_shard(0) else p
            for m, p in enumerate(x_pl)]
    y = redistribute(x, want) @ w
    return redistribute(y, [x_pl[m] if m in data else p
                            for m, p in enumerate(y.placements)])


def split_last(x, sizes):
    """``torch.split(x, sizes, dim=-1)``; on a DTensor (its last dimension
    whole) each rank splits its own rows, every piece and its gradient at
    ``x``'s placements."""
    if not is_distributed(x):
        return torch.split(x, sizes, dim=-1)
    pl = grad_placements(x.placements)
    return local_map(lambda t: torch.split(t, sizes, dim=-1),
                     out_placements=(pl,) * len(sizes), in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def split_over_model(x):
    """A DTensor split over ``model`` on its last dimension (a local slice
    where it is whole there), its gradient held so, so that a product
    with a weight whose rows are split over ``model`` runs split in both
    passes; ``x`` itself on a plain tensor, or where ``model`` splits
    another dimension or does not divide that one."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Shard

    mesh, last = x.device_mesh, x.ndim - 1
    names = mesh.mesh_dim_names
    if "model" not in names:
        return x
    m = names.index("model")
    if x.shape[last] % mesh.size(m) or not (
            x.placements[m].is_replicate()
            or x.placements[m].is_shard(last)):
        return x
    want = tuple(Shard(last) if i == m else p
                 for i, p in enumerate(x.placements))
    return redistribute(x, want, want)


def whole_over_model(x):
    """A DTensor made whole over ``model`` (its shards there gathered, its
    partial sums there reduced), its other placements kept; a plain
    tensor as it is."""
    if not is_distributed(x):
        return x
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    want = tuple(Replicate() if n == "model" else p
                 for n, p in zip(mesh.mesh_dim_names, x.placements))
    return x if want == tuple(x.placements) else redistribute(x, want)


def attention(cfg: ModelConfig, q, k, v, *, causal=True, window=None,
              softcap=None, scale=None, kv_len=None, q_positions=None,
              use_kernel: bool = True):
    """Attention on ``[B, S, H, D]``: the flash kernel (plain version on a
    CPU tensor) over the first ``kv_len`` keys, or with
    ``use_kernel=False`` the reference's :func:`attention_ref`, or
    :func:`local_chunked_attention` where :func:`chunked_applies`.  The
    kernel route needs no block-local form: flash with ``window``
    computes the same function and skips the masked key tiles, O(S * 2w)
    work too.  On DTensors either route runs per rank on local heads
    (:func:`attention_on_mesh`); a mesh takes ``kv_len`` as an int (the
    cache's fill, the same for every row; the queries then sit at
    ``kv_len - S + arange(S)``, as in cached serving) and no
    ``q_positions``."""
    if is_distributed(q):
        if q_positions is not None or not (kv_len is None
                                           or isinstance(kv_len, int)):
            raise ValueError("attention on a mesh takes kv_len as an int "
                             "and no q_positions")

        def local(ql, kl, vl):
            qp = None
            if kv_len is not None and not use_kernel:
                S = ql.shape[1]
                qp = torch.arange(kv_len - S, kv_len, device=ql.device)
                qp = qp[None, :].expand(ql.shape[0], S)
            return attention(cfg, ql, kl, vl, causal=causal, window=window,
                             softcap=softcap, scale=scale, kv_len=kv_len,
                             q_positions=qp, use_kernel=use_kernel)

        return attention_on_mesh(local, q, k, v)
    if not use_kernel:
        if chunked_applies(cfg, q, k, window=window, kv_len=kv_len,
                           causal=causal):
            return local_chunked_attention(q, k, v, window, softcap=softcap,
                                           scale=scale)
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
    """wi: ``[d, 2F]`` fused gate+up; wo: ``[F, d]``.  On a mesh the
    product is made whole over ``model`` before the halves are taken (a
    rank's columns are gate or up, not both), and its gradient is held
    back at the product's placements, a local slice, so the product's
    backward stays split over ``model``."""
    h = whole_over_model(linear(x, wi))
    gate, up = torch.chunk(h, 2, dim=-1)
    if act == "swiglu":
        g = F.silu(wide(gate)).to(x.dtype)
    elif act == "geglu":
        g = F.gelu(wide(gate), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(act)
    return reduce_model(linear(split_over_model(g * up), wo))


#: a stacked leaf with more elements than this (8 GiB as float32) is drawn
#: one layer slice at a time into a tensor of its own type: llava-next-34b's
#: FFN ``wi`` would be a 70 GB float32 draw.  No leaf of the dense, ssm or
#: hybrid configs is that large, so their draws are whole leaves.
SLICE_DRAW_NUMEL = 1 << 31


def gen_device(gen: torch.Generator | None) -> torch.device:
    """The device weights drawn from ``gen`` live on: its own, or
    ``meta`` for ``None`` (shapes and types only, nothing drawn)."""
    return torch.device("meta") if gen is None else gen.device


def init_dense(gen: torch.Generator | None, shape, dtype, scale=None):
    """Normal weights scaled by ``fan_in ** -0.5`` (or ``scale``), drawn
    in float32 from ``gen`` on its device and cast to ``dtype``; with
    ``gen=None`` an empty ``meta`` tensor of that shape and type."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
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
