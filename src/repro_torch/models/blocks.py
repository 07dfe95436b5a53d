"""Per-layer bodies of every family: attention (with the bf16 or int8
KV cache), FFN, the routed-expert MoE FFN (capacity-dropped for training,
dropless for evaluation and serving), the Mamba-2 SSD mixer and Hymba's
parallel attention + SSD block (the port of ``repro/models/blocks.py``).

Blocks operate on one layer's parameter slice (no leading L axis).  A
cache is a dict of one layer's tensors (``k``/``v`` ``[B, T, Hkv, D]``,
int8 with float32 ``k_scale``/``v_scale`` ``[B, T, Hkv]`` for the int8
cache; ``conv`` ``[B, Kc-1, H*P]``, ``ssm`` ``[B, H, P, N]``), updated in
place.  On a mesh (DTensor activations and weights) the MoE dispatch
keeps the reference's ``constrain`` pins, and the row-sharded output
products end in :func:`repro_torch.models.layers.reduce_model`; on one
device both are nothing.  A cache on a mesh is a tree of DTensors placed
by ``cache_specs``; its writes stay on the rank that owns each row, head
or time slice (:func:`_write_rows`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..configs.base import ModelConfig
from ..kernels import ops, ref
from ..parallel.api import (constrain, current_rules, grad_placements,
                            hold, is_distributed, local_map, whole,
                            write_into)
from .layers import (attention, gathered, glu_ffn, linear, merge_heads,
                     mesh_axes, mesh_placements, over_data, reduce_model,
                     rms_norm, rope, split_heads, split_last,
                     split_over_model, whole_over_model)

HUGE_WINDOW = 1 << 30
#: the profiler range the dropless expert products run in
EXPERTS_RANGE = "moe dropless experts"


def attn_block(cfg: ModelConfig, p, x, positions, window=None, cache=None,
               cache_index=None, causal=True, use_kernel: bool = True):
    """x: ``[B, S, d]``.  With ``cache`` (dict k/v ``[B, T, Hkv, D]``, and
    ``k_scale``/``v_scale`` ``[B, T, Hkv]`` when k/v are int8) writes the
    new k/v at ``cache_index`` (an int; ``positions`` must be
    ``cache_index + arange(S)``) and attends over the filled prefix.
    Returns (out, cache)."""
    B, S, _ = x.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    q = linear(h, p["wq"])
    k = linear(h, p["wk"])
    v = linear(h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = split_heads(q, B, S, Hq, D)
    k = split_heads(k, B, S, Hkv, D)
    v = split_heads(v, B, S, Hkv, D)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        end = cache_index + S
        _write_kv(cache, k, v, cache_index)
        if use_kernel:
            # the queries are the last S of the filled prefix: the kernel
            # reads that prefix (in place from a bf16 cache, dequantized
            # into a contiguous tensor from an int8 one)
            kd, vd = _cached_kv(cache, end, x.dtype)
            out = attention(cfg, q, kd, vd, causal=causal, window=window,
                            softcap=cfg.attn_softcap)
        elif is_distributed(x):
            # the reference's masked attention on each rank's rows and
            # heads: the fill as a host int, the queries at its tail
            kd, vd = _cached_kv(cache, None, x.dtype)
            out = attention(cfg, q, kd, vd, causal=causal, window=window,
                            softcap=cfg.attn_softcap, kv_len=end,
                            use_kernel=False)
        else:
            # the reference: the whole cache, masked by kv_len
            kd, vd = _cached_kv(cache, None, x.dtype)
            kv_len = torch.full((B,), end, dtype=torch.int64,
                                device=x.device)
            out = attention(cfg, q, kd, vd, causal=causal, window=window,
                            softcap=cfg.attn_softcap, kv_len=kv_len,
                            q_positions=positions, use_kernel=False)
    else:
        out = attention(cfg, q, k, v, causal=causal, window=window,
                        softcap=cfg.attn_softcap, use_kernel=use_kernel)
    out = reduce_model(linear(merge_heads(out, B, S, Hq * D), p["wo"]))
    if "post_ln" in p:  # gemma2 post-attention norm
        out = rms_norm(out, p["post_ln"], cfg.rms_eps)
    return out, cache


def q8(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) abs-max int8 quantization over the last axis:
    ``(codes int8, scale float32)`` with ``scale = max|t| / 127`` (at
    least 1e-8), codes rounded half to even, as the reference's ``q8``."""
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(dim=-1) / 127.0, min=1e-8)
    return torch.round(t32 / scale[..., None]).to(torch.int8), scale


def _write_kv(cache: dict, k, v, index: int) -> None:
    """Write the new keys and values into the cache at ``index`` (in
    place), quantized when the cache is int8."""
    if "k_scale" in cache:
        for name, t in (("k", k), ("v", v)):
            codes, scale = q8(t)
            _write_rows(cache[name], codes, index)
            _write_rows(cache[name + "_scale"], scale, index)
    else:
        _write_rows(cache["k"], k, index)
        _write_rows(cache["v"], v, index)


def _write_rows(dst, src, index: int) -> None:
    """``dst[:, index:index + S] = src`` in place (``dst`` a cache entry
    ``[B, T, ...]``, ``src`` ``[B, S, ...]``).  On a mesh the new rows are
    laid out as ``dst`` is over batch and heads and whole over time, and
    each rank writes those of them that fall in its own time slice (all
    of them when time is not sharded, none on a rank whose slice misses
    them): the write never leaves the rank that owns the row."""
    end = index + src.shape[1]
    if not is_distributed(dst):
        dst[:, index:end] = src.to(dst.dtype)
        return
    from torch.distributed.tensor import Replicate

    from ..parallel.sharding import local_shape

    mesh = dst.device_mesh
    src = src.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                  for p in dst.placements]).to_local()
    local = dst.to_local()
    _, off = local_shape(dst.shape, mesh, dst.placements)
    lo, hi = max(index, off[1]), min(end, off[1] + local.shape[1])
    if lo < hi:
        local[:, lo - off[1]:hi - off[1]] = \
            src[:, lo - index:hi - index].to(local.dtype)


def _cached_kv(cache: dict, end: int | None, dtype):
    """The cache's keys and values over ``[:end]`` (all of it for None):
    views of a bf16 cache; an int8 cache dequantized to ``dtype`` as the
    reference does it (``codes.astype(dtype) * scale.astype(dtype)``)."""
    k, v = cache["k"][:, :end], cache["v"][:, :end]
    if "k_scale" not in cache:
        return k, v
    ks, vs = cache["k_scale"][:, :end], cache["v_scale"][:, :end]
    return (k.to(dtype) * ks[..., None].to(dtype),
            v.to(dtype) * vs[..., None].to(dtype))


def ffn_block(cfg: ModelConfig, p, x):
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    if cfg.act == "gelu_mlp":
        out = reduce_model(linear(F.gelu(linear(h, p["wi"]),
                                         approximate="tanh"), p["wo_ff"]))
    else:
        out = glu_ffn(h, p["wi"], p["wo_ff"], cfg.act)
    if "post_ln2" in p:
        out = rms_norm(out, p["post_ln2"], cfg.rms_eps)
    return out


def topk_lowest_index(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, largest first, the lowest index first among equal values, as
    ``jax.lax.top_k`` orders them (``torch.topk`` breaks ties its own way,
    on the CPU and on the card alike): the first ``k`` of a stable
    descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_route(cfg: ModelConfig, p, ht):
    """The router, shared by both MoE paths: float32 softmax over the
    experts, top-k (:func:`topk_lowest_index`), the gates renormalised
    over the k.  ``ht``'s leading axes are arbitrary.  Returns ``(probs
    [..., E], gate_vals [..., K], onehot [..., K, E])``, all float32."""
    # every expert's logit on every model rank (the router's columns are
    # sharded over model): the softmax and top-k then split no token; the
    # router's gradient of ht at ht's placements before it meets the
    # experts'
    logits = whole_over_model(hold(ht).float()
                              @ gathered(p["router"]).float())
    probs = torch.softmax(logits, dim=-1)
    gate_idx = topk_lowest_index(probs, cfg.top_k)[1]
    return (probs, *_moe_gates(probs, gate_idx, cfg.n_experts))


def _moe_gates(probs, idx, E: int):
    """The gates of the chosen experts ``idx [..., K]``: their
    probabilities renormalised over the k, and the choices as one-hots
    ``[..., K, E]``, both float32."""
    gate_vals = probs.gather(-1, idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, F.one_hot(idx, E).float()


def _moe_expert_weights(p, cdt):
    """The expert weights ``we_i [E, d, 2f]``, ``we_o [E, f, d]`` in
    ``cdt``: float8 ones (``train.step._fp8_expert_params``) dequantized
    by their per-channel scales, after the ``moe_expert_w8`` pin (on a
    mesh the float8 tensor is resharded, then dequantized locally)."""
    we_i, we_o = p["we_i"], p["we_o"]
    if "we_i_scale" in p:
        we_i = constrain(we_i, "moe_expert_w8")
        we_i = we_i.to(cdt) * p["we_i_scale"].to(cdt)
    if "we_o_scale" in p:
        we_o = constrain(we_o, "moe_expert_w8")
        we_o = we_o.to(cdt) * p["we_o_scale"].to(cdt)
    return we_i, we_o


def _moe_aux_loss(cfg: ModelConfig, probs, onehot):
    """Switch-style load-balance loss over every token and choice."""
    E = cfg.n_experts
    # on a mesh the means over the tokens are made whole (their gradient
    # too, and the probabilities' back at their own placements before it
    # meets the gates'), so the product meets no partial sum
    me = whole(hold(probs).reshape(-1, E).mean(dim=0))
    ce = whole(onehot.reshape(-1, E).mean(dim=0))
    return E * torch.sum(me * ce)


def moe_block(cfg: ModelConfig, p, x):
    """Token-choice top-k routing with a capacity per group of
    ``moe_group_size`` tokens (the GShard einsum dispatch the reference
    trains with): a token's k-th choice is dropped when its expert's queue
    in the group is full, the queue order being the cumulative count over
    the flattened (token, choice) axis.  Returns ``(out, aux)``."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    cdt = x.dtype
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    T = B * S
    g = min(cfg.moe_group_size, T)
    n = T // g
    ht = h.reshape(n, g, d)
    C = max(1, int(g * K / E * cfg.capacity_factor))

    probs, gate_vals, onehot = _moe_route(cfg, p, ht)        # [n, g, K, E]
    pos = torch.cumsum(onehot.reshape(n, g * K, E), dim=1)
    pos = pos.reshape(n, g, K, E) * onehot - 1.0
    slot = (pos * onehot).sum(-1)                            # [n, g, K]
    keep = (slot >= 0) & (slot < C)
    slot = torch.clamp(slot, 0, C - 1).long()
    slot_oh = F.one_hot(slot, C).float() * keep[..., None]
    disp = _dispatch_einsum("ngke,ngkc->ngec", onehot, slot_oh).to(cdt)
    disp = constrain(disp, "moe_dispatch")
    xe = _dispatch_einsum("ngd,ngec->necd", ht, disp)
    xe = constrain(xe, "moe_expert_in")
    we_i, we_o = _moe_expert_weights(p, cdt)
    ye = constrain(_capacity_experts(xe, we_i, we_o), "moe_expert_in")
    comb = _dispatch_einsum("ngke,ngkc,ngk->ngec", onehot, slot_oh,
                            gate_vals).to(cdt)
    comb = constrain(comb, "moe_dispatch")
    # the combine's partial sums over model added here, before the shared
    # experts' output meets them
    yt = reduce_model(_dispatch_einsum("necd,ngec->ngd", ye, comb))
    out = yt.reshape(B, S, d).to(x.dtype)
    if cfg.n_shared_experts > 0:
        # the shared experts' gradient of h at h's placements before it
        # meets the router's and the dispatch's
        out = out + glu_ffn(hold(h), p["ws_i"], p["ws_o"], "swiglu")
    return out, _moe_aux_loss(cfg, probs, onehot)


def _dispatch_einsum(eq: str, *ts):
    """``torch.einsum(eq, *ts)`` of the capacity dispatch, whose operands
    and result all lead with the groups ``n`` and name the experts ``e``;
    on DTensors under ``local_map``, each rank on its own groups (``n``
    over the data axes where the ``moe_dispatch`` rule puts it there and
    they divide it) and its own experts (``e`` over ``model`` when it
    divides E).  An operand without ``e`` is alike
    on every ``model`` rank and its gradient there a partial sum; a result
    without ``e`` (the combine) is a partial sum over ``model``.  DTensor's
    own einsum flattens ``e`` with a neighbouring dimension, which some
    torch versions refuse for a sharded dimension."""
    if not is_distributed(ts[0]):
        return torch.einsum(eq, *ts)
    from torch.distributed.tensor import Partial

    subs, res = eq.split("->")
    subs = subs.split(",")
    mesh = ts[0].device_mesh
    dp, n_dp, mp = mesh_axes(mesh)
    rule = (current_rules() or {}).get("moe_dispatch")
    n_dim = (0 if rule is not None and rule[0] is not None
             and over_data(ts[0].shape[0], n_dp) else None)
    E = next(t.shape[s.index("e")] for s, t in zip(subs, ts) if "e" in s)
    e_on = E % mp == 0

    def pl(s):
        return mesh_placements(mesh, {**{a: n_dim for a in dp}, "model": (
            s.index("e") if e_on and "e" in s else None)})

    def partial(s):
        return [Partial() if a == "model" and e_on and "e" not in s else q
                for a, q in zip(mesh.mesh_dim_names, pl(s))]

    return local_map(lambda *ls: torch.einsum(eq, *ls),
                     out_placements=partial(res),
                     in_placements=tuple(pl(s) for s in subs),
                     in_grad_placements=tuple(partial(s) for s in subs),
                     device_mesh=mesh)(*ts)


def _expert_ffn(xe, we_i, we_o):
    """The capacity dispatch's expert SwiGLU: ``xe [n, E, C, d]`` through
    ``we_i [E, d, 2f]`` and ``we_o [E, f, d]`` -> ``[n, E, C, d]``."""
    he = torch.einsum("necd,edf->necf", xe, we_i)
    gate, up = torch.chunk(he, 2, dim=-1)
    he = F.silu(gate.float()).to(xe.dtype) * up
    return torch.einsum("necf,efd->necd", he, we_o)


def _capacity_experts(xe, we_i, we_o):
    """:func:`_expert_ffn`; on a mesh under ``local_map``, each rank
    running its own experts (``E`` over ``model``, the weights gathered
    over the data axes, which shard their ``d`` FSDP-style) on its own
    groups (``n`` over the data axes when they divide it)."""
    if not is_distributed(xe):
        return _expert_ffn(xe, we_i, we_o)
    from torch.distributed.tensor import Partial

    mesh = xe.device_mesh
    dp, n_dp, mp = mesh_axes(mesh)
    n_on_dp = over_data(xe.shape[0], n_dp)
    e_dim = xe.shape[1] % mp == 0
    x_pl = mesh_placements(mesh, {**{n: 0 if n_on_dp else None for n in dp},
                                  "model": 1 if e_dim else None})
    w_pl = mesh_placements(mesh, {"model": 0 if e_dim else None})
    # a rank's weight gradient covers its own groups only: partial over
    # the data axes when they split the groups
    wg_pl = [Partial() if n in dp and n_on_dp else w
             for n, w in zip(mesh.mesh_dim_names, w_pl)]
    return local_map(_expert_ffn, out_placements=x_pl,
                     in_placements=(x_pl, w_pl, w_pl),
                     in_grad_placements=(x_pl, wg_pl, wg_pl),
                     device_mesh=mesh)(
                         xe, we_i, we_o)


def _dropless_experts(ht, we_i, we_o, weight):
    """Every token ``ht [T, d]`` through every expert (``we_i [E, d, 2f]``,
    ``we_o [E, f, d]``, SwiGLU), combined with ``weight [T, E]``: three
    batched products over the experts, each intermediate freed as soon as
    the next exists (at deepseek-moe-16b's prefill of 4,096 tokens the
    first is ``[64, 4096, 2816]``, 1.48 GB in bf16).  The products run in
    the profiler range ``EXPERTS_RANGE``."""
    E, T, d = we_i.shape[0], ht.shape[0], ht.shape[1]
    with record_function(EXPERTS_RANGE):
        he = torch.bmm(ht.expand(E, T, d), we_i)             # [E, T, 2f]
        gate, up = torch.chunk(he, 2, dim=-1)
        act = F.silu(gate.float()).to(ht.dtype)
        del he, gate
        act = act * up
        del up
        ye = torch.bmm(act, we_o)                            # [E, T, d]
        del act
        return torch.bmm(weight[:, None, :], ye.transpose(0, 1))[:, 0]


def _dropless_on_mesh(ht, we_i, we_o, weight):
    """:func:`_dropless_experts` on DTensors, under ``local_map``: each
    rank runs its own experts (``E`` over ``model``, their weights
    gathered over the data axes, which shard ``d`` FSDP-style) on its own
    tokens (``T`` over the data axes when they divide it), weighted by
    its columns of ``weight``; the sum over every expert is then a sum of
    the ranks' partial results over ``model``
    (:func:`repro_torch.models.layers.reduce_model`)."""
    from torch.distributed.tensor import Partial

    mesh = ht.device_mesh
    dp, n_dp, mp = mesh_axes(mesh)
    t_dim = 0 if over_data(ht.shape[0], n_dp) else None
    e_dim = we_i.shape[0] % mp == 0
    dps = {n: t_dim for n in dp}
    x_pl = mesh_placements(mesh, dps)
    w_pl = mesh_placements(mesh, {"model": 0 if e_dim else None})
    g_pl = mesh_placements(mesh, {**dps, "model": 1 if e_dim else None})
    out_pl = [Partial() if n == "model" and e_dim else p
              for n, p in zip(mesh.mesh_dim_names, x_pl)]
    return reduce_model(local_map(
        _dropless_experts, out_placements=out_pl,
        in_placements=(x_pl, w_pl, w_pl, g_pl), device_mesh=mesh)(
            ht, we_i, we_o, weight))


def moe_block_dropless(cfg: ModelConfig, p, x):
    """Per-token dropless top-k routing, the evaluation and serving path:
    every token reaches its k experts whatever other tokens share its
    batch, so cached decode matches the teacher-forced forward.  As in
    the reference it computes all E experts for every token and combines
    them with the routing weights (zero for the experts not chosen); the
    products are batched over the experts, ``[E, T, ...]``.  Returns
    ``(out, aux)``."""
    B, S, d = x.shape
    cdt = x.dtype
    h = rms_norm(x, p["ln2"], cfg.rms_eps)
    ht = h.reshape(B * S, d)

    probs, gate_vals, onehot = _moe_route(cfg, p, ht)        # [T, K, E]
    weight = (onehot * gate_vals[..., None]).sum(1)          # [T, E]

    we_i, we_o = _moe_expert_weights(p, cdt)
    if is_distributed(ht):
        yt = _dropless_on_mesh(ht, we_i, we_o, weight.to(cdt))
    else:
        yt = _dropless_experts(ht, we_i, we_o, weight.to(cdt))
    out = yt.reshape(B, S, d).to(x.dtype)
    if cfg.n_shared_experts > 0:
        out = out + glu_ffn(hold(h), p["ws_i"], p["ws_o"], "swiglu")
    return out, _moe_aux_loss(cfg, probs, onehot)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv along time.  x: ``[B, S, C]``; w: ``[Kc, C]``.
    With ``state`` ``[B, Kc-1, C]`` it continues a stream.  Returns
    ``(out, new_state)``; new_state is the last Kc-1 inputs (None for
    Kc = 1)."""
    Kc = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], Kc - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(Kc))
    new_state = xp[:, xp.shape[1] - (Kc - 1):, :] if Kc > 1 else None
    return out, new_state


def _conv(x, w, state=None):
    """:func:`_causal_conv`; on DTensors under ``local_map``: each rank on
    its own rows and channels (``x`` at its placements, ``w``'s channels
    split as ``x``'s, the state laid out as ``x``), ``w``'s gradient
    partial over the mesh dimensions that split the rows."""
    if not is_distributed(x) or w.shape[0] == 1:
        return _causal_conv(x, w, state)
    from torch.distributed.tensor import Partial, Replicate, Shard

    x_pl = grad_placements(x.placements)
    w_pl = [Shard(1) if p.is_shard(2) else Replicate() for p in x_pl]
    w_grad = [Partial() if p.is_shard() and not p.is_shard(2) else q
              for p, q in zip(x_pl, w_pl)]
    ins, grads = (x_pl, w_pl), (x_pl, w_grad)
    if state is not None:
        ins, grads = ins + (x_pl,), grads + (x_pl,)
    return local_map(_causal_conv, out_placements=(x_pl, x_pl),
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=x.device_mesh)(
                         x, w, *(() if state is None else (state,)))


def _plus_skip(out, xh, skip):
    """A scan's output ``y`` (or ``(y, state)``) plus the skip term
    ``xh * skip`` per head (``skip`` ``[H]``, the D of Mamba-2)."""
    if isinstance(out, tuple):
        return (out[0] + xh * skip[:, None],) + out[1:]
    return out + xh * skip[:, None]


def _scan(fn, xh, dt, A, Bm, Cm, *state, skip=None):
    """``fn(xh, dt, A, Bm, Cm[, h])``, an SSD scan or recurrence (``xh``
    ``[B, S, H, P]``, ``dt`` ``[B, S, H]``, ``A`` ``[H]``, ``Bm`` / ``Cm``
    ``[B, S, N]``, the state ``h`` ``[B, H, P, N]``), plus ``xh * skip``
    per head where ``skip`` ``[H]`` is given; on DTensors under
    ``local_map``: each rank scans its own batch rows (over the data
    axes, when they divide B) and heads (over ``model``, when it divides
    H) as one device does, so no step of the scan communicates.  A
    rank's gradient of ``A`` (and ``skip``) covers its own rows (partial
    over the data axes), of ``Bm`` / ``Cm`` its own heads (partial over
    ``model``)."""
    run, args = fn, (xh, dt, A, Bm, Cm)
    if skip is not None:
        def run(x, d, a, b, c, D, *s):
            return _plus_skip(fn(x, d, a, b, c, *s), x, D)

        args += (skip,)
    if not is_distributed(xh):
        return run(*args, *state)
    from torch.distributed.tensor import Partial

    mesh = xh.device_mesh
    dp, n_dp, mp = mesh_axes(mesh)
    b = 0 if over_data(xh.shape[0], n_dp) else None
    hd = xh.shape[2] % mp == 0

    def pl(bdim, hdim, partial=()):
        return [Partial() if n in partial else p for n, p in zip(
            mesh.mesh_dim_names,
            mesh_placements(mesh, {**{n: bdim for n in dp},
                                   "model": hdim if hd else None}))]

    x_pl, a_pl, bc_pl, h_pl = pl(b, 2), pl(None, 0), pl(b, None), pl(b, 1)
    a_grad = pl(None, 0, dp if b is not None else ())
    bc_grad = pl(b, None, ("model",) if hd else ())
    n_skip = len(args) - 5
    ins = ((x_pl, x_pl, a_pl, bc_pl, bc_pl) + (a_pl,) * n_skip
           + (h_pl,) * len(state))
    grads = ((x_pl, x_pl, a_grad, bc_grad, bc_grad) + (a_grad,) * n_skip
             + (h_pl,) * len(state))
    return local_map(run, out_placements=(x_pl, h_pl) if state else x_pl,
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=mesh)(*args, *state)


def ssd_block(cfg: ModelConfig, p, x, cache=None, use_kernel: bool = True):
    """Mamba-2 SSD mixer.  x: ``[B, S, d]``.  Without ``cache`` the scan
    runs through :func:`repro_torch.kernels.ops.ssd_scan` (the CUDA kernel
    on a CUDA tensor) or, with ``use_kernel=False``, through the plain
    chunked or sequential scan by the reference's condition.  With
    ``cache`` (dict ``conv`` ``[B, Kc-1, H*P]``, ``ssm`` ``[B, H, P, N]``
    float32) it runs the recurrence step by step from the cached state and
    writes the new state into the cache in place.  Returns
    ``(out, cache)``."""
    B, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    # [B, S, HP + HP + N + N + H]; on a mesh made whole over ``model``
    # here, as the split below needs (its pieces do not follow the
    # shards), with its gradient back at the product's placements, a
    # local slice, so the product's backward stays split over ``model``
    proj = whole_over_model(linear(h, p["in_proj"]))
    zx, xin, Bm, Cm, dt = split_last(proj, [H * P, H * P, N, N, H])
    # softplus as jax.nn.softplus forms it: logaddexp(x, 0)
    dt = torch.logaddexp(dt.float() + p["dt_bias"],
                         torch.zeros((), device=x.device))      # [B, S, H]
    A = -torch.exp(p["a_log"].float())                   # [H]
    conv_state = cache["conv"] if cache is not None else None
    # on a mesh the heads' channels are split over model from here on
    # where model divides the heads (each rank convolves its own)
    heads_split = is_distributed(x) and H % mesh_axes(x.device_mesh)[2] == 0
    if heads_split:
        xin, zx = split_over_model(xin), split_over_model(zx)
    xin, new_conv = _conv(xin, p["conv_w"], conv_state)
    xin = F.silu(xin.float()).to(x.dtype)
    xh = split_heads(xin, B, S, H, P)
    # the skip term (jnp.repeat's each head's D over its P channels) is
    # added per head with the scan, on each rank's own heads
    skip = p["d_skip"].to(x.dtype)
    if cache is not None:
        # recurrent decode: S small (1 per decode step; the prompt length
        # at prefill)
        y, hst = _scan(ref.ssd_recurrence, xh, dt, A, Bm, Cm,
                       cache["ssm"].float(), skip=skip)
        write_into(cache["conv"], new_conv)
        write_into(cache["ssm"], hst)
    elif use_kernel:
        y = _scan(ops.ssd_scan, xh, dt, A, Bm, Cm, skip=skip)
    elif cfg.ssd_chunk and S % cfg.ssd_chunk == 0 and S > cfg.ssd_chunk:
        y = _scan(lambda *a: ref.ssd_scan_chunked_ref(*a,
                                                      chunk=cfg.ssd_chunk),
                  xh, dt, A, Bm, Cm, skip=skip)
    else:
        y = _scan(ref.ssd_scan_ref, xh, dt, A, Bm, Cm, skip=skip)
    # on a mesh whose model axis does not divide H the heads are whole on
    # every rank (split_heads), and merge_heads keeps their gradients so
    y = merge_heads(y, B, S, H * P)
    y = y.to(x.dtype) * F.silu(zx.float()).to(x.dtype)
    out = reduce_model(linear(rms_norm(y, p["out_ln"], cfg.rms_eps),
                              p["out_proj"]))
    return out, cache


def hybrid_block(cfg: ModelConfig, p, x, positions, window, cache=None,
                 cache_index=None, use_kernel: bool = True):
    """Hymba: attention and SSD heads in parallel on the same input, each
    branch normalised, then averaged.  ``cache``: dict ``kv`` (``k``/``v``)
    and ``ssd`` (``conv``/``ssm``), updated in place."""
    attn_out, _ = attn_block(cfg, p, x, positions, window=window,
                             cache=cache["kv"] if cache else None,
                             cache_index=cache_index, use_kernel=use_kernel)
    ssd_out, _ = ssd_block(cfg, p, x, cache=cache["ssd"] if cache else None,
                           use_kernel=use_kernel)
    fused = 0.5 * (rms_norm(attn_out, p["fuse_ln_a"], cfg.rms_eps)
                   + rms_norm(ssd_out, p["fuse_ln_s"], cfg.rms_eps))
    return fused, cache
