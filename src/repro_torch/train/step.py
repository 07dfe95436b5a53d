"""The train step (the port of ``repro/train/step.py``): loss -> gradients
-> (accumulated) -> optimizer update.

Features, as in the reference: sequence-chunked cross entropy, microbatch
gradient accumulation (a Python loop over ``grad_accum`` microbatches for
the reference's ``scan``, float32 sums divided at the end), optional
bf16 / int8 gradient compression between accumulation steps, the MoE
load-balance loss folded in with ``aux_loss_weight``, and fp8 expert
weights.  A vlm batch carries ``patch_embeds`` and an encdec batch
``encoder_feats``; the vlm labels are padded over the patch positions,
which carry no next-token loss.

Gradients come from ``torch.autograd.grad`` over detached views of the
parameter leaves, and each is in its leaf's own type (bf16 for bf16
weights), as ``jax.value_and_grad`` gives them.  The step leaves the
caller's tensors as they were, as the reference's pure function does,
unless it is made with ``donate=True``: then it updates the weights and
the optimizer state in place and returns them, as the reference's step
jitted with ``donate_argnums=(0, 1)`` writes its new state over the old,
and a step holds one train state, not two.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import tree
from ..configs.base import ModelConfig
from ..models.lm import forward
from ..parallel.api import like, on_mesh, plain
from .losses import chunked_xent
from .optimizer import OptConfig, make_optimizer


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = field(default_factory=OptConfig)
    grad_accum: int = 1
    aux_loss_weight: float = 0.01
    grad_compress: str | None = None   # None | "int8" | "bf16"
    fp8_expert_gather: bool = False    # fp8 expert weights (MoE only)


F8_MAX = 448.0


class _Float8Layers(torch.autograd.Function):
    """A float8 stack ``[L, ...]`` as the tuple of its L layer slices
    (views), which the forward indexes as it indexes a stack.  The
    backward stacks the slices' gradients in float32 (exact: float8
    values, one layer's in each place), which autograd casts back to the
    stack's float8.  Indexed one layer at a time, the stack would get L
    gradients that autograd adds, and torch has no float8 addition (the
    reference's ``scan`` stacks them)."""

    @staticmethod
    def forward(ctx, stack):
        return stack.unbind(0)

    @staticmethod
    def backward(ctx, *grads):
        like_ = next(g for g in grads if g is not None)
        return torch.stack([torch.zeros_like(like_, dtype=torch.float32)
                            if g is None else g.float() for g in grads])


def _fp8_expert_params(params):
    """MoE expert weights (``we_i``, ``we_o``) as float8 e4m3 with a
    float32 scale per output channel; the reference's fp8 expert gather.
    Parameters with no ``we_i`` leaf come back as they are."""
    if "blocks" not in params or "we_i" not in params["blocks"]:
        return params
    b = dict(params["blocks"])
    for name in ("we_i", "we_o"):
        w = b[name].float()
        scale = w.abs().amax(dim=-2, keepdim=True) / F8_MAX + 1e-12
        b[name] = (w / scale).to(torch.float8_e4m3fn)
        b[name + "_scale"] = scale
    return {**params, "blocks": b}


def _float8_by_layer(params):
    """``params`` with each float8 stack of ``blocks`` as its layers'
    slices, taken once (:class:`_Float8Layers`)."""
    if "blocks" not in params:
        return params
    return {**params, "blocks": {
        k: _Float8Layers.apply(v) if v.dtype == torch.float8_e4m3fn else v
        for k, v in params["blocks"].items()}}


def _compress(grads, how: str | None):
    if how is None:
        return grads
    if how == "bf16":
        return tree.map(lambda g: g.to(torch.bfloat16).float(), grads)
    if how == "int8":
        def q(g):
            scale = torch.clamp(g.abs().max(), min=1e-8) / 127.0
            qg = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            return qg.float() * scale

        return tree.map(q, grads)
    raise ValueError(how)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig,
                 use_kernel: bool = True):
    """``loss_fn(params, batch) -> (total, (loss, aux))``: the mean token
    cross entropy plus ``aux_loss_weight`` x the auxiliary loss."""
    def loss_fn(params, batch):
        if tcfg.fp8_expert_gather:
            params = _float8_by_layer(_fp8_expert_params(params))
        kw = {k: batch[k] for k in ("patch_embeds", "encoder_feats")
              if k in batch}
        hidden, aux = forward(cfg, params, batch["tokens"],
                              return_hidden=True, train=True,
                              use_kernel=use_kernel, **kw)
        labels = batch["labels"]
        if cfg.family == "vlm":
            # patch positions carry no next-token loss (PAD labels)
            pad = torch.zeros((labels.shape[0],
                               batch["patch_embeds"].shape[1]),
                              dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        loss = chunked_xent(cfg, params, hidden, labels)
        return loss + tcfg.aux_loss_weight * aux, (loss, aux)

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``((total, (loss, aux)), grads)`` of ``loss_fn`` at ``params``.
    On a mesh (DTensor leaves) each gradient comes back in its
    parameter's placements."""
    flat = tree.flatten_with_path(params)
    leaves = [p.detach().requires_grad_() for _, p in flat]
    with on_mesh(leaves):
        total, (loss, aux) = loss_fn(tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else like(g, p)
             for p, g in zip(leaves, grads)]
    return ((total.detach(), (loss.detach(), aux.detach())),
            tree.unflatten(params, grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    use_kernel: bool = True, donate: bool = False):
    """``(train_step, opt_init)``.  ``train_step(params, opt_state,
    batch) -> (new_params, new_opt_state, metrics)`` with ``loss``,
    ``aux_loss`` and ``grad_norm`` as 0-d tensors.  ``use_kernel`` is the
    forward's: the flash kernel under autograd for attention; the SSD
    kernel has no backward, so the ssm and hybrid families train with
    ``use_kernel=False`` on the card (``ops.ssd_scan`` raises
    otherwise).  With ``donate`` the step consumes ``params`` and
    ``opt_state``: it returns them, updated in place (the optimizer's
    ``in_place`` form; accumulated gradients summed into one float32
    buffer in place), so a caller that reads the weights a step started
    from keeps the default."""
    opt_init, opt_update = make_optimizer(tcfg.opt, in_place=donate)
    loss_fn = make_loss_fn(cfg, tcfg, use_kernel)

    def train_step(params, opt_state, batch):
        n = tcfg.grad_accum
        if n > 1:
            micro = [{k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(n)]
            loss = aux = None
            grads = tree.map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for mb in micro:
                (_, (l_mb, a_mb)), g_mb = value_and_grad(loss_fn, params,
                                                          mb)
                g_mb = _compress(g_mb, tcfg.grad_compress)
                if donate:
                    for acc, g in zip(tree.leaves(grads), tree.leaves(g_mb)):
                        acc.add_(g)
                else:
                    grads = tree.map(torch.add, grads, g_mb)
                del g_mb
                loss = l_mb if loss is None else loss + l_mb
                aux = a_mb if aux is None else aux + a_mb
            loss, aux = loss / n, aux / n
            if donate:
                for g in tree.leaves(grads):
                    g.div_(n)
            else:
                grads = tree.map(lambda g: g / n, grads)
        else:
            (_, (loss, aux)), grads = value_and_grad(loss_fn, params, batch)
            grads = _compress(grads, tcfg.grad_compress)
        new_params, new_opt, gnorm = opt_update(grads, opt_state, params)
        metrics = {"loss": plain(loss), "aux_loss": plain(aux),
                   "grad_norm": plain(gnorm)}
        return new_params, new_opt, metrics

    return train_step, opt_init
