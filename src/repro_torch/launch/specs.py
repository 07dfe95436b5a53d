"""Shape-only stand-ins for every model input (the port of
``repro/launch/specs.py``): ``meta`` tensors, which carry a shape and a
type and allocate nothing, in place of ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import math

import torch

from .. import tree
from ..configs.base import ModelConfig, ShapeConfig
from ..models.layers import dtype_of


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of a train or prefill step: ``tokens`` (and ``labels``
    for train) ``[B, S]`` int32, a vlm model's ``patch_embeds`` or an
    encdec model's ``encoder_feats`` in the compute type."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": sds((B, S), torch.int32),
           "labels": sds((B, S), torch.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = sds((B, cfg.n_patches, cfg.d_model),
                                  dtype_of(cfg.compute_dtype))
    if cfg.family == "encdec":
        out["encoder_feats"] = sds((B, cfg.encoder_seq, cfg.d_model),
                                   dtype_of(cfg.compute_dtype))
    if shape.kind in ("prefill", "decode"):
        out.pop("labels")
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One decode step's inputs: one new token per row, the position and
    a cache of ``seq_len`` positions."""
    from ..serve.kvcache import init_cache

    B, S = shape.global_batch, shape.seq_len
    return {"tokens": sds((B, 1), torch.int32),
            "pos": sds((), torch.int32),
            "cache": init_cache(cfg, B, S,
                                encoder_len=cfg.encoder_seq or None,
                                device="meta")}


def params_shape(cfg: ModelConfig) -> dict:
    """The weight tree of ``cfg`` as ``meta`` tensors (``init_params``
    with nothing drawn)."""
    from ..models.lm import init_params

    return init_params(None, cfg)


def count_params(shapes) -> int:
    return sum(math.prod(t.shape) for t in tree.leaves(shapes))
