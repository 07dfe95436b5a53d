"""Double-Duty on the card: the FFN input projections of a model run
through the bit-plane (unrolled constant-weight) kernel — the port of
``examples/quantized_serve.py``.

    python -m repro_torch.launch.quantized_serve [--bits 6]
        [--arch kratos-dd] [--smoke] [--rows 8 4096] [--device cuda]

Quantizes every layer's FFN ``wi`` to ``--bits`` planes, reports the plane
sparsity (the paper's zero-selector-row skip opportunity), runs
``bitplane_linear`` on random activations of each ``--rows`` height
through every layer and checks its mean relative error against the
float32 ``x @ wi`` (< 0.2, as the example does).  The default device is
the card; without one it raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs.base import ModelConfig, get_config
from ..device import resolve_device
from ..models.lm import forward
from ..quant.bitplane import (bitplane_linear, plane_sparsity,
                              quantize_bitplanes)
from .serve import make_params

#: the example's bound on the mean relative error of the 6-bit projection
MAX_REL_ERR = 0.2


def run(cfg: ModelConfig, params: dict, bits: int = 6, rows=(8,),
        seed: int = 0) -> dict:
    """Quantize each layer's ``wi`` and run the bit-plane projection
    against the float32 one; raises if an error exceeds the bound."""
    wi = params["blocks"]["wi"]                  # [L, d, 2F]
    device = wi.device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 32))).to(device)
    ref_logits, _ = forward(cfg, params, toks)
    planes_scales = [quantize_bitplanes(wi[i].float(), bits=bits)
                     for i in range(wi.shape[0])]
    sparsity = [float(plane_sparsity(p)) for p, _ in planes_scales]
    rel = {}
    for m in rows:
        x = torch.from_numpy(rng.standard_normal((m, cfg.d_model)).astype(
            np.float32)).to(device)
        errs = []
        for i, (planes, scale) in enumerate(planes_scales):
            y = bitplane_linear(x, planes, scale)
            y_exact = x @ wi[i].float()
            errs.append(float((y - y_exact).abs().mean()
                              / y_exact.abs().mean()))
        rel[m] = errs
        worst = max(errs)
        if not worst < MAX_REL_ERR:
            raise RuntimeError(f"bitplane({bits}b) projection at {m} rows: "
                               f"mean rel err {worst:.4f} >= {MAX_REL_ERR}")
    return {"arch": cfg.name, "bits": bits, "layers": wi.shape[0],
            "wi_shape": list(wi.shape[1:]),
            "plane_sparsity": float(np.mean(sparsity)),
            "plane_sparsity_per_layer": sparsity,
            "mean_rel_err": {str(m): errs for m, errs in rel.items()},
            "ref_logits_shape": list(ref_logits.shape)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", type=int, default=6)
    ap.add_argument("--arch", default="kratos-dd")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--rows", type=int, nargs="+", default=[8])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    res = run(cfg, make_params(cfg, device), bits=args.bits,
              rows=tuple(args.rows))
    for m, errs in res["mean_rel_err"].items():
        print(f"bitplane({args.bits}b) FFN projection at {m} rows: mean rel "
              f"err {max(errs):.4f} (worst of {res['layers']} layers) vs "
              f"fp32; plane sparsity {res['plane_sparsity']:.2%}")
    print("ref logits shape:", tuple(res["ref_logits_shape"]),
          "- bitplane path verified")
    return res


if __name__ == "__main__":
    main()
