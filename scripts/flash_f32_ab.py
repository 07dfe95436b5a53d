"""One side of an A/B comparison of the float32 attention kernel on a card.

    python scripts/flash_f32_ab.py [--root DIR] [--parity] [--ptxas]

Imports the port (``DIR/src``) and ``DIR/chip_smoke.py`` from the
checkout at DIR (default: the one holding this script), builds its
attention kernel and prints one JSON line: the card (``nvidia-smi`` name
and power limit); with ``--parity`` the largest error of
``chip_smoke.flash_parity`` (every case and head dimension, both types,
raising on a disagreement); for each float32 call of
``chip_smoke.FLASH_MAIN`` the variant, the largest error against the
plain version, CUDA-event ms, profiler device ms, SDPA's device ms with
TF32 off, and the bound; then whisper-small's serving prefill at
``chip_smoke.ENCDEC_TIMED``'s batch and prompt (bf16 weights from seed 0,
float32 frames, so the encoder runs in float32), ``PREFILL_RUNS`` times
after a warm-up, with the flash calls per variant of one prefill.
``--ptxas`` adds nvcc's register and spill report for the kernel.

To compare two trees, unpack one with ``git archive`` and run the script
on each in turn (A, B, B, A) in one command on one card.  It needs a
card and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

#: timed prefills of whisper-small after the warm-up
PREFILL_RUNS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_f32_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_attention import variant
    from repro_torch.launch import serve

    device = torch.device("cuda")
    build.load("flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False  # the SDPA yardstick
    out = {"root": str(root), "card": cs.card_line()}
    if args.ptxas:
        out["ptxas"] = [ln for ln in build.build_log("flash_attention")
                        .splitlines() if "registers" in ln or "spill" in ln
                        or "Compiling entry" in ln]
    if args.parity:
        out["parity_max_abs_err"] = cs.flash_parity(device)

    gen = torch.Generator(device=device).manual_seed(1)
    calls = []
    for (label, B, Hq, Hkv, S, T, D, causal, window, softcap, dt,
         cache_len) in cs.FLASH_MAIN:
        if dt != "float32":
            continue
        q, k, v = cs._attn_inputs(gen, B, Hq, Hkv, S, T, D, torch.float32,
                                  device, cache_len)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q, k, v, use_kernel=False, **kw)
        ok, err = cs._within(got, want, 2e-4, 2e-4)
        is_causal = causal and S == T

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=is_causal, enable_gqa=Hq != Hkv)

        calls.append({
            "label": label, "q": [B, Hq, S, D], "kv": [B, Hkv, T, D],
            "variant": variant(q.dtype, S, Hq // Hkv), "within_2e-4": ok,
            "max_abs_err": err,
            "ms": cs.time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "device_ms": cs.device_ms(
                lambda: ops.flash_attention(q, k, v, **kw))[0],
            "library_device_ms": cs.device_ms(sdpa)[0],
            **cs.flash_bound_ms(B, Hq, Hkv, S, T, D, 4, causal, window)})
        del q, k, v, got, want
    out["flash_float32"] = calls

    cfg = get_config("whisper-small")
    params = cs.cast_params(serve.make_params(cs.as_float32(cfg), device),
                            getattr(torch, cfg.param_dtype))
    batch, prompt_len = cs.ENCDEC_TIMED[:2]
    prompts, extra = serve.make_inputs(cfg, batch, prompt_len, device,
                                       seed=1)
    serve.generate(cfg, params, prompts, 1, **extra)  # warm
    ops.reset_launch_counts()
    times = [serve.generate(cfg, params, prompts, 1, **extra)["prefill_ms"]
             for _ in range(PREFILL_RUNS)]
    out["whisper_prefill"] = {
        "batch": batch, "prompt_len": prompt_len,
        "frames": list(extra["encoder_feats"].shape), "ms": times,
        "median_ms": statistics.median(times),
        "flash_variants_per_prefill": {
            k: n // PREFILL_RUNS
            for k, n in ops.variant_counts()["flash_attention"].items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
