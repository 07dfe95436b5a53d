"""The port's bfloat16 forward against the JAX package's, with the same
weights, for the seven ported configs.

The other parity tests compare the smoke configs, which run in float32;
the full configs run in bfloat16.  Here each smoke config is switched to
bfloat16 weights and activations.  The reference's ``init_params`` makes
the weights, and the leaves it initialises to zero (norms, biases, the
SSD's ``dt_bias`` / ``a_log`` / ``d_skip``) are replaced with seeded
normal values first, so that a wrong norm, bias or head layout shows.  The
port's plain forward (``use_kernel=False``; on the CPU every kernel
dispatch runs its plain version anyway) must give the reference's bf16
logits within the larger of

* one bf16 ulp of the largest logit (the two frameworks round at other
  places, so a logit may land one bf16 step away), and
* twice the reference's own disagreement between its bf16 and float32
  forwards on the same weights, measured here: the rounding noise of the
  bf16 forward itself.

A second test plants a fault in the port's weights (the first block's
``ln1`` left unperturbed) and requires the same comparison to fail, so
the tolerance is shown to have teeth for every config.
``python tests/test_torch_bf16_parity.py`` prints each config's readings.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro_torch.configs.base import get_config
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy

CPU = torch.device("cpu")
ARCHS = ["kratos-dd", "gemma2-2b", "qwen1.5-0.5b", "tinyllama-1.1b",
         "gemma-2b", "mamba2-2.7b", "hymba-1.5b"]
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
#: scale of the random values that replace a zero-initialised leaf
SCALES = {"dt_bias": 0.5, "a_log": 0.5, "d_skip": 1.0}
DEFAULT_SCALE = 0.2


def _perturbed(tree, r: np.random.Generator):
    """``tree`` with every all-zero leaf replaced by seeded normal values
    in the leaf's own type."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturbed(v, r)
        elif not np.asarray(v, dtype=np.float32).any():
            noise = r.standard_normal(v.shape) * SCALES.get(k, DEFAULT_SCALE)
            out[k] = jnp.asarray(noise, dtype=v.dtype)
        else:
            out[k] = v
    return out


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at ``|x|``."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def readings(arch: str, fault: bool = False) -> dict:
    """The comparison for ``arch``: the largest reference logit, the
    reference's bf16-vs-float32 noise, the port's difference from the
    reference and the tolerance.  ``fault`` plants a fault in the port's
    weights only: the first block's ``ln1``, a zero-initialised norm
    weight, left unperturbed."""
    jcfg = dataclasses.replace(jget_config(arch).smoke(), **BF16)
    jparams = _perturbed(jlm.init_params(jax.random.key(0), jcfg),
                         np.random.default_rng(100))
    toks = np.random.default_rng(0).integers(1, jcfg.vocab, (2, 24))
    want = np.asarray(jlm.forward(jcfg, jparams, jnp.asarray(toks))[0],
                      dtype=np.float32)
    # the reference's float32 forward on the same (bf16-valued) weights
    jcfg32 = jget_config(arch).smoke()
    want32 = np.asarray(jlm.forward(
        jcfg32, jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
        jnp.asarray(toks))[0])
    noise = float(np.abs(want - want32).max())

    ported = jax.tree.map(np.asarray, jparams)
    if fault:
        ported["blocks"]["ln1"] = ported["blocks"]["ln1"].copy()
        ported["blocks"]["ln1"][0] = 0
    cfg = dataclasses.replace(get_config(arch).smoke(), **BF16)
    params = params_from_numpy(ported, CPU)
    assert params["embed"].dtype == torch.bfloat16
    got, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                        use_kernel=False)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    assert np.isfinite(got).all()
    max_logit = float(np.abs(want).max())
    return {"max_abs_logit": max_logit, "noise": noise,
            "diff": float(np.abs(got - want).max()),
            "tol": max(bf16_ulp(max_logit), 2.0 * noise)}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    r = readings(arch)
    assert r["diff"] <= r["tol"], (arch, r)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_tolerance_rejects_a_planted_fault(arch):
    """The tolerance is not so loose that it passes a norm weight the
    port failed to load."""
    r = readings(arch, fault=True)
    assert r["diff"] > r["tol"], (arch, r)


if __name__ == "__main__":
    import json

    for arch in ARCHS:
        print(json.dumps({"arch": arch, **readings(arch),
                          "planted_fault_diff":
                              readings(arch, fault=True)["diff"]}))
