"""The port's int8 KV cache against the JAX package's, with the same
weights and prompts, for kratos-dd (dense) and deepseek-moe-16b (moe)
smoke configs with ``kv_cache_dtype="int8"``.

Both quantize each (token, head) row by its abs-max / 127 and round half
to even.  One float32 ulp in a projection can move a code by 1 at a .5
boundary, so the codes may differ by at most 1, on a share that is
reported and bounded; the float32 scales agree within 1e-6 relative.  The
logits of prefill and decode (both attention routes: the kernel route
dequantizes only the filled prefix, the plain route the whole cache
masked by its fill, as the reference does) agree within the reference's
serve bound 5e-3, and the greedy tokens are identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import lm as jlm
from repro.serve import decode as jdecode
from repro.serve import kvcache as jkvcache
from repro_torch.configs.base import get_config
from repro_torch.models import blocks
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import decode, kvcache

CPU = torch.device("cpu")
ARCHS = ["kratos-dd", "deepseek-moe-16b"]
SERVE_TOL = 5e-3
SCALE_RTOL = 1e-6
#: the largest share of cache codes allowed to differ (by 1) from the
#: reference's
CODE_FLIP_SHARE = 1e-3


def _weights(arch: str, seed: int = 0):
    jcfg = dataclasses.replace(jget_config(arch).smoke(),
                               kv_cache_dtype="int8")
    jparams = jlm.init_params(jax.random.key(seed), jcfg)
    cfg = dataclasses.replace(get_config(arch).smoke(), kv_cache_dtype="int8")
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), CPU)


def code_flips(got: torch.Tensor, want) -> tuple[int, float]:
    """The largest |difference| of two int8 code tensors and the share
    of codes that differ."""
    d = np.abs(got.numpy().astype(np.int32) - np.asarray(want, np.int32))
    return int(d.max()), float((d > 0).mean())


def test_cache_layout_matches_reference():
    for arch in ARCHS:
        jcfg, _, cfg, _ = _weights(arch)
        want = jkvcache.init_cache(jcfg, 3, 10)
        got = kvcache.init_cache(cfg, 3, 10, device=CPU)
        assert set(got) == set(want) == {"k", "v", "k_scale", "v_scale"}
        for k, w in want.items():
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
            assert not got[k].any()


def test_q8_rounds_half_to_even():
    """Codes of exact .5 multiples of the scale round to even, and an
    all-zero row keeps the 1e-8 floor."""
    row = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 0.0, 64.0]])
    codes, scale = blocks.q8(row)
    assert scale.item() == 1.0
    assert codes.tolist() == [[127, 0, 2, 2, 0, -4, 0, 64]]
    zero_codes, zero_scale = blocks.q8(torch.zeros(1, 4))
    assert zero_scale.item() == pytest.approx(1e-8) and not zero_codes.any()


def _jax_serve(jcfg, jparams, toks, S0: int, T: int):
    cache = jkvcache.init_cache(jcfg, toks.shape[0], T)
    logits, cache = jdecode.prefill(jcfg, jparams, cache,
                                    jnp.asarray(toks[:, :S0]))
    out = [np.asarray(logits)]
    for pos in range(S0, toks.shape[1]):
        logits, cache = jdecode.decode_step(
            jcfg, jparams, cache, jnp.asarray(toks[:, pos:pos + 1]), pos)
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1), cache


def _port_serve(cfg, params, toks, S0: int, T: int, use_kernel: bool):
    cache = kvcache.init_cache(cfg, toks.shape[0], T, device=CPU)
    tt = torch.from_numpy(toks)
    logits, cache = decode.prefill(cfg, params, cache, tt[:, :S0],
                                   use_kernel=use_kernel)
    out = [logits]
    for pos in range(S0, toks.shape[1]):
        logits, cache = decode.decode_step(cfg, params, cache,
                                           tt[:, pos:pos + 1], pos,
                                           use_kernel=use_kernel)
        out.append(logits)
    return torch.cat(out, dim=1), cache


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_int8_serve_matches_reference(arch, use_kernel):
    jcfg, jparams, cfg, params = _weights(arch, seed=1)
    S0, n_dec = 10, 5
    toks = np.random.default_rng(2).integers(1, cfg.vocab, (2, S0 + n_dec))
    T = S0 + n_dec + 3
    want, jcache = _jax_serve(jcfg, jparams, toks, S0, T)
    got, cache = _port_serve(cfg, params, toks, S0, T, use_kernel)
    np.testing.assert_allclose(got.numpy(), want, rtol=SERVE_TOL,
                               atol=SERVE_TOL)
    assert np.array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    for name in ("k", "v"):
        assert cache[name].dtype == torch.int8
        worst, share = code_flips(cache[name], jcache[name])
        print(f"{arch} {name}: codes differing {share:.2e} (max |d| "
              f"{worst})")
        assert worst <= 1 and share <= CODE_FLIP_SHARE, (worst, share)
        np.testing.assert_allclose(cache[name + "_scale"].numpy(),
                                   np.asarray(jcache[name + "_scale"]),
                                   rtol=SCALE_RTOL, atol=0)
    # the positions past the fill stay empty
    assert not cache["k"][:, :, S0 + n_dec:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_greedy_tokens_match_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch, seed=3)
    prompt = np.random.default_rng(4).integers(1, cfg.vocab, (2, 12))
    want = np.asarray(jdecode.greedy_generate(jcfg, jparams,
                                              jnp.asarray(prompt), 6))
    for use_kernel in (True, False):
        got = decode.greedy_generate(cfg, params, torch.from_numpy(prompt),
                                     6, use_kernel=use_kernel)
        assert np.array_equal(got.numpy(), want)


def test_int8_kernel_route_reads_only_the_filled_prefix():
    """The kernel route hands attention the dequantized filled prefix,
    contiguous and in the compute type; the plain route the whole cache."""
    cfg = dataclasses.replace(get_config("kratos-dd").smoke(),
                              kv_cache_dtype="int8")
    cache = kvcache.init_cache(cfg, 2, 9, device=CPU)
    layer = {k: v[0] for k, v in cache.items()}
    k = torch.randn(2, 4, cfg.n_kv_heads, cfg.hd)
    blocks._write_kv(layer, k, -k, 3)
    kd, vd = blocks._cached_kv(layer, 7, torch.float32)
    assert kd.shape[1] == 7 and kd.is_contiguous() and \
        kd.dtype == torch.float32
    assert not kd[:, :3].any() and torch.equal(vd, -kd)
    err = (kd[:, 3:] - k).abs().amax(-1)
    assert bool((err <= layer["k_scale"][:, 3:7] / 2 + 1e-7).all())
    full, _ = blocks._cached_kv(layer, None, torch.float32)
    assert full.shape[1] == 9
