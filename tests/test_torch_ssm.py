"""The port's ssm (Mamba-2) and hybrid (Hymba) LMs against the JAX package,
with the same weights.

For each smoke config the reference's ``init_params`` makes the weights;
the leaves it initialises to zero (the norms, ``dt_bias``, ``a_log``,
``d_skip`` and Hymba's fusion norms) are replaced with seeded random
values first, so that a wrong head repeat, split order or norm shows.  They
cross as numpy (``params_from_numpy``).  The port's forward (the
``ssd_scan`` dispatch, whose CPU path is the kernel's plain version) must
equal the reference's plain forward within 1e-5 and its kernel forward
(``use_kernels=True``; Pallas in interpret mode; ``unroll_layers=True``
for hymba, whose windows are tracers under the layer scan) within the
reference's serve bound 5e-3.  Cached serving must equal the reference's
prefill / decode (logits and the ``conv``, ``ssm``, ``k``, ``v`` caches)
within 1e-5 and the teacher-forced forward within 5e-3; greedy tokens
must be identical.

The 1e-5 holds elementwise for the caches.  For logits it is taken
against their largest magnitude: the tied embedding (unit-normal rows)
makes logits of magnitude ~50, and the float32 rounding of each logit's
dot product scales with that sum of terms, not with the logit itself.
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
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serve import decode, kvcache

CPU = torch.device("cpu")
ARCHS = ["mamba2-2.7b", "hymba-1.5b"]
TOL = 1e-5
SERVE_TOL = 5e-3
#: leaves the reference initialises to zero, and the scale of the random
#: values that replace them
ZERO_LEAVES = {"ln1": 0.2, "out_ln": 0.2, "dt_bias": 0.5, "a_log": 0.5,
               "d_skip": 1.0, "fuse_ln_a": 0.2, "fuse_ln_s": 0.2,
               "ln2": 0.2, "ln_f": 0.2}


def _perturbed(jparams, seed: int):
    """The reference's weights with its zero-initialised leaves replaced
    by seeded normal values (in each leaf's own type)."""
    r = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ZERO_LEAVES:
                noise = r.standard_normal(v.shape) * ZERO_LEAVES[k]
                out[k] = jnp.asarray(noise, dtype=v.dtype)
            else:
                out[k] = v
        return out

    return walk(jparams)


def _weights(arch: str, seed: int = 0, **replace):
    """(reference config, reference params, port config, port params)."""
    jcfg = dataclasses.replace(jget_config(arch).smoke(), **replace)
    jparams = _perturbed(jlm.init_params(jax.random.key(seed), jcfg),
                         seed + 100)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    cfg = dataclasses.replace(get_config(arch).smoke(), **replace)
    return jcfg, jparams, cfg, tparams


def _tokens(cfg, B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S))


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _close_logits(got: torch.Tensor, want, tol: float):
    """``|got - want| <= tol * max(1, max |want|)`` everywhere."""
    w = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(w).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), w, rtol=0,
                               atol=tol * scale)


def test_perturbation_reaches_every_zero_leaf():
    for arch in ARCHS:
        jcfg, jparams, _, params = _weights(arch)
        fresh = jlm.init_params(jax.random.key(0), jcfg)
        names = set(params["blocks"]) | set(params)
        for name in ZERO_LEAVES:
            if name not in names:
                assert arch == "mamba2-2.7b" and name in (
                    "fuse_ln_a", "fuse_ln_s", "ln2"), (arch, name)
                continue
            leaf = jparams["blocks"].get(name, jparams.get(name))
            base = fresh["blocks"].get(name, fresh.get(name))
            assert not np.any(np.asarray(base)), (arch, name)
            assert np.all(np.asarray(leaf) != 0), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch)
    toks = _tokens(cfg, 2, 24)
    want, _ = jlm.forward(jcfg, jparams, jnp.asarray(toks))
    kcfg = dataclasses.replace(jcfg, use_kernels=True,
                               unroll_layers=arch == "hymba-1.5b")
    want_kernel, _ = jlm.forward(kcfg, jparams, jnp.asarray(toks))
    for use_kernel in (True, False):
        got, aux = lm.forward(cfg, params, torch.from_numpy(toks),
                              use_kernel=use_kernel)
        assert got.shape == (2, 24, cfg.vocab) and float(aux) == 0.0
        _close_logits(got, want, TOL)
        _close(got, want_kernel, SERVE_TOL)
    module = lm.LM(cfg, params)
    assert torch.equal(module(torch.from_numpy(toks)),
                       lm.forward(cfg, params, torch.from_numpy(toks))[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_plain_path_matches_reference(arch):
    """``ssd_chunk = 16`` at S = 64: the plain path takes the chunked
    dual form, as the reference's does."""
    jcfg, jparams, cfg, params = _weights(arch, seed=1, ssd_chunk=16)
    toks = _tokens(cfg, 2, 64, seed=1)
    want, _ = jlm.forward(jcfg, jparams, jnp.asarray(toks))
    got, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                        use_kernel=False)
    _close_logits(got, want, TOL)
    seq, _ = lm.forward(dataclasses.replace(cfg, ssd_chunk=0), params,
                        torch.from_numpy(toks), use_kernel=False)
    _close(got, seq.detach().numpy(), SERVE_TOL)


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


@pytest.mark.parametrize("arch,S0,n_dec", [
    ("mamba2-2.7b", 11, 4), ("hymba-1.5b", 20, 5)])  # hymba: window 16 bites
@pytest.mark.parametrize("use_kernel", [True, False])
def test_serve_matches_reference(arch, S0, n_dec, use_kernel):
    jcfg, jparams, cfg, params = _weights(arch, seed=2)
    toks = _tokens(cfg, 2, S0 + n_dec, seed=1)
    T = S0 + n_dec + 2  # a cache longer than the filled prefix
    want, jcache = _jax_serve(jcfg, jparams, toks, S0, T)
    got, cache = _port_serve(cfg, params, toks, S0, T, use_kernel)
    _close_logits(got, want, TOL)
    names = {"mamba2-2.7b": ("conv", "ssm"),
             "hymba-1.5b": ("conv", "ssm", "k", "v")}[arch]
    assert set(cache) == set(names) == set(jcache)
    for name in names:
        assert cache[name].dtype == (torch.float32 if name == "ssm"
                                     else lm.dtype_of(cfg.compute_dtype))
        _close(cache[name], jcache[name], TOL)
    full, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    _close(got, full[:, S0 - 1:].detach().numpy(), SERVE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch, seed=3)
    prompt = _tokens(cfg, 2, 18, seed=4)
    want = np.asarray(jdecode.greedy_generate(jcfg, jparams,
                                              jnp.asarray(prompt), 6))
    for use_kernel in (True, False):
        got = decode.greedy_generate(cfg, params, torch.from_numpy(prompt),
                                     6, use_kernel=use_kernel)
        assert np.array_equal(got.numpy(), want)


def test_float32_leaves_stay_float32():
    """bfloat16 weights: the SSD's dt_bias, a_log and d_skip stay float32
    on both sides, in the port's own init and across the conversion."""
    bf = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    for arch in ARCHS:
        jcfg = dataclasses.replace(jget_config(arch).smoke(), **bf)
        cfg = dataclasses.replace(get_config(arch).smoke(), **bf)
        jparams = jlm.init_params(jax.random.key(0), jcfg)
        crossed = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
        mine = lm.init_params(torch.Generator().manual_seed(0), cfg)
        for tree in (crossed, mine):
            for name, leaf in tree["blocks"].items():
                want = (torch.float32 if name in lm.FLOAT32_LEAVES
                        else torch.bfloat16)
                assert leaf.dtype == want, (arch, name, leaf.dtype)
        shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
        assert jax.tree.map(lambda a: tuple(a.shape),
                            params_to_numpy(mine)) == shapes
        toks = torch.from_numpy(_tokens(cfg, 1, 8))
        logits, _ = lm.forward(cfg, crossed, toks)
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_reference(arch):
    jcfg, cfg = jget_config(arch).smoke(), get_config(arch).smoke()
    want = jkvcache.init_cache(jcfg, 3, 10)
    got = kvcache.init_cache(cfg, 3, 10, device=CPU)
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape, name
        assert str(leaf.dtype).split(".")[-1] == str(want[name].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch, capsys):
    ops.reset_launch_counts()
    toks = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20",
                       "--max-new", "4"])
    assert toks.shape == (2, 4)
    out = capsys.readouterr().out
    assert "prefill" in out and "tok/s" in out
    assert sum(ops.launch_counts().values()) == 0
