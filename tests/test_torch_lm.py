"""The port's dense LMs against the JAX package, with the same weights.

For each dense smoke config the reference's ``init_params`` makes the
weights; they cross as numpy (``params_from_numpy``).  The port's forward
(both routes: the flash dispatch, whose CPU path is the kernel's plain
version over the sliced prefix, and the reference's masked attention)
must equal the reference's forward within 1e-5, through its plain path
and through its own kernel path (``use_kernels=True, unroll_layers=True``,
Pallas in interpret mode).  Cached serving must equal the reference's
``use_kernels=False`` prefill / decode (logits and cache contents) within
1e-5, and the teacher-forced forward within the reference's serve bound
5e-3; greedy tokens must be identical.
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
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serve import decode, kvcache

CPU = torch.device("cpu")
DENSE = ["kratos-dd", "qwen1.5-0.5b", "tinyllama-1.1b", "gemma-2b",
         "gemma2-2b"]
TOL = 1e-5
SERVE_TOL = 5e-3


def _weights(arch: str, seed: int = 0):
    """(reference config, reference params, port config, port params)."""
    jcfg = jget_config(arch).smoke()
    jparams = jlm.init_params(jax.random.key(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return jcfg, jparams, get_config(arch).smoke(), tparams


def _tokens(cfg, B: int, S: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S))


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def test_config_copy_matches_reference():
    from repro.configs.base import list_configs as jlist
    from repro_torch.configs.base import list_configs

    assert list_configs() == jlist()
    for name in list_configs():
        a = dataclasses.asdict(get_config(name))
        b = dataclasses.asdict(jget_config(name))
        assert a == b, name
        assert dataclasses.asdict(get_config(name).smoke()) == \
            dataclasses.asdict(jget_config(name).smoke())


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch)
    toks = _tokens(cfg, 2, 24)
    want, _ = jlm.forward(jcfg, jparams, jnp.asarray(toks))
    kcfg = dataclasses.replace(jcfg, use_kernels=True, unroll_layers=True)
    want_kernel, _ = jlm.forward(kcfg, jparams, jnp.asarray(toks))
    for use_kernel in (True, False):
        got, aux = lm.forward(cfg, params, torch.from_numpy(toks),
                              use_kernel=use_kernel)
        assert got.shape == (2, 24, cfg.vocab) and float(aux) == 0.0
        _close(got, want, TOL)
        _close(got, want_kernel, TOL)
    module = lm.LM(cfg, params)
    assert torch.equal(module(torch.from_numpy(toks)),
                       lm.forward(cfg, params, torch.from_numpy(toks))[0])


def _jax_serve(jcfg, jparams, toks, S0: int, T: int):
    """The reference's plain-path prefill of ``toks[:, :S0]`` then decode
    of the rest: per-step logits and the final cache."""
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
    ("kratos-dd", 11, 4), ("qwen1.5-0.5b", 7, 3), ("tinyllama-1.1b", 9, 3),
    ("gemma-2b", 5, 3), ("gemma2-2b", 20, 6)])  # gemma2: the window (16) bites
@pytest.mark.parametrize("use_kernel", [True, False])
def test_serve_matches_reference(arch, S0, n_dec, use_kernel):
    jcfg, jparams, cfg, params = _weights(arch, seed=2)
    toks = _tokens(cfg, 2, S0 + n_dec, seed=1)
    T = S0 + n_dec + 2  # a cache longer than the filled prefix
    want, jcache = _jax_serve(jcfg, jparams, toks, S0, T)
    got, cache = _port_serve(cfg, params, toks, S0, T, use_kernel)
    _close(got, want, TOL)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], TOL)
    full, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    _close(got, full[:, S0 - 1:].detach().numpy(), SERVE_TOL)


@pytest.mark.parametrize("arch", ["kratos-dd", "gemma2-2b"])
def test_greedy_tokens_match_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch, seed=3)
    prompt = _tokens(cfg, 2, 18, seed=4)
    want = np.asarray(jdecode.greedy_generate(jcfg, jparams,
                                              jnp.asarray(prompt), 6))
    for use_kernel in (True, False):
        got = decode.greedy_generate(cfg, params, torch.from_numpy(prompt),
                                     6, use_kernel=use_kernel)
        assert np.array_equal(got.numpy(), want)


def test_generate_keeps_logits_and_times():
    _, _, cfg, params = _weights("gemma2-2b", seed=5)
    prompts = serve.make_inputs(cfg, 2, 19, CPU, seed=6)[0]
    res = serve.generate(cfg, params, prompts, 5, keep_logits=True)
    assert res["tokens"].shape == (2, 5)
    assert res["logits"].shape == (2, 5, cfg.vocab)
    assert torch.equal(res["tokens"], res["logits"].argmax(-1))
    assert torch.equal(res["tokens"], decode.greedy_generate(
        cfg, params, prompts, 5))
    assert res["prefill_ms"] > 0 and res["tok_per_s"] > 0


def test_params_round_trip_and_layout():
    jcfg, jparams, cfg, params = _weights("gemma2-2b")
    back = params_to_numpy(params)
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        assert np.array_equal(node, np.asarray(leaf))
    mine = lm.init_params(torch.Generator().manual_seed(0), cfg)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda a: tuple(a.shape),
                        params_to_numpy(mine)) == shapes
    bf = params_from_numpy({"w": np.ones((2, 2), jnp.bfloat16)}, CPU)
    assert bf["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["kratos-dd", "gemma2-2b"])
def test_serve_cli_runs_on_cpu(arch, capsys):
    toks = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20",
                       "--max-new", "4"])
    assert toks.shape == (2, 4)
    out = capsys.readouterr().out
    assert "prefill" in out and "tok/s" in out
