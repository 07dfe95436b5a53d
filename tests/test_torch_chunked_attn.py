"""``chunked_local_attn`` in the port against the JAX package, with the
same weights and inputs (numpy from a seed).

* ``local_chunked_attention`` against the reference's (1e-5), with and
  without softcap, for G 1 and G 2, and against the masked attention
  with the same window (the same function);
* the dispatch: the block-local path exactly where the reference takes
  it (the flag, an int window, no ``kv_len``, S == T, ``2 w <= S``,
  ``S % w == 0``, causal), the ordinary route everywhere else;
* the teacher-forced forward with the flag set (1e-5) and cached
  serving — prefill / decode logits and caches, greedy tokens (the
  reference's serve bound 5e-3) — on both routes (the kernel route's
  flash is its plain version on the CPU), for the gemma2-2b and
  hymba-1.5b smoke configs (window 16): S a multiple of the window,
  S % window != 0 and decode steps, where the reference falls through;
* one train step's loss with the flag set (1e-4, the train tests').

The reference takes the block-local path only with a static window, so
its side runs with ``unroll_layers=True``; the port's layers are a
Python loop with int windows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.data.pipeline import batch_for_step as jbatch_for_step
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import decode as jdecode
from repro.serve import kvcache as jkvcache
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.models import layers, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import decode, kvcache
from repro_torch.train import optimizer, step

CPU = torch.device("cpu")
TOL = 1e-5
SERVE_TOL = 5e-3
GRAD_TOL = 1e-4
ARCHS = ["gemma2-2b", "hymba-1.5b"]
#: hymba's local layers are all but the first, middle and last: four
#: layers give it one (the smoke config's two are both global)
LAYERS = {"gemma2-2b": 2, "hymba-1.5b": 4}
#: the reference's zero-initialised leaves, perturbed so a wrong norm or
#: skip shows (as in the SSM and train tests)
ZERO_LEAVES = {"ln1": 0.2, "out_ln": 0.2, "dt_bias": 0.5, "a_log": 0.5,
               "d_skip": 1.0, "fuse_ln_a": 0.2, "fuse_ln_s": 0.2,
               "ln2": 0.2, "ln_f": 0.2, "post_ln": 0.2, "post_ln2": 0.2}


def _perturbed(jparams, seed: int):
    r = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                jnp.asarray(r.standard_normal(v.shape) * ZERO_LEAVES[k],
                            dtype=v.dtype) if k in ZERO_LEAVES else v
                for k, v in t.items()}

    return walk(jparams)


def _weights(arch: str, seed: int = 0):
    """(reference config, its params, port config, port params), both
    configs with ``chunked_local_attn`` set."""
    kw = dict(n_layers=LAYERS[arch], chunked_local_attn=True)
    jcfg = dataclasses.replace(jget_config(arch).smoke(), unroll_layers=True,
                               **kw)
    jparams = _perturbed(jlm.init_params(jax.random.key(seed), jcfg),
                         seed + 100)
    cfg = dataclasses.replace(get_config(arch).smoke(), **kw)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), CPU)


def _close(got, want, tol: float, what: str = ""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _close_logits(got, want, arch: str, tol: float = TOL):
    """Logits within ``tol``: elementwise for gemma2-2b, as
    ``test_torch_lm.py`` holds the dense family; for hymba-1.5b against
    their largest magnitude, as ``test_torch_ssm.py`` holds the hybrid
    one (each logit's float32 rounding scales with its dot product's
    terms, ~50 through the tied embedding)."""
    w = np.asarray(want, dtype=np.float32)
    scale = max(1.0, float(np.abs(w).max())) if arch == "hymba-1.5b" else 0
    np.testing.assert_allclose(got.detach().float().numpy(), w,
                               rtol=0 if scale else tol,
                               atol=tol * scale if scale else tol)


def _qkv(B, S, Hq, Hkv, D, seed: int):
    r = np.random.default_rng(seed)
    return [r.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_local_chunked_attention_matches_reference(G, softcap):
    w = 16
    q, k, v = _qkv(2, 4 * w, 4, 4 // G, 16, seed=G)
    want = jlayers.local_chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w, softcap=softcap)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = layers.local_chunked_attention(tq, tk, tv, w, softcap=softcap)
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, want, TOL)
    # the masked attention with the same window computes the same function
    _close(got, layers.attention_ref(tq, tk, tv, window=w,
                                     softcap=softcap).numpy(), TOL)
    scaled = layers.local_chunked_attention(tq, tk, tv, w, scale=0.1)
    _close(scaled, jlayers.local_chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w, scale=0.1), TOL)


#: (S, T, window, kv_len, causal, flag) -> does the block-local path apply
DISPATCH = [
    ((32, 32, 16, False, True, True), True),
    ((48, 48, 16, False, True, True), True),
    ((32, 32, 16, False, True, False), False),      # flag off
    ((40, 40, 16, False, True, True), False),       # S % w != 0
    ((16, 16, 16, False, True, True), False),       # 2 w > S
    ((32, 32, 16, True, True, True), False),        # kv_len (cached)
    ((1, 33, 16, False, True, True), False),        # decode: S != T
    ((32, 32, 16, False, False, True), False),      # not causal
    ((32, 32, None, False, True, True), False),     # no window
    ((32, 32, 1 << 30, False, True, True), False),  # a global layer
]


@pytest.mark.parametrize("case,applies", DISPATCH)
def test_dispatch_takes_the_reference_conditions(monkeypatch, case,
                                                 applies):
    S, T, window, with_len, causal, flag = case
    cfg = dataclasses.replace(get_config("gemma2-2b").smoke(),
                              chunked_local_attn=flag)
    q = torch.from_numpy(_qkv(2, S, 4, 2, 16, seed=3)[0])
    _, k, v = map(torch.from_numpy, _qkv(2, T, 4, 2, 16, seed=4))
    kw = dict(window=window, causal=causal, softcap=50.0)
    if with_len:
        kw.update(kv_len=torch.full((2,), T),
                  q_positions=torch.arange(T - S, T)[None].expand(2, S))
    assert layers.chunked_applies(cfg, q, k, window=window,
                                  kv_len=kw.get("kv_len"),
                                  causal=causal) == applies
    calls = []
    chunked = layers.local_chunked_attention
    monkeypatch.setattr(layers, "local_chunked_attention",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    plain = layers.attention(cfg, q, k, v, use_kernel=False, **kw)
    assert len(calls) == int(applies)
    # both routes compute the masked attention's function
    want = layers.attention_ref(q, k, v, **kw)
    _close(plain, want.numpy(), TOL)
    _close(layers.attention(cfg, q, k, v, **kw), want.numpy(), TOL)
    # and the reference's dispatch gives the same
    jkw = {n: jnp.asarray(t.numpy()) if isinstance(t, torch.Tensor) else t
           for n, t in kw.items()}
    jcfg = dataclasses.replace(jget_config("gemma2-2b").smoke(),
                               chunked_local_attn=flag)
    _close(plain, jlayers.attention(jcfg, *(jnp.asarray(t.numpy())
                                           for t in (q, k, v)), **jkw), TOL)


def _count_chunked(monkeypatch) -> list:
    calls = []
    chunked = layers.local_chunked_attention

    def counted(*a, **k):
        calls.append(a[0].shape[1])
        return chunked(*a, **k)

    monkeypatch.setattr(layers, "local_chunked_attention", counted)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [32, 40])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_forward_matches_reference(monkeypatch, arch, S, use_kernel):
    """S 32: the local layer takes the block-local path (two blocks of
    16); S 40 (not a multiple of 16): it falls through, as in the
    reference."""
    jcfg, jparams, cfg, params = _weights(arch)
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, S))
    want, _ = jlm.forward(jcfg, jparams, jnp.asarray(toks))
    calls = _count_chunked(monkeypatch)
    got, _ = lm.forward(cfg, params, torch.from_numpy(toks),
                        use_kernel=use_kernel)
    _close_logits(got, want, arch)
    n_local = sum(w == cfg.local_window for _, _, ws in lm.stacks(cfg)
                  for w in ws)
    assert n_local == 1
    assert len(calls) == (n_local if not use_kernel and S % 16 == 0 else 0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_serve_matches_reference(arch, use_kernel):
    """Prefill of 32 tokens (cached, so ``kv_len`` is set and the
    reference falls through) then decode steps across the window."""
    jcfg, jparams, cfg, params = _weights(arch, seed=2)
    S0, n_dec = 32, 5
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, S0 + n_dec))
    T = S0 + n_dec + 2
    jcache = jkvcache.init_cache(jcfg, 2, T)
    jl, jcache = jdecode.prefill(jcfg, jparams, jcache,
                                 jnp.asarray(toks[:, :S0]))
    want = [np.asarray(jl)]
    cache = kvcache.init_cache(cfg, 2, T, device=CPU)
    tt = torch.from_numpy(toks)
    tl, cache = decode.prefill(cfg, params, cache, tt[:, :S0],
                               use_kernel=use_kernel)
    got = [tl]
    for pos in range(S0, S0 + n_dec):
        jl, jcache = jdecode.decode_step(jcfg, jparams, jcache,
                                         jnp.asarray(toks[:, pos:pos + 1]),
                                         pos)
        want.append(np.asarray(jl))
        tl, cache = decode.decode_step(cfg, params, cache,
                                       tt[:, pos:pos + 1], pos,
                                       use_kernel=use_kernel)
        got.append(tl)
    got = torch.cat(got, dim=1)
    _close(got, np.concatenate(want, axis=1), SERVE_TOL, "logits")
    for name in ("k", "v"):
        _close(cache[name], jcache[name], SERVE_TOL, name)
    full, _ = lm.forward(cfg, params, tt, use_kernel=use_kernel)
    _close(got, full[:, S0 - 1:].detach().numpy(), SERVE_TOL, "forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch, seed=4)
    prompt = np.random.default_rng(5).integers(1, cfg.vocab, (2, 32))
    want = np.asarray(jdecode.greedy_generate(jcfg, jparams,
                                              jnp.asarray(prompt), 6))
    for use_kernel in (True, False):
        got = decode.greedy_generate(cfg, params, torch.from_numpy(prompt),
                                     6, use_kernel=use_kernel)
        assert np.array_equal(got.numpy(), want), use_kernel


@pytest.mark.parametrize("use_kernel", [True, False])
def test_train_step_loss_matches_reference(monkeypatch, use_kernel):
    """gemma2-2b's smoke config at S 32: the local layer's attention is
    block-local on the plain route (and under autograd)."""
    jcfg, jparams, cfg, params = _weights("gemma2-2b", seed=6)
    opt = dict(lr=3e-3, warmup_steps=5, decay_steps=10)
    jt = jstep.TrainConfig(opt=jopt.OptConfig(**opt))
    tt = step.TrainConfig(opt=optimizer.OptConfig(**opt))
    batch = jbatch_for_step(jcfg, 32, 4, step=0, seed=7)
    j_step, j_init = jstep.make_train_step(jcfg, jt)
    _, _, jmetrics = jax.jit(j_step)(
        jparams, j_init(jparams), {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    calls = _count_chunked(monkeypatch)
    t_step, t_init = step.make_train_step(cfg, tt, use_kernel=use_kernel)
    _, _, metrics = t_step(params, t_init(params), to_device(batch, CPU))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    assert len(calls) == (0 if use_kernel else 1)
