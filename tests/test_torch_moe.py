"""The port's MoE family against the JAX package, with the same weights.

For the deepseek-moe-16b and kimi-k2-1t-a32b smoke configs the
reference's ``init_params`` makes the weights (the zero-initialised norm
leaves perturbed, so a wrong norm offset shows); they cross as numpy
(``params_from_numpy``).  Held to the reference:

* the router, the load-balance loss and both MoE blocks on one layer
  (1e-5), and a planted capacity overflow, whose drop decisions must be
  the reference's;
* ``forward`` with ``train=False`` (dropless) and ``train=True``
  (capacity-dropped), logits and aux (1e-5), through both attention
  routes;
* prefill and decode logits and caches against the reference's plain
  serving path (1e-5), against the teacher-forced forward (the
  reference's serve bound 5e-3), and identical greedy tokens;
* the train step's loss and gradients against ``jax.grad`` of the
  reference's loss (1e-4), with and without ``fp8_expert_gather``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.data.pipeline import batch_for_step as jbatch_for_step
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.serve import decode as jdecode
from repro.serve import kvcache as jkvcache
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.models import blocks, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import decode, kvcache
from repro_torch.train import optimizer, step

CPU = torch.device("cpu")
MOE = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]
TOL = 1e-5
SERVE_TOL = 5e-3
GRAD_TOL = 1e-4
#: the reference's zero-initialised norm weights, replaced by normals of
#: this scale
NORM_SCALE = 0.2


def _perturbed(jparams, seed: int):
    r = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                jnp.asarray(r.standard_normal(v.shape) * NORM_SCALE,
                            dtype=v.dtype)
                if k in ("ln1", "ln2", "ln_f") else v
                for k, v in t.items()}

    return walk(jparams)


def _weights(arch: str, seed: int = 0, **overrides):
    jcfg = dataclasses.replace(jget_config(arch).smoke(), **overrides)
    jparams = _perturbed(jlm.init_params(jax.random.key(seed), jcfg),
                         seed + 100)
    cfg = dataclasses.replace(get_config(arch).smoke(), **overrides)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), CPU)


def _close(got, want, tol: float, what: str = ""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _layer(jparams, params, i: int = 0):
    """MoE layer ``i``'s weights on both sides."""
    return (jax.tree.map(lambda a: a[i], jparams["blocks"]),
            lm.layer_params(params, i))


def _acts(cfg, shape, seed: int):
    return np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)


@pytest.mark.parametrize("arch", MOE)
def test_route_and_aux_loss_match_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch)
    jp, p = _layer(jparams, params)
    for shape in ((24, cfg.d_model), (3, 8, cfg.d_model)):
        ht = _acts(cfg, shape, seed=1)
        want = jblocks._moe_route(jcfg, jp, jnp.asarray(ht))
        got = blocks._moe_route(cfg, p, torch.from_numpy(ht))
        for g, w, name in zip(got, want, ("probs", "gates", "onehot")):
            assert g.dtype == torch.float32
            _close(g, w, TOL, name)
        _close(blocks._moe_aux_loss(cfg, got[0], got[2]),
               jblocks._moe_aux_loss(jcfg, want[0], want[2]), TOL, "aux")


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_block_matches_reference(arch, dropless):
    jcfg, jparams, cfg, params = _weights(arch)
    jp, p = _layer(jparams, params)
    x = _acts(cfg, (2, 64, cfg.d_model), seed=2)  # two groups of 64
    jfn = jblocks.moe_block_dropless if dropless else jblocks.moe_block
    fn = blocks.moe_block_dropless if dropless else blocks.moe_block
    want, waux = jfn(jcfg, jp, jnp.asarray(x))
    got, aux = fn(cfg, p, torch.from_numpy(x))
    _close(got, want, TOL, "out")
    _close(aux, waux, TOL, "aux")


def test_capacity_drops_match_reference():
    """A planted overflow: the router sends every token's first choice to
    expert 0 (a large bias on its column through a constant feature), so
    each group of 8 tokens overflows its capacity of 5 there.  The
    capacity-dropped block must drop what the reference drops: its output
    equals the reference's, and differs from the dropless one exactly at
    the tokens past the capacity in each group."""
    jcfg, jparams, cfg, params = _weights("deepseek-moe-16b",
                                          moe_group_size=8)
    jp, p = _layer(jparams, params)
    router = np.asarray(jp["router"]).copy()
    router[0, 0] = 1e3             # feature 0 votes for expert 0
    jp = {**jp, "router": jnp.asarray(router)}
    p = {**p, "router": torch.from_numpy(router)}
    x = _acts(cfg, (2, 8, cfg.d_model), seed=3)
    x[..., 0] = 3.0                # ... strongly, for every token
    C = int(8 * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    assert C == 5
    want, _ = jblocks.moe_block(jcfg, jp, jnp.asarray(x))
    got, _ = blocks.moe_block(cfg, p, torch.from_numpy(x))
    _close(got, want, TOL)
    full, _ = blocks.moe_block_dropless(cfg, p, torch.from_numpy(x))
    moved = (got - full).abs().amax(-1).reshape(-1) > 1e-4
    expect = torch.tensor([i % 8 >= C for i in range(16)])
    assert torch.equal(moved, expect), moved
    wfull, _ = jblocks.moe_block_dropless(jcfg, jp, jnp.asarray(x))
    wmoved = np.abs(np.asarray(want) - np.asarray(wfull)).max(-1) \
        .reshape(-1) > 1e-4
    assert np.array_equal(wmoved, expect.numpy())


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_reference(arch, train):
    jcfg, jparams, cfg, params = _weights(arch)
    toks = np.random.default_rng(4).integers(1, cfg.vocab, (2, 24))
    want, waux = jlm.forward(jcfg, jparams, jnp.asarray(toks), train=train)
    assert float(waux) > 0
    for use_kernel in (True, False):
        got, aux = lm.forward(cfg, params, torch.from_numpy(toks),
                              train=train, use_kernel=use_kernel)
        _close(got, want, TOL, "logits")
        _close(aux, waux, TOL, "aux")


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


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_serve_matches_reference(arch, use_kernel):
    """Prefill then decode, the dense layer's cache entry first: logits
    and every cache entry within 1e-5 of the reference's serving path,
    and within its serve bound of the teacher-forced forward."""
    jcfg, jparams, cfg, params = _weights(arch, seed=2)
    S0, n_dec = 9, 4
    toks = np.random.default_rng(5).integers(1, cfg.vocab, (2, S0 + n_dec))
    T = S0 + n_dec + 2
    want, jcache = _jax_serve(jcfg, jparams, toks, S0, T)
    got, cache = _port_serve(cfg, params, toks, S0, T, use_kernel)
    _close(got, want, TOL, "logits")
    assert set(cache) == set(jcache) == {"k", "v"}
    for name in cache:
        assert cache[name].shape[0] == cfg.n_layers
        _close(cache[name], jcache[name], TOL, name)
    full, _ = lm.forward(cfg, params, torch.from_numpy(toks))
    _close(got, full[:, S0 - 1:].numpy(), SERVE_TOL, "vs forward")


@pytest.mark.parametrize("arch", MOE)
def test_greedy_tokens_match_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch, seed=3)
    prompt = np.random.default_rng(6).integers(1, cfg.vocab, (2, 12))
    want = np.asarray(jdecode.greedy_generate(jcfg, jparams,
                                              jnp.asarray(prompt), 6))
    for use_kernel in (True, False):
        got = decode.greedy_generate(cfg, params, torch.from_numpy(prompt),
                                     6, use_kernel=use_kernel)
        assert np.array_equal(got.numpy(), want)


def _at(nested, path):
    for k in path:
        nested = nested[k]
    return nested


OPT = dict(lr=3e-3, warmup_steps=5, decay_steps=10)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("fp8", [False, True])
def test_train_step_matches_reference(arch, fp8):
    """The loss, aux loss and every leaf's gradient (the MoE layers on the
    capacity-dropped dispatch, its aux loss folded in) against
    ``jax.grad`` of the reference's loss, within 1e-4; the port through
    the flash route, the reference through its plain path."""
    jcfg, jparams, cfg, params = _weights(arch, seed=4)
    jt = jstep.TrainConfig(opt=jopt.OptConfig(**OPT), fp8_expert_gather=fp8)
    tt = step.TrainConfig(opt=optimizer.OptConfig(**OPT),
                          fp8_expert_gather=fp8)
    batch = jbatch_for_step(jcfg, 32, 4, step=0, seed=3)
    j_loss = jstep.make_loss_fn(jcfg, jt)
    (jtot, (jl, ja)), jgrads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (tot, (loss, aux)), grads = step.value_and_grad(
        step.make_loss_fn(cfg, tt), params, to_device(batch, CPU))
    for g, w, name in ((tot, jtot, "total"), (loss, jl, "loss"),
                       (aux, ja, "aux")):
        np.testing.assert_allclose(float(g), float(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)
    assert float(ja) > 0
    for path, g in tree.flatten_with_path(grads):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(_at(jgrads, path), np.float32),
            rtol=GRAD_TOL, atol=GRAD_TOL, err_msg="/".join(map(str, path)))
    assert float(grads["blocks"]["router"].abs().max()) > 0
    t_step, t_init = step.make_train_step(cfg, tt)
    _, _, metrics = t_step(params, t_init(params), to_device(batch, CPU))
    np.testing.assert_allclose(float(metrics["aux_loss"]), float(ja),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
