"""The port's encoder-decoder (whisper-small) and vision-language
(llava-next-34b) families against the JAX package, with the same weights
(the reference's ``init_params``, its zero-initialised norm leaves
perturbed) and the same frames, patches and prompts (numpy from a seed):

* ``forward`` with frames / patch embeddings (1e-5), both attention
  routes;
* prefill and decode logits and caches (the encoder's cross-attention
  keys and values too) against the reference's plain serving path
  (1e-5), the teacher-forced forward (5e-3) and its greedy tokens;
* the train step's loss and gradients against ``jax.grad`` (1e-4);
* the serving encoder's type: the reference does not cast the frames in
  ``_encode_to_cache``, so float32 frames on bfloat16 weights run its
  encoder in float32 (jnp promotes); the port's must too;
* the new parameter trees crossing both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.data.pipeline import batch_for_step as jbatch_for_step
from repro.models import lm as jlm
from repro.serve import decode as jdecode
from repro.serve import kvcache as jkvcache
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serve import decode, kvcache
from repro_torch.train import optimizer, step

CPU = torch.device("cpu")
ARCHS = ["whisper-small", "llava-next-34b"]
TOL = 1e-5
SERVE_TOL = 5e-3
GRAD_TOL = 1e-4
NORM_LEAVES = ("ln1", "ln2", "ln_f", "x_ln", "enc_ln_f")


def _perturbed(jparams, seed: int):
    r = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                jnp.asarray(r.standard_normal(v.shape) * 0.2, dtype=v.dtype)
                if k in NORM_LEAVES else v for k, v in t.items()}

    return walk(jparams)


def _weights(arch: str, seed: int = 0, **overrides):
    jcfg = dataclasses.replace(jget_config(arch).smoke(), **overrides)
    jparams = _perturbed(jlm.init_params(jax.random.key(seed), jcfg),
                         seed + 100)
    cfg = dataclasses.replace(get_config(arch).smoke(), **overrides)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), CPU)


def _inputs(cfg, B: int, S: int, seed: int):
    """Prompts and the frames / patches, as the launcher draws them."""
    toks, extra = serve.make_inputs(cfg, B, S, CPU, seed=seed)
    return toks, extra, {k: jnp.asarray(v.numpy()) for k, v in extra.items()}


def _close(got, want, tol: float, what: str = ""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _at(nested, path):
    for k in path:
        nested = nested[k]
    return nested


def test_inputs_follow_the_reference_launcher():
    """Prompts first, then frames or patches, from one generator."""
    for arch, key, n in (("whisper-small", "encoder_feats", "encoder_seq"),
                         ("llava-next-34b", "patch_embeds", "n_patches")):
        cfg = get_config(arch).smoke()
        toks, extra = serve.make_inputs(cfg, 2, 5, CPU, seed=7)
        rng = np.random.default_rng(7)
        assert np.array_equal(toks.numpy(), rng.integers(1, cfg.vocab, (2, 5)))
        want = rng.standard_normal((2, getattr(cfg, n), cfg.d_model)
                                   ).astype(np.float32) * 0.02
        assert list(extra) == [key]
        assert extra[key].dtype == torch.float32
        assert np.array_equal(extra[key].numpy(), want)
    assert serve.make_inputs(get_config("kratos-dd").smoke(), 1, 3,
                             CPU)[1] == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch)
    toks, extra, jextra = _inputs(cfg, 2, 12, seed=1)
    want, waux = jlm.forward(jcfg, jparams, jnp.asarray(toks.numpy()),
                             **jextra)
    P = cfg.n_patches if cfg.family == "vlm" else 0
    assert want.shape == (2, P + 12, cfg.vocab)
    for use_kernel in (True, False):
        got, aux = lm.forward(cfg, params, toks, use_kernel=use_kernel,
                              **extra)
        _close(got, want, TOL, "logits")
        assert float(aux) == float(waux) == 0.0


def _jax_serve(jcfg, jparams, toks, jextra, S0: int, T: int):
    B = toks.shape[0]
    enc = jextra.get("encoder_feats")
    cache = jkvcache.init_cache(jcfg, B, T, encoder_len=(
        enc.shape[1] if enc is not None else None))
    logits, cache = jdecode.prefill(jcfg, jparams, cache,
                                    jnp.asarray(toks[:, :S0]), **jextra)
    P = jextra["patch_embeds"].shape[1] if "patch_embeds" in jextra else 0
    out = [np.asarray(logits)]
    for pos in range(S0, toks.shape[1]):
        logits, cache = jdecode.decode_step(
            jcfg, jparams, cache, jnp.asarray(toks[:, pos:pos + 1]), P + pos)
        out.append(np.asarray(logits))
    return np.concatenate(out, axis=1), cache


def _port_serve(cfg, params, toks, extra, S0: int, T: int,
                use_kernel: bool):
    enc = extra.get("encoder_feats")
    cache = kvcache.init_cache(cfg, toks.shape[0], T, encoder_len=(
        enc.shape[1] if enc is not None else None), device=CPU)
    logits, cache = decode.prefill(cfg, params, cache, toks[:, :S0],
                                   use_kernel=use_kernel, **extra)
    P = extra["patch_embeds"].shape[1] if "patch_embeds" in extra else 0
    out = [logits]
    for pos in range(S0, toks.shape[1]):
        logits, cache = decode.decode_step(cfg, params, cache,
                                           toks[:, pos:pos + 1], P + pos,
                                           use_kernel=use_kernel)
        out.append(logits)
    return torch.cat(out, dim=1), cache


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_serve_matches_reference(arch, use_kernel):
    jcfg, jparams, cfg, params = _weights(arch, seed=2)
    S0, n_dec = 7, 4
    toks, extra, jextra = _inputs(cfg, 2, S0 + n_dec, seed=3)
    P = cfg.n_patches if cfg.family == "vlm" else 0
    T = P + S0 + n_dec + 2
    want, jcache = _jax_serve(jcfg, jparams, toks.numpy(), jextra, S0, T)
    got, cache = _port_serve(cfg, params, toks, extra, S0, T, use_kernel)
    _close(got, want, TOL, "logits")
    assert set(cache) == set(jcache)
    if cfg.family == "encdec":
        assert set(cache) == {"k", "v", "xk", "xv"}
        assert cache["xk"].shape[2] == cfg.encoder_seq
    for name in cache:
        _close(cache[name], jcache[name], TOL, name)
    full, _ = lm.forward(cfg, params, toks, **extra)
    _close(got, full[:, P + S0 - 1:].numpy(), SERVE_TOL, "vs forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch, seed=4)
    toks, extra, jextra = _inputs(cfg, 2, 9, seed=5)
    want = np.asarray(jdecode.greedy_generate(
        jcfg, jparams, jnp.asarray(toks.numpy()), 6, **jextra))
    for use_kernel in (True, False):
        got = decode.greedy_generate(cfg, params, toks, 6,
                                     use_kernel=use_kernel, **extra)
        assert np.array_equal(got.numpy(), want)
        res = serve.generate(cfg, params, toks, 6, use_kernel=use_kernel,
                             **extra)
        assert np.array_equal(res["tokens"].numpy(), want)


OPT = dict(lr=3e-3, warmup_steps=5, decay_steps=10)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """Loss and every leaf's gradient against ``jax.grad`` of the
    reference's loss (frames or patches from the batch; the vlm labels
    padded over the patches), the port through the flash route."""
    jcfg, jparams, cfg, params = _weights(arch, seed=6)
    jt = jstep.TrainConfig(opt=jopt.OptConfig(**OPT))
    tt = step.TrainConfig(opt=optimizer.OptConfig(**OPT))
    batch = jbatch_for_step(jcfg, 16, 2, step=0, seed=3)
    assert {"encoder_feats", "patch_embeds"} & set(batch)
    (jtot, (jl, _)), jgrads = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jcfg, jt), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (tot, (loss, aux)), grads = step.value_and_grad(
        step.make_loss_fn(cfg, tt), params, to_device(batch, CPU))
    np.testing.assert_allclose(float(tot), float(jtot), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(float(loss), float(jl), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    for path, g in tree.flatten_with_path(grads):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(_at(jgrads, path), np.float32),
            rtol=GRAD_TOL, atol=GRAD_TOL, err_msg="/".join(map(str, path)))
    moved = "enc_blocks" if cfg.family == "encdec" else "patch_proj"
    assert max(float(g.abs().max()) for g in tree.leaves(grads[moved])) > 0
    t_step, t_init = step.make_train_step(cfg, tt)
    new, _, metrics = t_step(params, t_init(params), to_device(batch, CPU))
    np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_serving_encoder_runs_in_the_frames_type():
    """bfloat16 weights, float32 frames: the reference's prefill runs its
    encoder in float32 (no cast in ``_encode_to_cache``; jnp promotes)
    while its ``forward`` casts the frames to bfloat16.  The port's
    serving encoder must run in float32 too (every encoder attention call
    on float32 tensors) and give the reference's cross-attention cache:
    within one bfloat16 rounding of it, where an encoder run in bfloat16
    is not."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, jparams, cfg, _ = _weights("whisper-small", seed=8, **bf16)
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    toks, extra, jextra = _inputs(cfg, 2, 5, seed=9)
    assert extra["encoder_feats"].dtype == torch.float32
    T = 8
    jcache = jkvcache.init_cache(jcfg, 2, T)
    _, jcache = jdecode.prefill(jcfg, jparams, jcache,
                                jnp.asarray(toks.numpy()), **jextra)
    seen = []
    flash = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.dtype, k.shape[2]))
        return flash(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        cache = kvcache.init_cache(cfg, 2, T, device=CPU)
        decode.prefill(cfg, params, cache, toks, **extra)
    finally:
        ops.flash_attention = flash
    enc_calls = [dt for dt, keys in seen if keys == cfg.encoder_seq]
    assert enc_calls == [torch.float32] * cfg.n_encoder_layers
    assert cache["xk"].dtype == torch.bfloat16
    ulp = 2.0 ** -7
    for name in ("xk", "xv"):
        want = np.asarray(jcache[name].astype(jnp.float32))
        np.testing.assert_allclose(cache[name].float().numpy(), want,
                                   rtol=ulp, atol=1e-6, err_msg=name)
    low = kvcache.init_cache(cfg, 2, T, device=CPU)
    decode.prefill(cfg, params, low, toks, encoder_feats=extra[
        "encoder_feats"].to(torch.bfloat16))
    d_low = float((low["xk"].float() - cache["xk"].float()).abs().max())
    scale = float(cache["xk"].float().abs().max())
    assert d_low > ulp * scale, (d_low, scale)


@pytest.mark.parametrize("arch", ARCHS + ["deepseek-moe-16b"])
def test_params_cross_both_ways(arch):
    """The new trees (``enc_blocks``, ``enc_ln_f``, the ``x_*`` leaves,
    ``patch_proj``, ``dense_blocks``) cross to the port and back
    unchanged, and the port's own init has the reference's layout."""
    jcfg = jget_config(arch).smoke()
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    back = params_to_numpy(params_from_numpy(
        jax.tree.map(np.asarray, jparams), CPU))
    flat = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat) == len(tree.leaves(back))
    for path, leaf in flat:
        assert np.array_equal(_at(back, [p.key for p in path]),
                              np.asarray(leaf))
    mine = params_to_numpy(lm.init_params(torch.Generator().manual_seed(0),
                                          get_config(arch).smoke()))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), mine) == \
        jax.tree.map(lambda a: (a.shape, str(a.dtype)), jparams)
    names = set(mine) | set(mine["blocks"])
    assert names >= {"encdec": {"enc_blocks", "enc_ln_f", "x_wq", "x_wk",
                                "x_wv", "x_wo", "x_ln"},
                     "vlm": {"patch_proj"},
                     "moe": {"dense_blocks", "router", "we_i", "we_o",
                             "ws_i", "ws_o"}}[jcfg.family]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "whisper-small",
                                  "llava-next-34b"])
def test_train_launcher_takes_the_flash_route(arch, tmp_path, monkeypatch):
    """``launch.train`` trains the moe, encdec and vlm families through
    the flash route under autograd (``FlashAttentionFn``), as the dense
    family trains, with their frames or patches from the data stream."""
    from repro_torch.launch import train

    calls = []
    apply = ops.FlashAttentionFn.apply
    monkeypatch.setattr(ops.FlashAttentionFn, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    res = train.main(["--arch", arch, "--smoke", "--steps", "2",
                      "--seq-len", "16", "--batch", "2", "--ckpt-dir",
                      str(tmp_path), "--device", "cpu"])
    assert res["final_step"] == 2
    assert all(np.isfinite(res["losses"]))
    assert len(calls) > 0
