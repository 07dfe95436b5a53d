"""The port's training path against the JAX package's, on the same
weights, batches and optimizer states (numpy from a seed).

* ``lr_schedule``, AdamW and Adafactor over three updates (1e-6);
* ``chunked_xent`` with ``S % loss_chunk != 0`` and PAD labels (1e-6),
  and its gradient;
* the train step at smoke width: loss, ``grad_norm`` and every leaf's
  gradient within 1e-4 (the North star's grads tolerance), the optimizer
  state after the step, and the post-step parameters.  Dense configs
  through the flash route (the reference's ``use_kernels=True,
  unroll_layers=True``: its Pallas forward in interpret mode and its
  recomputing ``custom_vjp``), every ported family through the plain
  path, and ``grad_accum=2``, bf16 and int8 gradient compression;
* the fp8 expert weights and the kernel routes with no backward.
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
from repro.train import losses as jlosses
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.convert import (opt_state_from_numpy,
                                        opt_state_to_numpy,
                                        params_from_numpy, params_to_numpy)
from repro_torch.train import losses, optimizer, step

CPU = torch.device("cpu")
GRAD_TOL = 1e-4
OPT_TOL = 1e-6
#: below this |gradient| AdamW's first step, g / (|g| + eps), can turn the
#: gradients' float32 disagreement (up to ~1e-5 absolute at smoke width)
#: into a different step of up to 2 lr; the post-step parameters are held
#: to GRAD_TOL elsewhere, and to 2 lr there
SIGN_FLOOR = 1e-6
DENSE = ["kratos-dd", "qwen1.5-0.5b", "tinyllama-1.1b", "gemma-2b",
         "gemma2-2b"]
#: leaves the reference initialises to zero, and the scale of the random
#: values that replace them (so a wrong norm offset or skip shows)
ZERO_LEAVES = {"ln1": 0.2, "out_ln": 0.2, "dt_bias": 0.5, "a_log": 0.5,
               "d_skip": 1.0, "fuse_ln_a": 0.2, "fuse_ln_s": 0.2,
               "ln2": 0.2, "ln_f": 0.2, "post_ln": 0.2, "post_ln2": 0.2}
OPT = dict(lr=3e-3, warmup_steps=5, decay_steps=10)


def _perturbed(jparams, seed: int):
    r = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                jnp.asarray(r.standard_normal(v.shape) * ZERO_LEAVES[k],
                            dtype=v.dtype) if k in ZERO_LEAVES else v
                for k, v in t.items()}

    return walk(jparams)


def _weights(arch: str, seed: int = 0):
    jcfg = jget_config(arch).smoke()
    jparams = _perturbed(jlm.init_params(jax.random.key(seed), jcfg),
                         seed + 100)
    return jcfg, jparams, get_config(arch).smoke(), params_from_numpy(
        jax.tree.map(np.asarray, jparams), CPU)


def _at(nested, path):
    for k in path:
        nested = nested[k]
    return nested


def _close_trees(got, want, tol: float, what: str):
    """Every leaf of the port's ``got`` within ``tol`` (rtol and atol) of
    the same leaf of the reference's ``want``."""
    for path, g in tree.flatten_with_path(got):
        np.testing.assert_allclose(
            g.detach().float().numpy(),
            np.asarray(_at(want, path), dtype=np.float32), rtol=tol,
            atol=tol, err_msg=f"{what} {'/'.join(map(str, path))}")


def test_lr_schedule_matches_reference():
    """Equal through the warmup and at the floor; on the cosine within 4
    float32 ulps: XLA's and torch's float32 cosines round apart by an ulp,
    and ``1 + cos`` near -1 magnifies it (up to 3 ulps of the rate over
    these three schedules)."""
    for decay in (10, 20, 30):
        _lr_schedule_case(dict(OPT, decay_steps=decay))


def _lr_schedule_case(kw: dict):
    jc = jopt.OptConfig(**kw)
    tc = optimizer.OptConfig(**kw)
    for s in range(31):
        want = np.float32(jopt.lr_schedule(jc, jnp.asarray(s, jnp.int32)))
        got = optimizer.lr_schedule(tc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        if s <= kw["warmup_steps"] or s >= kw["decay_steps"]:
            assert got.item() == want, s
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=4)


def _opt_tree(rng) -> dict:
    """Leaves of every kind the optimizers treat apart: stacked matrices,
    a vector, a matrix with a unit axis (Adafactor's unfactored case)."""
    return {"blocks": {"wq": rng.standard_normal((2, 6, 5)),
                       "ln1": rng.standard_normal((2, 6))},
            "embed": rng.standard_normal((7, 6)),
            "ln_f": rng.standard_normal((6,)),
            "col": rng.standard_normal((6, 1))}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(name):
    rng = np.random.default_rng(0)
    params_np = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    kw = dict(name=name, lr=1e-2, warmup_steps=2, decay_steps=10,
              clip_norm=2.0)
    j_init, j_upd = jopt.make_optimizer(jopt.OptConfig(**kw))
    t_init, t_upd = optimizer.make_optimizer(optimizer.OptConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params_np)
    js = j_init(jp)
    tp = params_from_numpy(params_np, CPU)
    ts = t_init(tp)
    assert all(a.dtype == np.float32 for k, a in
               tree.flatten_with_path(opt_state_to_numpy(ts)) if k != ("count",))
    for i in range(3):
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * (i + 1))
            .astype(np.float32), params_np)
        jp, js, jn = j_upd(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tn = t_upd(params_from_numpy(grads, CPU), ts, tp)
        np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_TOL)
        _close_trees(tp, jp, OPT_TOL, f"{name} update {i} params")
        _close_trees(ts, js, OPT_TOL, f"{name} update {i} state")
        assert int(ts["count"]) == int(js["count"]) == i + 1
        assert ts["count"].dtype == torch.int32


def test_optimizer_state_crosses_as_numpy():
    rng = np.random.default_rng(1)
    params_np = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    jp = jax.tree.map(jnp.asarray, params_np)
    for init in (jopt.adamw_init, jopt.adafactor_init):
        js = jax.tree.map(np.asarray, init(jp))
        ts = opt_state_from_numpy(js, CPU)
        back = opt_state_to_numpy(ts)
        for path, leaf in tree.flatten_with_path(back):
            np.testing.assert_array_equal(leaf, _at(js, path))
            assert leaf.dtype == _at(js, path).dtype
    with pytest.raises(ValueError):
        opt_state_from_numpy({"mu": {}}, CPU)


def test_chunked_xent_matches_reference():
    jcfg, jparams, cfg, params = _weights("qwen1.5-0.5b")
    jcfg = dataclasses.replace(jcfg, loss_chunk=16)
    cfg = dataclasses.replace(cfg, loss_chunk=16)
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 40))
    labels[:, ::3] = losses.PAD_ID
    want, jgrad = jax.value_and_grad(
        lambda h: jlosses.chunked_xent(jcfg, jparams, h,
                                       jnp.asarray(labels)))(
        jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_()
    got = losses.chunked_xent(cfg, params, h, torch.from_numpy(labels))
    (tgrad,) = torch.autograd.grad(got, h)
    np.testing.assert_allclose(float(got), float(want), rtol=OPT_TOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad),
                               rtol=OPT_TOL, atol=OPT_TOL)
    assert float(jnp.abs(jgrad[:, 32:]).max()) == 0.0  # the dropped tail
    assert float(tgrad[:, 32:].abs().max()) == 0.0


#: (arch, through the kernel route, TrainConfig fields)
STEP_CASES = [(a, True, {}) for a in DENSE[:3] + ["gemma2-2b"]] + \
    [(a, False, {}) for a in DENSE + ["mamba2-2.7b", "hymba-1.5b"]] + \
    [("qwen1.5-0.5b", True, {"grad_accum": 2}),
     ("tinyllama-1.1b", False, {"grad_compress": "bf16"}),
     ("hymba-1.5b", False, {"grad_compress": "int8"})]


@pytest.mark.parametrize(
    "arch,kernel,extra", STEP_CASES,
    ids=[f"{a}-{'kernel' if k else 'plain'}"
         f"{''.join(f'-{v}' for v in e.values())}" for a, k, e in STEP_CASES])
def test_train_step_matches_reference(arch, kernel, extra):
    jcfg, jparams, cfg, params = _weights(arch)
    if kernel:
        jcfg = dataclasses.replace(jcfg, use_kernels=True,
                                   unroll_layers=True)
    jt = jstep.TrainConfig(opt=jopt.OptConfig(**OPT), **extra)
    tt = step.TrainConfig(opt=optimizer.OptConfig(**OPT), **extra)
    batch = jbatch_for_step(jcfg, 32, 4, step=0, seed=3)
    j_step, j_init = jstep.make_train_step(jcfg, jt)
    j_loss = jstep.make_loss_fn(jcfg, jt)

    def ref(p, o, b):
        _, g = jax.value_and_grad(j_loss, has_aux=True)(p, b)
        return g, *j_step(p, o, b)

    jgrads, jnew, jstate, jmetrics = jax.jit(ref)(
        jparams, j_init(jparams), {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    t_step, t_init = step.make_train_step(cfg, tt, use_kernel=kernel)
    tbatch = to_device(batch, CPU)
    before = params_to_numpy(params)
    new, state, metrics = t_step(params, t_init(params), tbatch)
    for k in ("loss", "aux_loss", "grad_norm"):
        assert metrics[k].dim() == 0
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    # the caller's tensors are left as they were
    for path, leaf in tree.flatten_with_path(params):
        np.testing.assert_array_equal(leaf.numpy(), _at(before, path))
        assert not leaf.requires_grad
    if extra.get("grad_accum", 1) == 1 and "grad_compress" not in extra:
        _, grads = step.value_and_grad(step.make_loss_fn(cfg, tt, kernel),
                                        params, tbatch)
        _close_trees(grads, jgrads, GRAD_TOL, "gradient")
    # mu after one step is (1 - b1) x the clipped (accumulated,
    # compressed) gradient
    _close_trees(state, jstate, GRAD_TOL, "optimizer state")
    # where 0 < |g| < SIGN_FLOOR the step may differ by up to the most a
    # step can move a weight, 2 lr (the decay's share is the same)
    lr = float(optimizer.lr_schedule(tt.opt, 1))
    for path, p in tree.flatten_with_path(new):
        g = np.abs(np.asarray(_at(jgrads, path), dtype=np.float32))
        keep = (g >= SIGN_FLOOR) | (g == 0)
        got = p.float().numpy()
        want = np.asarray(_at(jnew, path), dtype=np.float32)
        where = f"post-step {'/'.join(map(str, path))}"
        np.testing.assert_allclose(got[keep], want[keep], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=where)
        assert np.all(np.abs(got - want)[~keep] <= 2 * lr + GRAD_TOL), where


def test_fp8_expert_params_match_reference():
    rng = np.random.default_rng(4)
    blocks = {"we_i": rng.standard_normal((2, 8, 6)).astype(np.float32),
              "we_o": rng.standard_normal((2, 6, 8)).astype(np.float32),
              "wq": rng.standard_normal((2, 8, 8)).astype(np.float32)}
    want = jstep._fp8_expert_params(
        {"blocks": jax.tree.map(jnp.asarray, blocks)})
    got = step._fp8_expert_params(
        {"blocks": params_from_numpy(blocks, CPU)})
    assert set(got["blocks"]) == set(want["blocks"])
    for k, w in want["blocks"].items():
        g = got["blocks"][k]
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))
    plain = {"blocks": {"wq": torch.zeros(2)}}
    assert step._fp8_expert_params(plain) is plain


def test_kernel_routes_refuse_gradients(monkeypatch):
    """On the kernel route (forced here on CPU tensors) an op with no
    backward raises when a gradient is wanted, before any launch;
    without one it gets past the guard."""
    monkeypatch.setattr(ops, "_wants_kernel", lambda t, use_kernel: True)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 8, 2, 4))
                         .astype(np.float32)).requires_grad_()
    dt = torch.ones((1, 8, 2))
    A, B, C = -torch.ones(2), torch.ones((1, 8, 3)), torch.ones((1, 8, 3))
    with pytest.raises(NotImplementedError, match="no VJP.*use_kernel=False"):
        ops.ssd_scan(x, dt, A, B, C)
    w = torch.ones((4, 3)).requires_grad_()
    with pytest.raises(NotImplementedError, match="bitplane_matmul"):
        ops.bitplane_matmul(w, torch.ones((2, 3, 5)), torch.ones(5))
    ops._refuse_grad("ssd_scan", x.detach(), dt)
    with torch.no_grad():
        ops._refuse_grad("ssd_scan", x, dt)
    # an ssm train step that asks for the kernel route raises
    cfg = get_config("mamba2-2.7b").smoke()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    t_step, t_init = step.make_train_step(cfg, step.TrainConfig())
    batch = to_device(jbatch_for_step(cfg, 16, 2, step=0), CPU)
    with pytest.raises(NotImplementedError, match="ssd_scan"):
        t_step(params, t_init(params), batch)


def test_flash_route_under_autograd_on_cpu():
    """With a gradient wanted, the flash route is ``FlashAttentionFn``
    (its plain forward on a CPU tensor); without one, the plain version
    with no graph; ``use_kernel=False`` differentiates the plain version
    as it stands."""
    q = torch.randn(1, 2, 5, 16, requires_grad=True)
    k = torch.randn(1, 1, 5, 16, requires_grad=True)
    v = torch.randn(1, 1, 5, 16, requires_grad=True)
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    plain = ops.flash_attention(q, k, v, use_kernel=False)
    assert type(plain.grad_fn).__name__ != "FlashAttentionFnBackward"
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.launch_counts()["flash_attention"] == 0  # no card here
