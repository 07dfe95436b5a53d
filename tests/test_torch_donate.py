"""The donated train step: the optimizers' ``in_place`` form,
``make_train_step(..., donate=True)``, ``fit`` and the trace's train
cells, against the JAX package's optimizers and the port's own pure step
(numpy inputs from a seed).

Held: the in-place AdamW and Adafactor within 1e-6 of the reference's
over three updates (float32 and bf16 weights; factored and unfactored
leaves), every returned leaf in its input's storage; the pure update
(the same arithmetic on copies) and the in-place one bitwise equal to
the pure update as it was before; the pure step
(``donate=False``) bitwise equal to the step as it was before the
donating form existed, its inputs bitwise unchanged; the donating step
bitwise equal to the pure one (with ``grad_accum=2`` also within 1e-4),
updating in place; ``fit``'s losses and weights bitwise the pure step's,
the caller's weights untouched; on a 2-rank gloo mesh the donated sharded
step within 1e-4 of the unsharded donated step, its placements and local
storages kept; a train cell's trace reporting the donated weights and
state as aliased, and its update's temporaries (on a mesh of one, its
step's) at least their new state's bytes below the pure step's.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import SRC, run_ranks
from repro.train import optimizer as jopt
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import batch_for_step, to_device
from repro_torch.launch.serve import make_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer, step
from repro_torch.train.loop import FitConfig, fit

CPU = torch.device("cpu")
GRAD_TOL = 1e-4
OPT_TOL = 1e-6
OPT = dict(lr=3e-3, warmup_steps=2, decay_steps=10)
NAMES = ["adamw", "adafactor"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _opt_tree(rng) -> dict:
    """Factored leaves (a stack of matrices, a matrix) and unfactored
    ones (a vector, a matrix with a unit axis) for Adafactor; AdamW
    treats them alike."""
    return {"blocks": {"wq": rng.standard_normal((2, 6, 5)),
                       "ln1": rng.standard_normal((2, 6))},
            "embed": rng.standard_normal((7, 6)),
            "ln_f": rng.standard_normal((6,)),
            "col": rng.standard_normal((6, 1))}


def _ptrs(t) -> list:
    return [x.data_ptr() for x in tree.leaves(t)]


def _clone(t):
    return tree.map(torch.clone, t)


def _assert_equal(a, b, what: str):
    for (path, x), y in zip(tree.flatten_with_path(a), tree.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), \
            f"{what} {'/'.join(map(str, path))}"


def _at(nested, path):
    for k in path:
        nested = nested[k]
    return nested


def _close(got, want, tol: float, what: str):
    for path, g in tree.flatten_with_path(got):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(_at(want, path), dtype=np.float32),
            rtol=tol, atol=tol, err_msg=f"{what} {'/'.join(map(str, path))}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_in_place_update_matches_reference(name, dtype):
    """Three in-place updates against ``repro.train.optimizer``'s: params
    and state within 1e-6, the norm too; each update returns the tensors
    it was given (storage unchanged), the step count in place."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    params_np = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    kw = dict(name=name, lr=1e-2, warmup_steps=2, decay_steps=10,
              clip_norm=2.0)
    j_init, j_upd = jopt.make_optimizer(jopt.OptConfig(**kw))
    t_init, t_upd = optimizer.make_optimizer(optimizer.OptConfig(**kw),
                                             in_place=True)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params_np)
    js = j_init(jp)
    tp = params_from_numpy(params_np, CPU, dtype=tdt)
    ts = t_init(tp)
    ptrs = _ptrs((tp, ts))
    for i in range(3):
        grads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * (i + 1))
            .astype(np.float32), params_np)
        jp, js, jn = j_upd(jax.tree.map(lambda a: jnp.asarray(a, jdt),
                                        grads), js, jp)
        got_p, got_s, tn = t_upd(params_from_numpy(grads, CPU, dtype=tdt),
                                 ts, tp)
        assert got_p is tp and got_s is ts
        assert _ptrs((got_p, got_s)) == ptrs
        assert all(p.dtype == tdt for p in tree.leaves(tp))
        np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_TOL)
        _close(tp, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
               OPT_TOL, f"{name} {dtype} update {i} params")
        _close(ts, jax.tree.map(np.asarray, js), OPT_TOL,
               f"{name} {dtype} update {i} state")
        assert int(ts["count"]) == i + 1 and ts["count"].dtype == torch.int32


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", NAMES)
def test_in_place_update_equals_pure_bitwise(name, dtype):
    """The in-place update gives the pure update's bits, and both give
    the bits of the pure update as it was before it ran the in-place
    arithmetic on copies (the same ops in the same order); the pure one
    leaves its inputs as they were."""
    tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(1)
    params_np = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    cfg = optimizer.OptConfig(name=name, **OPT)
    init, pure = optimizer.make_optimizer(cfg)
    _, donated = optimizer.make_optimizer(cfg, in_place=True)
    p0 = params_from_numpy(params_np, CPU, dtype=tdt)
    pp, ps = p0, init(p0)
    dp, ds = _clone(p0), init(p0)
    tp, ts = p0, init(p0)
    for i in range(3):
        grads = params_from_numpy(jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            params_np), CPU, dtype=tdt)
        inputs = (grads, pp, ps)
        before = _clone(inputs)
        pp, ps, pn = pure(grads, ps, pp)
        _assert_equal(inputs, before, "the pure update's inputs")
        tp, ts, tn = TODAYS[name](cfg, grads, ts, tp)
        dp, ds, dn = donated(_clone(grads), ds, dp)
        assert torch.equal(pn, dn) and torch.equal(pn, tn)
        for what, (gp, gs) in (("pure", (pp, ps)), ("in place", (dp, ds))):
            _assert_equal(gp, tp, f"{name} {dtype} {what} update {i} params")
            _assert_equal(gs, ts, f"{name} {dtype} {what} update {i} state")


def _todays_clip(cfg, grads):
    """The gradients clipped as the port's pure update clipped them
    before it ran the in-place arithmetic on copies."""
    norm = optimizer.global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.map(lambda g: g.float() * scale, grads), norm


def _todays_adamw(cfg, grads, state, params):
    """AdamW's update as the port's pure form computed it before it ran
    the in-place arithmetic on copies."""
    grads, gnorm = _todays_clip(cfg, grads)
    count = state["count"] + 1
    lr = optimizer.lr_schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    mu = tree.map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
    nu = tree.map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"],
                  grads)
    c = count.to(torch.float32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c

    def upd(p, m, v):
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        step_ = step_ + cfg.weight_decay * p.float()
        return (p.float() - lr * step_).to(p.dtype)

    return (tree.map(upd, params, mu, nu),
            {"mu": mu, "nu": nu, "count": count}, gnorm)


def _todays_adafactor(cfg, grads, state, params):
    """Adafactor's update as the port's pure form computed it before it
    ran the in-place arithmetic on copies."""
    grads, gnorm = _todays_clip(cfg, grads)
    count = state["count"] + 1
    lr = optimizer.lr_schedule(cfg, count)
    decay = 1.0 - (count.to(torch.float32) + 1.0) ** -0.8

    def upd(p, g, v):
        g2 = g * g + 1e-30
        if optimizer._factored(p.shape):
            vr = decay * v["vr"] + (1 - decay) * g2.mean(dim=-1)
            vc = decay * v["vc"] + (1 - decay) * g2.mean(dim=-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                   min=1e-30))
            step_ = g / (torch.sqrt(denom) + cfg.eps)
            nv = {"vr": vr, "vc": vc}
        else:
            nv = {"v": decay * v["v"] + (1 - decay) * g2}
            step_ = g / (torch.sqrt(nv["v"]) + cfg.eps)
        step_ = step_ + cfg.weight_decay * p.float()
        return (p.float() - lr * step_).to(p.dtype), nv

    flat = tree.flatten_with_path(params)
    outs = [upd(p, _at(grads, path), _at(state["v"], path))
            for path, p in flat]
    return (tree.unflatten(params, [o[0] for o in outs]),
            {"v": tree.unflatten(params, [o[1] for o in outs]),
             "count": count}, gnorm)


TODAYS = {"adamw": _todays_adamw, "adafactor": _todays_adafactor}


def _todays_step(cfg, tcfg, params, opt_state, batch):
    """The train step as it was before it could donate (one microbatch,
    no compression, the plain route)."""
    (_, (loss, _)), grads = step.value_and_grad(
        step.make_loss_fn(cfg, tcfg, False), params, batch)
    new, state, gnorm = TODAYS[tcfg.opt.name](tcfg.opt, grads, opt_state,
                                              params)
    return new, state, loss, gnorm


def _smoke(arch: str = "qwen1.5-0.5b", dtype: str = "float32"):
    """A smoke config in ``dtype`` and its seed-0 weights."""
    cfg = dataclasses.replace(get_config(arch).smoke(), param_dtype=dtype,
                              compute_dtype=dtype)
    return cfg, make_params(cfg, CPU, seed=0)


def _batch(cfg, s: int, seq: int = 32, rows: int = 4):
    return to_device(batch_for_step(cfg, seq, rows, s, seed=3), CPU)


@pytest.mark.parametrize("name", NAMES)
def test_pure_step_is_todays_and_leaves_its_inputs(name):
    """``donate=False``: the step's new params, state, loss and norm are
    today's bit for bit over two steps, and its inputs stay as they
    were."""
    cfg, params = _smoke()
    tcfg = step.TrainConfig(opt=optimizer.OptConfig(name=name, **OPT))
    pure, init = step.make_train_step(cfg, tcfg, use_kernel=False)
    p, o = params, init(params)
    for s in range(2):
        batch = _batch(cfg, s)
        before = _clone((p, o))
        want_p, want_o, want_loss, want_norm = _todays_step(cfg, tcfg, p, o,
                                                            batch)
        new_p, new_o, m = pure(p, o, batch)
        _assert_equal((p, o), before, "input")
        assert torch.equal(m["loss"], want_loss)
        assert torch.equal(m["grad_norm"], want_norm)
        _assert_equal(new_p, want_p, f"{name} step {s} params")
        _assert_equal(new_o, want_o, f"{name} step {s} state")
        p, o = new_p, new_o


CASES = [(name, dt, 1) for name in NAMES for dt in DTYPES] + \
    [("adamw", "float32", 2), ("adamw", "bfloat16", 2)]


@pytest.mark.parametrize("name,dtype,accum", CASES,
                         ids=[f"{n}-{d}-accum{a}" for n, d, a in CASES])
def test_donated_step_equals_pure_step(name, dtype, accum):
    """Three donated steps against three pure ones from the same weights:
    the same losses and norms, every parameter and state leaf within
    ``GRAD_TOL`` and in fact bitwise; the donated step returns the trees
    it was given, each leaf in its own storage."""
    cfg, params = _smoke(dtype=dtype)
    tcfg = step.TrainConfig(opt=optimizer.OptConfig(name=name, **OPT),
                            grad_accum=accum)
    pure, init = step.make_train_step(cfg, tcfg, use_kernel=False)
    donated, _ = step.make_train_step(cfg, tcfg, use_kernel=False,
                                      donate=True)
    pp, po = params, init(params)
    dp, do = _clone(params), init(params)
    ptrs = _ptrs((dp, do))
    for s in range(3):
        batch = _batch(cfg, s)
        pp, po, pm = pure(pp, po, batch)
        got_p, got_o, dm = donated(dp, do, batch)
        assert got_p is dp and got_o is do and _ptrs((dp, do)) == ptrs
        for k in ("loss", "aux_loss", "grad_norm"):
            assert torch.equal(pm[k], dm[k]), k
        for a, b in zip(tree.leaves((dp, do)), tree.leaves((pp, po))):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL)
        _assert_equal((dp, do), (pp, po), f"step {s}")


def test_fit_donates_its_own_copy(tmp_path):
    """``fit`` (donating) gives the pure step's losses and final weights
    and state bit for bit, step by step over the same batches, and steps
    the very tensors it was given, as the reference's donation consumes
    its caller's arrays: a caller that keeps its weights hands it a
    copy."""
    cfg, params = _smoke()
    given = _clone(params)
    fitc = FitConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                     seq_len=32, global_batch=2)
    res = fit(cfg, given, fitc)
    pure, init = step.make_train_step(cfg, step.TrainConfig())
    p, o, losses = params, init(params), []
    for s in range(fitc.steps):
        batch = to_device(batch_for_step(cfg, fitc.seq_len, fitc.global_batch,
                                         s, seed=fitc.seed), CPU)
        p, o, m = pure(p, o, batch)
        losses.append(float(m["loss"]))
    assert res["losses"] == losses
    _assert_equal((res["params"], res["opt_state"]), (p, o), "fit state")
    assert all(a is b for a, b in
               zip(tree.leaves(res["params"]), tree.leaves(given)))


MESH_SCRIPT = r"""
import json
import torch
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import batch_for_step, to_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import make_params
from repro_torch.parallel import sharding
from repro_torch.parallel.api import sharding_rules
from repro_torch.train import optimizer, step

CPU = torch.device("cpu")
cfg = get_config("qwen1.5-0.5b").smoke()
whole = make_params(cfg, CPU, seed=0)
out = {}
for mp in (1, 2):
    mesh = make_host_mesh(mp, CPU)
    for name in ("adamw", "adafactor"):
        tcfg = step.TrainConfig(opt=optimizer.OptConfig(
            name=name, **json.loads(ARGS[0])))
        fn, init = step.make_train_step(cfg, tcfg, use_kernel=False,
                                        donate=True)
        params = sharding.distribute(tree.map(torch.clone, whole),
                                     sharding.param_specs(cfg, mesh, whole),
                                     mesh)
        opt = init(params)
        leaves = tree.leaves((params, opt))
        places = [str(getattr(t, "placements", None)) for t in leaves]
        ptrs = [(t.to_local() if hasattr(t, "to_local") else t).data_ptr()
                for t in leaves]
        ref = tree.map(torch.clone, whole)
        ref_opt = init(ref)
        losses, ref_losses = [], []
        with sharding_rules(sharding.activation_rules(cfg, mesh)):
            for s in range(2):
                host = batch_for_step(cfg, 32, 4, s, seed=3)
                params, opt, m = fn(params, opt, to_device(host, CPU, mesh))
                losses.append(float(m["loss"]))
        for s in range(2):
            host = batch_for_step(cfg, 32, 4, s, seed=3)
            ref, ref_opt, m = fn(ref, ref_opt, to_device(host, CPU))
            ref_losses.append(float(m["loss"]))
        got = tree.leaves((params, opt))
        err = max(float((g.full_tensor() if hasattr(g, "full_tensor") else g)
                        .float().sub(w.float()).abs().max())
                  for g, w in zip(got, tree.leaves((ref, ref_opt))))
        out[f"{mp}-{name}"] = {
            "losses": losses, "ref_losses": ref_losses, "max_err": err,
            "placements_kept": places == [
                str(getattr(t, "placements", None)) for t in got],
            "storage_kept": ptrs == [
                (t.to_local() if hasattr(t, "to_local") else t).data_ptr()
                for t in got],
            "distributed": sum(hasattr(t, "to_local") for t in got),
            "leaves": len(got)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return run_ranks(MESH_SCRIPT, 2, tmp_path_factory.mktemp("donate_mesh"),
                     json.dumps(OPT), timeout=240)


@pytest.mark.slow   # subprocesses: 2 ranks
@pytest.mark.parametrize("mp", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_donated_mesh_step_equals_unsharded(mesh_runs, mp, name):
    """On a 2-rank gloo mesh (``(2, 1)`` and ``(1, 2)``) two donated
    sharded steps match two donated unsharded steps from the same weights
    and batches: the losses and every parameter and state leaf within
    ``GRAD_TOL``; every leaf keeps its placements and its local storage;
    on each rank alike."""
    for rec in mesh_runs:
        r = rec[f"{mp}-{name}"]
        np.testing.assert_allclose(r["losses"], r["ref_losses"],
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
        assert r["max_err"] <= GRAD_TOL, r["max_err"]
        assert r["placements_kept"] and r["storage_kept"]
        assert r["distributed"] == r["leaves"] - 1   # all but the count


TRACE_SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs.base import get_config
from repro_torch.launch import trace
from repro_torch.launch.dryrun import _arg_specs, _cell_args
from repro_torch.parallel.sharding import allocate
from repro_torch.train import step

real_step, real_opt = step.make_train_step, step.make_optimizer
counters, update_temps = [], []
real_counter = trace.Counter.__init__


def counter(self, *args, **kwargs):
    real_counter(self, *args, **kwargs)
    counters.append(self)


def pure(*args, **kwargs):
    return real_step(*args, **{**kwargs, "donate": False})


def make_optimizer(*args, **kwargs):
    # the update's own temporaries: the peak of the storages it allocates
    # above those alive when it starts
    init, update = real_opt(*args, **kwargs)

    def measured(*a):
        c = counters[-1]
        live, peak = c.live, c.peak
        c.peak = live
        out = update(*a)
        update_temps.append(c.peak - live)
        c.peak = max(peak, c.peak)
        return out

    return init, measured


trace.Counter.__init__ = counter
step.make_optimizer = make_optimizer
trace.form_fake_group(4)
cfg = dataclasses.replace(get_config(sys.argv[1]).smoke(),
                          **json.loads(sys.argv[3]))
shape = trace.shape_of(json.loads(sys.argv[2]))
out = {}
for sizes in ([1, 1], [2, 2]):
    mesh = trace.fake_mesh(sizes, ["data", "model"])
    args = _cell_args(cfg, shape)
    specs = _arg_specs(cfg, mesh, args)
    local = {role: [t.numel() * t.element_size() for t in trace._local_leaves(
        allocate(args[role], specs[role], mesh, "meta", fill=None))]
        for role in ("weights", "optimizer")}
    rec = {}
    for form, make in (("donated", real_step), ("pure", pure)):
        step.make_train_step = make
        rec[form] = trace.trace_cell(cfg, shape, mesh)["memory"]
        rec[form + "_update"] = update_temps.pop()
    out["x".join(map(str, sizes))] = {
        **rec, "weights": sum(local["weights"]),
        "optimizer": sum(local["optimizer"]), "count": 4}
print(json.dumps(out))
"""


@pytest.mark.slow   # a subprocess: a fake group
def test_trace_counts_the_donated_state_as_aliased():
    """A train cell, at smoke depth and a width at which the pure
    update sets the pure step's peak on both meshes, on meshes of 1 and
    ``(2, 2)``: the donated step's aliased bytes are its weights' and
    optimizer state's local bytes, the pure step's none; the update's own
    temporaries, and on the mesh of one the step's, at least the new
    state's bytes (weights and moments) below the pure step's; on
    ``(2, 2)`` the step's below them too (the backward, which all-gathers
    the sharded weights, then sets the donated step's peak)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", TRACE_SCRIPT, "qwen1.5-0.5b",
         json.dumps(["train", 2, 16]),
         json.dumps({"d_model": 256, "head_dim": 64})],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = json.loads(proc.stdout.strip().splitlines()[-1])
    for tag, r in recs.items():
        state = r["weights"] + r["optimizer"]
        new_state = state - r["count"]
        assert r["donated"]["alias_size_in_bytes"] == state, tag
        assert r["pure"]["alias_size_in_bytes"] == 0, tag
        assert r["donated"]["argument_size_in_bytes"] \
            == r["pure"]["argument_size_in_bytes"] >= state
        assert r["pure_update"] - r["donated_update"] >= new_state, (tag, r)
        # the pure update sets the pure step's peak
        assert r["pure"]["temp_size_in_bytes"] \
            - r["donated"]["temp_size_in_bytes"] \
            >= (new_state if tag == "1x1" else 1), (tag, r)
