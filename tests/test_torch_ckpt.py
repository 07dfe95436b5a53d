"""Data, checkpoints, the fault-tolerant loop and the train launcher of
the port, against the JAX package's where both have them.

* ``batch_for_step`` is the reference's, array for array, bit for bit;
* checkpoints: round trip, keep-last-k, atomic writes (the checks of
  ``tests/train/test_substrate.py``), the reference's leaf names, and a
  checkpoint written by either package restored by the other;
* ``fit``: 6 steps, then a fresh ``fit`` resumed to 8 gives the
  uninterrupted run's last two losses and parameters bit for bit; the
  non-finite-loss quarantine restores and skips;
* ``python -m repro_torch.launch.train --smoke --device cpu`` runs.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.data.pipeline import batch_for_step as jbatch_for_step
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import batch_for_step, to_device
from repro_torch.launch import train as train_launch
from repro_torch.models import lm
from repro_torch.models.convert import (opt_state_from_numpy,
                                        params_from_numpy)
from repro_torch.train import loop
from repro_torch.train.loop import FitConfig, fit
from repro_torch.train.optimizer import adafactor_init, adamw_init

CPU = torch.device("cpu")


@pytest.mark.parametrize("arch,seq,batch,step,seed,shards", [
    ("tinyllama-1.1b", 64, 8, 3, 1, 1),
    ("kratos-dd", 33, 4, 0, 0, 2),
    ("mamba2-2.7b", 128, 6, 11, 7, 3),
])
def test_batch_for_step_is_the_reference(arch, seq, batch, step, seed,
                                         shards):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for shard in range(shards):
        want = jbatch_for_step(jcfg, seq, batch, step, seed=seed,
                               shard=shard, n_shards=shards)
        got = batch_for_step(cfg, seq, batch, step, seed=seed, shard=shard,
                             n_shards=shards)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    t = to_device(got, CPU)
    assert t["tokens"].dtype == t["labels"].dtype == torch.int64
    np.testing.assert_array_equal(t["tokens"].numpy(), got["tokens"])


def test_data_pipeline_deterministic_and_sharded():
    cfg = get_config("tinyllama-1.1b").smoke()
    a = batch_for_step(cfg, 64, 8, step=3, seed=1)
    b = batch_for_step(cfg, 64, 8, step=3, seed=1)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = batch_for_step(cfg, 64, 8, step=4, seed=1)
    assert not np.array_equal(a["tokens"], c["tokens"])
    s0 = batch_for_step(cfg, 64, 8, step=3, seed=1, shard=0, n_shards=2)
    s1 = batch_for_step(cfg, 64, 8, step=3, seed=1, shard=1, n_shards=2)
    assert s0["tokens"].shape == (4, 64)
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_checkpoint_roundtrip(tmp_path):
    nested = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": {"c": torch.tensor([1.5, -2.25, 3.0, 0.1],
                                      dtype=torch.bfloat16)},
              "n": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 7, nested)
    restored, step = ckpt.restore(str(tmp_path), nested)
    assert step == 7
    for path, leaf in tree.flatten_with_path(nested):
        got = restored
        for k in path:
            got = got[k]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf)
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as z:
        assert z["b/c"].dtype == np.float32  # bf16 stored as float32


def test_checkpoint_keeps_last_k(tmp_path):
    nested = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, nested, keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000005"]


def test_checkpoint_atomic_no_partial(tmp_path, monkeypatch):
    nested = {"a": torch.zeros(2)}
    ckpt.save(str(tmp_path), 1, nested)
    os.makedirs(tmp_path / ".tmp_ckpt_dead", exist_ok=True)
    assert ckpt.restore(str(tmp_path), nested)[1] == 1
    # a save that dies mid-write leaves no step directory and no tmp dir

    def die(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", die)
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path), 2, nested)
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert sorted(os.listdir(tmp_path)) == [".tmp_ckpt_dead",
                                            "step_00000001"]


def _states(arch: str, opt: str, seed: int = 0):
    """The reference's params and optimizer state for a smoke config (the
    moments filled with seeded values) and the port's copy of both."""
    jcfg = jget_config(arch).smoke()
    jparams = jlm.init_params(jax.random.key(seed), jcfg)
    init = jopt.adamw_init if opt == "adamw" else jopt.adafactor_init
    r = np.random.default_rng(seed)
    jstate = jax.tree.map(
        lambda a: jnp.asarray(r.standard_normal(a.shape), a.dtype)
        if a.dtype == jnp.float32 else a + 5, init(jparams))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    tstate = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    return (jparams, jstate), (tparams, tstate)


def _assert_same(torch_tree, jax_tree):
    flat = tree.flatten_with_path(torch_tree)
    assert len(flat) == len(jax.tree.leaves(jax_tree))
    for path, leaf in flat:
        want = jax_tree
        for k in path:
            want = want[k]
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(want, dtype=np.float32))


@pytest.mark.parametrize("arch,opt", [("tinyllama-1.1b", "adamw"),
                                      ("hymba-1.5b", "adafactor")])
def test_checkpoints_cross_between_packages(tmp_path, arch, opt):
    (jp, js), (tp, ts) = _states(arch, opt)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jdir, 3, (jp, js))
    ckpt.save(tdir, 3, (tp, ts))
    for d in (jdir, tdir):
        with np.load(os.path.join(d, "step_00000003", "arrays.npz")) as z:
            keys = set(z.files)
        assert keys == set(jckpt._flatten((jp, js))[0])
    assert "0/blocks/wq" in keys and "1/count" in keys
    # reference -> port, into a zeroed template
    zero_t = jax.tree.map(lambda a: a * 0, (tp, ts))
    got, step = ckpt.restore(jdir, zero_t)
    assert step == 3
    _assert_same(got, (jp, js))
    # port -> reference
    got_j, step = jckpt.restore(tdir, jax.tree.map(jnp.zeros_like, (jp, js)))
    assert step == 3
    _assert_same((tp, ts), got_j)


def test_restore_places_leaves_on_the_template_device(tmp_path):
    nested = {"a": torch.ones(3)}
    ckpt.save(str(tmp_path), 1, nested)
    got, _ = ckpt.restore(str(tmp_path), nested, device="cpu")
    assert got["a"].device == CPU
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"a": torch.ones(4)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), {"b": torch.ones(3)})


def _smoke_params(arch="qwen1.5-0.5b"):
    cfg = get_config(arch).smoke()
    return cfg, lm.init_params(torch.Generator().manual_seed(0), cfg)


def test_fit_resumes_bitwise(tmp_path):
    cfg, params = _smoke_params()
    # fit steps the weights it is given: each run gets its own copy
    whole = fit(cfg, tree.map(torch.clone, params),
                FitConfig(steps=8, ckpt_every=100,
                          ckpt_dir=str(tmp_path / "whole"), seq_len=32,
                          global_batch=2))
    part = str(tmp_path / "part")
    r1 = fit(cfg, params, FitConfig(steps=6, ckpt_every=3, ckpt_dir=part,
                                    seq_len=32, global_batch=2))
    assert ckpt.latest_step(part) == 6
    assert r1["losses"] == whole["losses"][:6]
    _, fresh = _smoke_params()
    r2 = fit(cfg, fresh, FitConfig(steps=8, ckpt_every=4, ckpt_dir=part,
                                   seq_len=32, global_batch=2))
    assert r2["final_step"] == 8 and len(r2["losses"]) == 2
    assert r2["losses"] == whole["losses"][6:]
    assert len(r2["step_s"]) == 2
    for a, b in zip(tree.leaves((r2["params"], r2["opt_state"])),
                    tree.leaves((whole["params"], whole["opt_state"]))):
        assert torch.equal(a, b)


def _nan_at(cfg, bad_steps, seq_len=32, batch=2):
    """``make_train_step`` whose step reports a non-finite loss on the
    data of the given steps (told apart by their tokens)."""
    real = loop.make_train_step
    bad = {batch_for_step(cfg, seq_len, batch, s)["tokens"].tobytes()
           for s in bad_steps}

    def make(cfg, tcfg, use_kernel=True):
        train_step, opt_init = real(cfg, tcfg, use_kernel=use_kernel)

        def step(params, opt_state, b):
            new_p, new_o, m = train_step(params, opt_state, b)
            if b["tokens"].to(torch.int32).numpy().tobytes() in bad:
                m = {**m, "loss": torch.tensor(float("nan"))}
            return new_p, new_o, m

        return step, opt_init

    return make


def test_fit_quarantines_non_finite_loss(tmp_path, monkeypatch):
    cfg, params = _smoke_params()
    monkeypatch.setattr(loop, "make_train_step", _nan_at(cfg, {3}))
    seen = []
    res = fit(cfg, tree.map(torch.clone, params),
              FitConfig(steps=6, ckpt_every=3, ckpt_dir=str(tmp_path),
                        seq_len=32, global_batch=2),
              hooks=[lambda s, m: seen.append(s)])
    # step 3's loss is not finite: restore the checkpoint of step 3 (three
    # steps done) and go on from good + 1 = 4, as the reference does,
    # which skips the bad batch
    assert seen == [0, 1, 2, 4, 5] and res["final_step"] == 6
    assert len(res["losses"]) == 5
    monkeypatch.setattr(loop, "make_train_step", _nan_at(cfg, range(6)))
    with pytest.raises(RuntimeError, match="too many"):
        fit(cfg, params, FitConfig(steps=6, ckpt_dir=str(tmp_path / "x"),
                                   seq_len=32, global_batch=2,
                                   max_bad_restarts=2))


def test_train_launcher_runs_on_cpu(tmp_path, capsys):
    res = train_launch.main(["--arch", "kratos-dd", "--smoke", "--steps",
                             "3", "--seq-len", "16", "--batch", "2",
                             "--ckpt-dir", str(tmp_path), "--device",
                             "cpu"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "final loss:" in out
    assert res["final_step"] == 3 and ckpt.latest_step(str(tmp_path)) == 3
    assert all(np.isfinite(res["losses"]))
    with pytest.raises(ValueError, match="model-parallel"):
        train_launch.main(["--arch", "kratos-dd", "--smoke",
                           "--model-parallel", "2", "--device", "cpu"])
