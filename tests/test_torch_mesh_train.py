"""The port's sharded train step on 8 gloo ranks against the reference's
on 8 host devices.

The cases of ``tests/parallel/test_multidevice.py``: qwen1.5-0.5b and
deepseek-moe-16b with model parallelism 2 (a ``(4, 2)`` mesh), mamba2-2.7b
with 4 (``(2, 4)``), smoke configs, 3 AdamW steps (``TrainConfig()``) on
``batch_for_step(cfg, 64, 8, s)``.  Both packages start from the same
weights, the reference's ``init_params(key(0))`` written as a checkpoint
(the shared format) and restored by each.  The reference runs its
sharded step in a subprocess on a mesh built by
``repro.parallel.compat.make_mesh(..., axis_types=(AXIS_TYPE_AUTO,) * 2)``
(its own ``make_host_mesh`` makes the axes Explicit under jax 0.9); the
port runs ``train.step`` on DTensors placed by ``param_specs`` under
``activation_rules``, in 8 processes.  Both save their final parameters
and optimizer state as checkpoints (the port's gathered by rank 0), which
are compared leaf by leaf.  Held: each step's loss, and every parameter
and optimizer leaf after 3 steps, within ``GRAD_TOL`` (rtol and atol, as
in ``tests/test_torch_train.py``); each rank's local shards are its
spec's share of each leaf.

The cases also hold whisper-small and hymba-1.5b on a ``(1, 8)`` mesh,
whose ``model`` axis does not divide their 4 heads (as ``(16, 16)`` does
not divide whisper's 12 or hymba's 25, where torch 2.11 refused the
step), and the port's 8 ranks there are held to the reference's
unsharded step too (one device, from the same weights): losses and every
parameter and optimizer leaf within ``GRAD_TOL``.  The gradient
placements the port pins change no number.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_ranks import SRC, run_ranks
from repro.checkpoint import ckpt as jckpt
from repro.configs.base import get_config as jget_config
from repro.models.lm import init_params as jinit_params

pytestmark = pytest.mark.slow   # subprocesses: 8 ranks and an 8-device host

GRAD_TOL = 1e-4
#: model parallelism 8 of 8 ranks: 8 does not divide the 4 heads
UNEVEN_CASES = [("whisper-small", 8), ("hymba-1.5b", 8)]
CASES = [("qwen1.5-0.5b", 2), ("deepseek-moe-16b", 2),
         ("mamba2-2.7b", 4)] + UNEVEN_CASES
WORLD = 8
#: each launch's time limit, seconds
TIMEOUT = 420

REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.checkpoint import ckpt
from repro.configs.base import get_config
from repro.data.pipeline import batch_for_step, to_device
from repro.models.lm import init_params
from repro.parallel.api import sharding_rules
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh
from repro.parallel.sharding import activation_rules, param_specs
from repro.train.step import TrainConfig, make_train_step


def steps(cfg, params):
    # 3 AdamW steps of the jitted train step from params
    step_fn, opt_init = make_train_step(cfg, TrainConfig())
    opt = opt_init(params)
    jstep = jax.jit(step_fn, donate_argnums=(0, 1))
    losses = []
    for s in range(3):
        batch = to_device(batch_for_step(cfg, 64, 8, s))
        params, opt, m = jstep(params, opt, batch)
        losses.append(float(m["loss"]))
    return params, opt, losses


out = {}
one = json.loads(sys.argv[2])
for arch, mp, d in json.loads(sys.argv[1]):
    cfg = get_config(arch).smoke()

    def init():
        return ckpt.restore(d + "/init",
                            init_params(jax.random.key(0), cfg))[0]

    mesh = make_mesh((8 // mp, mp), ("data", "model"),
                     axis_types=(AXIS_TYPE_AUTO,) * 2)
    params = init()
    pspecs = param_specs(cfg, mesh, jax.eval_shape(lambda: params))
    params = jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
        pspecs, is_leaf=lambda x: isinstance(x, jax.Array))
    with mesh, sharding_rules(activation_rules(cfg, mesh)):
        params, opt, losses = steps(cfg, params)
    ckpt.save(d + "/ref", 3, (params, opt))
    out[arch] = {"losses": losses, "mesh": dict(mesh.shape),
                 "n_devices": len(jax.devices())}
    if arch in one:
        # the unsharded step: one device, no rules
        params, opt, losses = steps(cfg, init())
        ckpt.save(d + "/one", 3, (params, opt))
        out[arch]["one_losses"] = losses
print(json.dumps(out))
"""

PORT_SCRIPT = r"""
import json
import torch
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import batch_for_step, to_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import make_params
from repro_torch.parallel import sharding
from repro_torch.parallel.api import sharding_rules
from repro_torch.train.step import TrainConfig, make_train_step

CPU = torch.device("cpu")


def shares(params, pspecs, mesh):
    # every leaf's local shape: its global shape cut by its spec's axes
    bad = []
    for path, x in tree.flatten_with_path(params):
        spec = sharding._spec_at(pspecs, path)
        want = [n // sharding.axis_size(mesh, e)
                for n, e in zip(x.shape, spec)]
        local = list(x.to_local().shape)
        if local != want or (x.numel() // max(1, x.to_local().numel())
                             != sharding.spec_shards(spec, mesh)):
            bad.append(["/".join(path), local, want])
    return bad


def embed_probe(cfg, params, mesh):
    # the lookup on the sharded table: collectives made, placements, and
    # the values against the whole table's rows; then the activation pin
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.models import lm
    from repro_torch.parallel.api import constrain

    batch = batch_for_step(cfg, 64, 8, 0)
    toks = to_device(batch, CPU, mesh)["tokens"]
    rec = {}
    rep = toks.redistribute(mesh, [Replicate()] * 2)
    for name, t in (("sharded", toks), ("replicated", rep)):
        with CommDebugMode() as cm:
            emb = lm.embed_tokens(cfg, params, t)
        rec[name] = {str(k).split(".")[-1]: v
                     for k, v in cm.get_comm_counts().items()}
    ids = torch.from_numpy(batch["tokens"]).long()
    want = params["embed"].full_tensor()[ids]
    rec["max_err"] = float((emb.full_tensor() - want).abs().max())
    with sharding_rules(sharding.activation_rules(cfg, mesh)):
        pinned = constrain(emb, "activation")
    rec["pinned"] = [str(p) for p in pinned.placements]
    rec["pinned_err"] = float((pinned.full_tensor() - want).abs().max())
    return rec


out = {}
for arch, mp, d in json.loads(ARGS[0]):
    cfg = get_config(arch).smoke()
    mesh = make_host_mesh(mp, CPU)
    template = make_params(cfg, CPU)
    pspecs = sharding.param_specs(cfg, mesh, template)
    params, _ = ckpt.restore(d + "/init",
                             sharding.distribute(template, pspecs, mesh))
    bad = shares(params, pspecs, mesh)
    if arch == "qwen1.5-0.5b":
        out["embed"] = embed_probe(cfg, params, mesh)
    step_fn, opt_init = make_train_step(cfg, TrainConfig())
    opt = opt_init(params)
    losses = []
    with sharding_rules(sharding.activation_rules(cfg, mesh)):
        for s in range(3):
            batch = to_device(batch_for_step(cfg, 64, 8, s), CPU, mesh)
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
    ckpt.save(d + "/port", 3, (params, opt))
    out[arch] = {"losses": losses, "bad_shares": bad,
                 "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape))}
print(json.dumps(out))
"""



def _init_cases(root, cases) -> list:
    """The reference's initial weights of each case, written as a
    checkpoint under ``root``: ``[[arch, mp, directory], ...]``."""
    out = []
    for arch, mp in cases:
        d = root / arch
        jckpt.save(str(d / "init"), 0,
                   jinit_params(jax.random.key(0),
                                jget_config(arch).smoke()))
        out.append([arch, mp, str(d)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs of every case: ``(reference record, every
    rank's port record, {arch: case directory})``."""
    root = tmp_path_factory.mktemp("mesh_train")
    cases = _init_cases(root, CASES)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                            json.dumps(cases),
                            json.dumps([a for a, _ in UNEVEN_CASES])],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    try:
        port = run_ranks(PORT_SCRIPT, WORLD, root, json.dumps(cases),
                         timeout=TIMEOUT)
        out, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    return (json.loads(out.strip().splitlines()[-1]), port,
            {arch: Path(d) for arch, _, d in cases})


def _arrays(d: Path) -> dict:
    with np.load(d / "step_00000003" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("arch,mp", CASES)
def test_mesh_losses_match_the_reference(runs, arch, mp):
    ref, port, _ = runs
    assert ref[arch]["n_devices"] == WORLD
    assert ref[arch]["mesh"] == {"data": WORLD // mp, "model": mp}
    for rank in port:
        assert rank[arch]["mesh"] == ref[arch]["mesh"]
        np.testing.assert_allclose(rank[arch]["losses"],
                                   ref[arch]["losses"], rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    assert all(np.isfinite(ref[arch]["losses"]))


@pytest.mark.parametrize("arch,mp", CASES)
def test_mesh_state_matches_the_reference(runs, arch, mp):
    """Parameters and AdamW state after 3 steps, gathered, leaf by leaf."""
    _, _, dirs = runs
    got, want = _arrays(dirs[arch] / "port"), _arrays(dirs[arch] / "ref")
    assert sorted(got) == sorted(want)
    assert any(k.startswith("1/mu/") for k in got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("arch,mp", CASES)
def test_local_shards_are_the_specs_share(runs, arch, mp):
    _, port, _ = runs
    assert len(port) == WORLD
    for rank in port:
        assert rank[arch]["bad_shares"] == []


def test_embedding_gathers_no_table(runs):
    """The lookup on the ``[V on model, d on data]`` table gathers the
    token ids (one all-gather, none once they are replicated) and never
    the table; the activation pin puts the rows on data, replicated over
    model."""
    _, port, _ = runs
    for rank in port:
        rec = rank["embed"]
        assert rec["replicated"].get("all_gather_into_tensor", 0) == 0, rec
        assert rec["sharded"].get("all_gather_into_tensor", 0) == 1, rec
        assert rec["max_err"] == 0.0 and rec["pinned_err"] == 0.0
        assert rec["pinned"] == ["S(0)", "R"]


@pytest.mark.parametrize("arch,mp", UNEVEN_CASES)
def test_uneven_mesh_matches_one_process(runs, arch, mp):
    """The port's 8 ranks against the reference's unsharded step in one
    process on one device: each step's loss, then every parameter and
    optimizer leaf after 3 steps."""
    ref, port, dirs = runs
    for rank in port:
        assert rank[arch]["mesh"] == {"data": WORLD // mp, "model": mp}
        np.testing.assert_allclose(rank[arch]["losses"],
                                   ref[arch]["one_losses"], rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    assert all(np.isfinite(ref[arch]["one_losses"]))
    got, want = _arrays(dirs[arch] / "port"), _arrays(dirs[arch] / "one")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=k)
