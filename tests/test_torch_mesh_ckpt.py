"""Elastic restore: a checkpoint saved from a ``(4, 2)`` mesh restores onto
a ``(2, 4)`` one, every leaf bit-equal to what was saved, within the port
and across the packages both ways (the reference's case of
``tests/parallel/test_multidevice.py``, qwen1.5-0.5b smoke).

The port saves from 8 gloo ranks (each leaf gathered, rank 0 writing)
and restores on 8 ranks into a template placed by ``param_specs`` on the
other mesh, so each rank keeps the other mesh's shards; the reference
saves and restores in a subprocess on 8 host devices with
``NamedSharding``s of its ``(2, 4)`` mesh.  The state saved is the
parameters and AdamW state after one sharded step.
"""
import json
import os
import subprocess
import sys

import pytest

from _torch_ranks import SRC, run_ranks

pytestmark = pytest.mark.slow   # subprocesses: 8 ranks and an 8-device host

ARCH = "qwen1.5-0.5b"
WORLD = 8
TIMEOUT = 300

REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from repro.checkpoint import ckpt
from repro.configs.base import get_config
from repro.data.pipeline import batch_for_step, to_device
from repro.models.lm import init_params
from repro.parallel.api import sharding_rules
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh
from repro.parallel.sharding import activation_rules, opt_specs, param_specs
from repro.train.step import TrainConfig, make_train_step

what, arch, d = sys.argv[1:4]
cfg = get_config(arch).smoke()


def mesh_of(mp):
    return make_mesh((8 // mp, mp), ("data", "model"),
                     axis_types=(AXIS_TYPE_AUTO,) * 2)


def shardings(mesh, tree):
    step_fn, opt_init = make_train_step(cfg, TrainConfig())
    pshape = jax.eval_shape(lambda: tree[0])
    ps = param_specs(cfg, mesh, pshape)
    os_ = opt_specs(cfg, mesh, ps, jax.eval_shape(opt_init, pshape))
    return jax.tree.map(lambda s: NamedSharding(mesh, s), (ps, os_),
                        is_leaf=lambda x: type(x).__name__ == "PartitionSpec")


params = init_params(jax.random.key(0), cfg)
step_fn, opt_init = make_train_step(cfg, TrainConfig())
if what == "save":            # one sharded step on (4, 2), then save
    mesh = mesh_of(2)
    sh = shardings(mesh, (params, opt_init(params)))
    params = jax.device_put(params, sh[0])
    opt = jax.device_put(opt_init(params), sh[1])
    with mesh, sharding_rules(activation_rules(cfg, mesh)):
        params, opt, _ = jax.jit(step_fn)(
            params, opt, to_device(batch_for_step(cfg, 64, 8, 0)))
    ckpt.save(d, 1, (params, opt))
    print(json.dumps({"saved": 1}))
else:                         # restore onto (2, 4), compare with the file
    mesh = mesh_of(4)
    tmpl = jax.tree.map(jnp.zeros_like, (params, opt_init(params)))
    got, step = ckpt.restore(d, tmpl, shardings=shardings(mesh, tmpl))
    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    with np.load(os.path.join(d, f"step_{step:08d}", "arrays.npz")) as z:
        bad = []
        for path, leaf in flat:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            a = np.asarray(leaf)
            a = a.astype(np.float32) if str(a.dtype) == "bfloat16" else a
            if not (a.shape == z[key].shape and np.array_equal(a, z[key])):
                bad.append(key)
            if leaf.ndim and leaf.sharding.mesh.shape != mesh.shape:
                bad.append(key + " placed on another mesh")
    print(json.dumps({"step": step, "leaves": len(flat), "bad": bad}))
"""

PORT_SCRIPT = r"""
import json, os
import numpy as np
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

what, arch, d = ARGS
CPU = torch.device("cpu")
cfg = get_config(arch).smoke()
step_fn, opt_init = make_train_step(cfg, TrainConfig())


def placed(mesh, params):
    ps = sharding.param_specs(cfg, mesh, params)
    opt = opt_init(params)
    os_ = sharding.opt_specs(cfg, mesh, ps, opt)
    return sharding.distribute((params, opt), (ps, os_), mesh)


params = make_params(cfg, CPU)
if what == "save":            # one sharded step on (4, 2), then save
    mesh = make_host_mesh(2, CPU)
    params, opt = placed(mesh, params)
    with sharding_rules(sharding.activation_rules(cfg, mesh)):
        params, opt, _ = step_fn(params, opt, to_device(
            batch_for_step(cfg, 64, 8, 0), CPU, mesh))
    ckpt.save(d, 1, (params, opt))
    print(json.dumps({"saved": 1}))
else:                         # restore onto (2, 4), compare with the file
    mesh = make_host_mesh(4, CPU)
    tmpl = placed(mesh, tree.map(torch.zeros_like, params))
    got, step = ckpt.restore(d, tmpl)
    bad = []
    with np.load(os.path.join(d, f"step_{step:08d}", "arrays.npz")) as z:
        for (path, leaf), (_, t) in zip(tree.flatten_with_path(got),
                                        tree.flatten_with_path(tmpl)):
            key = "/".join(map(str, path))
            if hasattr(t, "placements") and (
                    leaf.placements != t.placements
                    or leaf.device_mesh != t.device_mesh):
                bad.append(key + " placed otherwise")
            full = leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
            full = full.float() if full.dtype == torch.bfloat16 else full
            if not np.array_equal(full.numpy(), z[key]) or \
                    full.numpy().dtype != z[key].dtype:
                bad.append(key)
    print(json.dumps({"step": step, "leaves": len(tree.leaves(got)),
                      "bad": bad}))
"""


def _ref(tmp_path, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT, *args],
                         capture_output=True, text=True, env=env,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port(tmp_path, *args) -> list:
    return run_ranks(PORT_SCRIPT, WORLD, tmp_path, *args, timeout=TIMEOUT)


def _restored(recs: list, n_leaves_at_least: int = 10) -> None:
    for rec in recs:
        assert rec["step"] == 1 and rec["bad"] == []
        assert rec["leaves"] >= n_leaves_at_least


def test_port_saves_on_4x2_and_restores_on_2x4(tmp_path):
    d = str(tmp_path / "ck")
    _port(tmp_path, "save", ARCH, d)
    _restored(_port(tmp_path, "restore", ARCH, d))


def test_reference_checkpoint_restores_onto_the_port_mesh(tmp_path):
    d = str(tmp_path / "ck")
    _ref(tmp_path, "save", ARCH, d)
    _restored(_port(tmp_path, "restore", ARCH, d))


def test_port_checkpoint_restores_onto_the_reference_mesh(tmp_path):
    d = str(tmp_path / "ck")
    _port(tmp_path, "save", ARCH, d)
    _restored([_ref(tmp_path, "restore", ARCH, d)])
