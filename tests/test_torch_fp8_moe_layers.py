"""The fp8 expert-weight train step over more than one MoE layer against
the JAX package, and on a mesh.  The float8 stack of expert weights is
sliced once for every layer (``train.step._Float8Layers``): indexed a
layer at a time, its L gradients were added in float8, which torch does
not implement (on the CPU nor on the card), while the reference's
``scan`` stacks them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_config as jget_config
from repro.data.pipeline import batch_for_step as jbatch_for_step
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import step as jstep
from _torch_ranks import run_ranks
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optimizer, step

CPU = torch.device("cpu")
GRAD_TOL = 1e-4
OPT = dict(lr=3e-3, warmup_steps=5, decay_steps=10)
F8 = torch.float8_e4m3fn


class _Float8Adds(TorchDispatchMode):
    """Records every addition with a float8 operand."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.add, torch.ops.aten.add_) \
                and any(isinstance(a, torch.Tensor) and a.dtype == F8
                        for a in args):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _weights(arch: str, n_layers: int, remat: bool):
    over = dict(n_layers=n_layers, remat=remat)
    jcfg = dataclasses.replace(jget_config(arch).smoke(), **over)
    jparams = jlm.init_params(jax.random.key(5), jcfg)
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    return jcfg, jparams, cfg, params_from_numpy(
        jax.tree.map(np.asarray, jparams), CPU)


def _at(nested, path):
    for k in path:
        nested = nested[k]
    return nested


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kernel", [False, True])
def test_fp8_step_over_two_moe_layers_matches_reference(remat, kernel):
    """deepseek-moe-16b's smoke config at 3 layers (the dense one and two
    MoE layers): the loss and every gradient of the fp8 train step
    against ``jax.grad`` of the reference's loss within 1e-4, with no
    float8 addition on the way."""
    jcfg, jparams, cfg, params = _weights("deepseek-moe-16b", 3, remat)
    assert cfg.n_layers - cfg.n_dense_layers == 2
    jt = jstep.TrainConfig(opt=jopt.OptConfig(**OPT), fp8_expert_gather=True)
    tt = step.TrainConfig(opt=optimizer.OptConfig(**OPT),
                          fp8_expert_gather=True)
    batch = jbatch_for_step(jcfg, 32, 4, step=0, seed=3)
    (jtot, _), jgrads = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jcfg, jt), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with _Float8Adds() as adds:
        (tot, _), grads = step.value_and_grad(
            step.make_loss_fn(cfg, tt, kernel), params,
            to_device(batch, CPU))
    assert adds.seen == []
    np.testing.assert_allclose(float(tot), float(jtot), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    for path, g in tree.flatten_with_path(grads):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(_at(jgrads, path), np.float32),
            rtol=GRAD_TOL, atol=GRAD_TOL, err_msg="/".join(map(str, path)))
    assert float(grads["blocks"]["we_i"][1].abs().max()) > 0


MESH_SCRIPT = r"""
import dataclasses, json
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
cfg = dataclasses.replace(get_config("deepseek-moe-16b").smoke(), n_layers=3)
tcfg = step.TrainConfig(opt=optimizer.OptConfig(**json.loads(ARGS[0])),
                        fp8_expert_gather=True)
mesh = make_host_mesh(WORLD, CPU)
whole = make_params(cfg, CPU)
params = sharding.distribute(whole, sharding.param_specs(cfg, mesh, whole),
                             mesh)
host = batch_for_step(cfg, 32, 4, 0)
with sharding_rules(sharding.activation_rules(cfg, mesh)):
    (tot, _), grads = step.value_and_grad(step.make_loss_fn(cfg, tcfg, False),
                                          params, to_device(host, CPU, mesh))
(want, _), wgrads = step.value_and_grad(step.make_loss_fn(cfg, tcfg, False),
                                        whole, to_device(host, CPU))
err = {"/".join(map(str, p)): float((g.full_tensor().float() - w.float())
                                    .abs().max())
       for (p, g), w in zip(tree.flatten_with_path(grads),
                            tree.leaves(wgrads))}
print(json.dumps({"loss": float(tot.full_tensor() if hasattr(
    tot, "full_tensor") else tot), "want": float(want), "err": err,
    "we_i_layer1": float(grads["blocks"]["we_i"].full_tensor()[1]
                         .abs().max())}))
"""


@pytest.mark.slow   # subprocesses: 2 ranks
def test_fp8_step_over_two_moe_layers_on_a_mesh(tmp_path):
    """The same fp8 step with DTensor weights on a 2-rank gloo mesh
    (model parallelism 2): its loss and every gradient equal to the
    single-process step's (held to the reference above) within 1e-4."""
    import json

    for rec in run_ranks(MESH_SCRIPT, 2, tmp_path, json.dumps(OPT)):
        assert abs(rec["loss"] - rec["want"]) <= GRAD_TOL
        assert max(rec["err"].values()) <= GRAD_TOL, rec["err"]
        assert rec["we_i_layer1"] > 0
