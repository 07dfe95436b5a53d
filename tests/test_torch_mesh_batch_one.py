"""The sharded train step at a batch of one row on a one-card mesh, the
size the families' float32 gates take for mamba2-2.7b, hymba-1.5b and
llava-next-34b, against the reference's jitted step on the same weights
and batch (smoke width, the step's loss and every stepped parameter).

On torch 2.13 DTensor refuses to reshape a dimension of size 1 that is
sharded, even over a mesh dimension of one rank: the batch of one row
placed ``Shard(0)`` over ``data`` made the first product's flatten
(``[1, S, d]`` to ``[S, d]``) raise, so ``launch.train --batch 1`` failed
on one card.  The port now keeps a tensor dimension of size 1
replicated (``sharding.placements`` given the shape, ``layers.over_data``
at the ``local_map`` sites); the other dimensions stay sharded, over a
mesh dimension of one rank too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import batch_for_step as jbatch_for_step
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import tree
from repro_torch.data.pipeline import to_device
from repro_torch.launch.mesh import close_group, init_group, make_host_mesh
from repro_torch.launch.train import PLAIN_PATH_FAMILIES
from repro_torch.parallel import sharding
from repro_torch.parallel.api import plain, sharding_rules
from repro_torch.train import optimizer, step
from test_torch_train import GRAD_TOL, OPT, SIGN_FLOOR, _at, _weights

CPU = torch.device("cpu")
ARCHS = ["qwen1.5-0.5b", "deepseek-moe-16b", "mamba2-2.7b", "hymba-1.5b",
         "whisper-small", "llava-next-34b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_at_one_row_matches_reference(arch):
    jcfg, jparams, cfg, params = _weights(arch)
    jt = jstep.TrainConfig(opt=jopt.OptConfig(**OPT))
    tt = step.TrainConfig(opt=optimizer.OptConfig(**OPT))
    batch = jbatch_for_step(jcfg, 16, 1, step=0, seed=3)
    j_step, j_init = jstep.make_train_step(jcfg, jt)
    j_loss = jstep.make_loss_fn(jcfg, jt)

    def ref(p, o, b):
        _, g = jax.value_and_grad(j_loss, has_aux=True)(p, b)
        return g, *j_step(p, o, b)

    jgrads, jnew, _, jmetrics = jax.jit(ref)(
        jparams, j_init(jparams), {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    init_group(CPU)
    try:
        mesh = make_host_mesh(1, CPU)
        dparams = sharding.distribute(
            params, sharding.param_specs(cfg, mesh, params), mesh)
        t_step, t_init = step.make_train_step(
            cfg, tt, use_kernel=cfg.family not in PLAIN_PATH_FAMILIES)
        with sharding_rules(sharding.activation_rules(cfg, mesh)):
            new, _, metrics = t_step(dparams, t_init(dparams),
                                     to_device(batch, CPU, mesh))
            loss = float(plain(metrics["loss"]))
        new = tree.map(plain, new)
    finally:
        close_group()
    np.testing.assert_allclose(loss, float(jmetrics["loss"]), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    # where 0 < |g| < SIGN_FLOOR AdamW's first step may differ by up to
    # the most a step moves a weight, 2 lr (test_torch_train's rule)
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
