"""The port's sharded prefill and decode on 8 gloo ranks against the
reference's on 8 host devices.

Both run on a ``(4, 2)`` ``("data", "model")`` mesh: the reference's
built by ``repro.parallel.compat.make_mesh(..., axis_types=(AXIS_TYPE_AUTO,)
* 2)`` in a subprocess, as its dry run places a serving cell (weights by
``param_specs``, the cache by ``cache_specs``, the tokens and an encdec
model's frames or a vlm model's patches over ``data``, under
``activation_rules`` with ``n_moe_groups`` ``T // g`` at prefill and
``B // g`` at decode); the port's on DTensors placed by the same specs
(``sharding.distribute``, ``init_cache(..., mesh=)``,
``data.pipeline.to_device(..., mesh)``).  Both start from the same
weights, the reference's ``init_params(key(0))`` carried as numpy
(``models/convert.py``), and the same numpy prompts.  Each run is a
prefill then 3 greedy decode steps, each feeding its own argmax token; the
port runs both attention routes (the flash route, whose plain version
runs on the CPU, and the reference's masked attention).

Held, for each smoke-width family and a batch of 2, which ``data`` (4)
does not divide, so the cache's time axis is sharded over ``data``:
every step's logits within ``TOL``, the greedy tokens equal, and every
cache leaf, gathered, within ``TOL`` (the reference's own sharded run
differs from its unsharded run by at most 1.3e-5); each rank's cache
shards are its spec's share.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from _torch_ranks import SRC, run_ranks
from repro.configs.base import get_config as jget_config
from repro.models.lm import init_params as jinit_params

pytestmark = pytest.mark.slow   # subprocesses: 8 ranks and an 8-device host

TOL = 1e-4
WORLD = 8
#: (case, arch, batch, prompt length); the cache holds the prompt, a vlm
#: model's patches and 3 decoded tokens, rounded up to a multiple of 8
CASES = [("qwen1.5-0.5b", "qwen1.5-0.5b", 4, 8),
         ("deepseek-moe-16b", "deepseek-moe-16b", 4, 8),
         ("mamba2-2.7b", "mamba2-2.7b", 4, 8),
         ("hymba-1.5b", "hymba-1.5b", 4, 8),
         ("whisper-small", "whisper-small", 4, 8),
         ("llava-next-34b", "llava-next-34b", 4, 8),
         ("qwen1.5-0.5b-b2", "qwen1.5-0.5b", 2, 8)]
STEPS = 3
ROUTES = ("kernel", "plain")
#: the launch's time limit, seconds
TIMEOUT = 300

COMMON = r"""
import json, sys
import numpy as np


def nest(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def cache_len(cfg, S):
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    return -(-(S + extra + STEPS) // 8) * 8, extra


STEPS = %d
""" % STEPS

REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
""" + COMMON + r"""
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.parallel.api import sharding_rules
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh
from repro.parallel.sharding import (activation_rules, batch_specs,
                                     cache_specs, param_specs)
from repro.serve.decode import decode_step, prefill
from repro.serve.kvcache import init_cache

mesh = make_mesh((4, 2), ("data", "model"), axis_types=(AXIS_TYPE_AUTO,) * 2)


def ns(tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


for name, arch, B, S, d in json.loads(sys.argv[1]):
    cfg = get_config(arch).smoke()
    z = dict(np.load(d + "/inputs.npz"))
    params = jax.tree.map(jnp.asarray, nest(z, "params/"))
    toks = z["tokens"]
    extras = {k: z[k] for k in ("encoder_feats", "patch_embeds") if k in z}
    T, extra = cache_len(cfg, S)
    cache = init_cache(cfg, B, T, encoder_len=cfg.encoder_seq or None)
    pspecs = param_specs(cfg, mesh, jax.eval_shape(lambda: params))
    cspecs = cache_specs(cfg, mesh, jax.eval_shape(lambda: cache))
    tspec = batch_specs(cfg, mesh, {"t": toks})["t"]
    espec = {k: P("data", None, None) for k in extras}
    g = min(cfg.moe_group_size, B * S)
    logits_all, tokens = [], []
    with mesh:
        with sharding_rules(activation_rules(cfg, mesh,
                                             n_moe_groups=B * S // g)):
            fn = jax.jit(lambda p, c, t, e: prefill(cfg, p, c, t, **e),
                         in_shardings=(ns(pspecs), ns(cspecs), ns(tspec),
                                       ns(espec)))
            logits, cache = fn(params, cache, toks, extras)
        g = min(cfg.moe_group_size, B)
        with sharding_rules(activation_rules(cfg, mesh, n_moe_groups=B // g)):
            fn = jax.jit(lambda p, c, t, pos: decode_step(cfg, p, c, t, pos),
                         in_shardings=(ns(pspecs), ns(cspecs), ns(tspec),
                                       None))
            for i in range(STEPS + 1):
                logits_all.append(np.asarray(logits, np.float32))
                tok = np.asarray(jnp.argmax(logits[:, -1], -1)
                                 )[:, None].astype(np.int32)
                tokens.append(tok)
                if i == STEPS:
                    break
                logits, cache = fn(params, cache, tok,
                                   jnp.int32(S + extra + i))
    np.savez(d + "/ref.npz", logits=np.concatenate(logits_all, 1),
             tokens=np.concatenate(tokens, 1),
             **{"cache/" + k: np.asarray(v, np.float32)
                for k, v in cache.items()},
             n_devices=len(jax.devices()))
print(json.dumps({"ok": True}))
"""

PORT_SCRIPT = COMMON + r"""
import torch
from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import to_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import sharding
from repro_torch.parallel.api import plain, sharding_rules
from repro_torch.serve.decode import decode_step, prefill
from repro_torch.serve.kvcache import init_cache

CPU = torch.device("cpu")
mesh = make_host_mesh(2, CPU)
out = {}


def shares(cache, cfg):
    # every cache leaf's local shape: its global shape cut by its spec
    specs = sharding.cache_specs(cfg, mesh, cache)
    bad, time_axes = [], {}
    for path, x in tree.flatten_with_path(cache):
        spec = sharding._spec_at(specs, path)
        want = [n // sharding.axis_size(mesh, e)
                for n, e in zip(x.shape, spec)]
        if list(x.to_local().shape) != want:
            bad.append(["/".join(path), list(x.to_local().shape), want])
        if path[-1] in ("k", "v"):
            time_axes[path[-1]] = spec[2]
    return bad, time_axes


for name, arch, B, S, d in json.loads(ARGS[0]):
    cfg = get_config(arch).smoke()
    z = dict(np.load(d + "/inputs.npz"))
    weights = params_from_numpy(nest(z, "params/"), CPU)
    params = sharding.distribute(
        weights, sharding.param_specs(cfg, mesh, weights), mesh)
    batch = to_device({k: z[k] for k in ("tokens", "encoder_feats",
                                         "patch_embeds") if k in z},
                      CPU, mesh)
    toks = batch.pop("tokens")
    T, extra = cache_len(cfg, S)
    rec = {}
    for route in ("kernel", "plain"):
        use_kernel = route == "kernel"
        cache = init_cache(cfg, B, T, encoder_len=cfg.encoder_seq or None,
                           device=CPU, mesh=mesh)
        bad, time_axes = shares(cache, cfg)
        g = min(cfg.moe_group_size, B * S)
        logits_all, tokens = [], []
        with sharding_rules(sharding.activation_rules(
                cfg, mesh, n_moe_groups=B * S // g)):
            logits, cache = prefill(cfg, params, cache, toks,
                                    use_kernel=use_kernel, **batch)
        g = min(cfg.moe_group_size, B)
        with sharding_rules(sharding.activation_rules(
                cfg, mesh, n_moe_groups=B // g)):
            for i in range(STEPS + 1):
                full = plain(logits).float()
                logits_all.append(full.numpy())
                tok = torch.argmax(full[:, -1], -1)[:, None]
                tokens.append(tok.numpy())
                if i == STEPS:
                    break
                tok = to_device({"t": tok.numpy()}, CPU, mesh)["t"]
                logits, cache = decode_step(cfg, params, cache, tok,
                                            S + extra + i,
                                            use_kernel=use_kernel)
        gathered = {k: plain(v).float().numpy() for k, v in cache.items()}
        if RANK == 0:
            np.savez(d + f"/port_{route}.npz",
                     logits=np.concatenate(logits_all, 1),
                     tokens=np.concatenate(tokens, 1),
                     **{"cache/" + k: v for k, v in gathered.items()})
        rec[route] = {"bad_shares": bad, "time_axes": time_axes,
                      "cache_is_dtensor": all(
                          type(v).__name__ == "DTensor"
                          for v in cache.values())}
    out[name] = rec
print(json.dumps(out))
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(per-rank port records, {case: its directory})``; each
    directory holds ``ref.npz`` and ``port_<route>.npz``."""
    root = tmp_path_factory.mktemp("mesh_serve")
    cases = []
    for name, arch, B, S in CASES:
        cfg = jget_config(arch).smoke()
        d = root / name
        d.mkdir()
        rng = np.random.default_rng(0)
        inputs = {"tokens": rng.integers(1, cfg.vocab, size=(B, S)
                                         ).astype(np.int32)}
        n = {"encdec": ("encoder_feats", cfg.encoder_seq),
             "vlm": ("patch_embeds", cfg.n_patches)}.get(cfg.family)
        if n is not None:
            inputs[n[0]] = (rng.standard_normal((B, n[1], cfg.d_model))
                            * 0.02).astype(np.float32)
        params = _flat(jinit_params(jax.random.key(0), cfg), "params/")
        np.savez(d / "inputs.npz", **inputs, **params)
        cases.append([name, arch, B, S, str(d)])
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                            json.dumps(cases)], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = run_ranks(PORT_SCRIPT, WORLD, root, json.dumps(cases),
                         timeout=TIMEOUT)
        _, err = ref.communicate(timeout=TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    return port, {name: root / name for name, *_ in CASES}


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_serving_matches_the_reference(runs, case, route):
    """Logits at the prefill and every decode step, and the greedy
    tokens."""
    _, dirs = runs
    ref = _load(dirs[case] / "ref.npz")
    got = _load(dirs[case] / f"port_{route}.npz")
    assert int(ref["n_devices"]) == WORLD
    assert got["logits"].shape == ref["logits"].shape
    assert np.isfinite(got["logits"]).all()
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_cache_matches_the_reference(runs, case, route):
    """Every cache leaf after the prefill and the decode steps, gathered
    whole; each rank's shards are its spec's share."""
    port, dirs = runs
    ref = _load(dirs[case] / "ref.npz")
    got = _load(dirs[case] / f"port_{route}.npz")
    keys = sorted(k for k in ref if k.startswith("cache/"))
    assert keys == sorted(k for k in got if k.startswith("cache/"))
    for k in keys:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    for rank in port:
        assert rank[case][route]["bad_shares"] == []
        assert rank[case][route]["cache_is_dtensor"]


def test_batch_of_two_shards_the_cache_over_time(runs):
    """At a batch of 2 the ``data`` axis (4) cannot take the batch, so
    the kv cache's time axis is sharded over it (a rank's decode write
    lands in one rank's slice)."""
    port, _ = runs
    for rank in port:
        for route in ROUTES:
            assert rank["qwen1.5-0.5b-b2"][route]["time_axes"] == {
                "k": "data", "v": "data"}
            assert rank["qwen1.5-0.5b"][route]["time_axes"] == {
                "k": None, "v": None}
