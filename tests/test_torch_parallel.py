"""The port's parallel layer and launch helpers against the JAX package.

* ``launch.specs``: every weight leaf's shape and type equal to
  ``jax.eval_shape`` of the reference's ``init_params``, the counts equal
  to the reference's (all 11 configs, kimi-k2-1t-a32b included), the
  leaves ``meta`` (nothing allocated); the batch and decode stand-ins
  alike; ``init_params`` with a generator draws what it drew before;
* ``parallel.sharding``: parameter, optimizer (AdamW and Adafactor),
  batch, cache and activation specs equal to the reference's
  ``PartitionSpec``s, compared as tuples, on abstract ``(16, 16)`` and
  ``(2, 16, 16)`` meshes and the 8-device host shapes ``(4, 2)`` and
  ``(2, 4)``;
* ``launch.dryrun``: every record's ``n_params``, ``n_active_params``
  and ``model_flops`` equal to what the reference's ``specs`` and
  ``dryrun._active_params`` give; its CLI;
* ``launch.mesh`` and ``parallel.api``;
* ``parallel.pipeline`` with the checks of
  ``tests/parallel/test_pipeline.py`` (MLP stages within 1e-5 of
  sequential, transformer stages within 1e-3, bubble 3/11), bitwise
  equal to the stages applied to each microbatch in turn, and against
  the reference's ``pipeline_apply`` on its 4-stage host mesh (a
  subprocess).
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs as jlist_configs
from repro.configs.base import shape_applicable as jshape_applicable
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.parallel import sharding as jsharding
from repro.train import optimizer as jopt
from repro_torch import tree
from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.launch import dryrun, mesh, specs
from repro_torch.models import blocks, lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import api, pipeline, sharding
from repro_torch.train import optimizer

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ARCHS = list_configs()
#: (axis sizes, axis names): the production meshes and the host shapes
#: of ``tests/parallel/test_multidevice.py``
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 4), ("data", "model"))]


def _jflat(t, is_leaf=None) -> dict:
    """A reference tree as ``{path: leaf}``, the path as the port's."""
    flat, _ = jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)
    return {tuple(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in flat}


def _flat(t, prefix=()) -> dict:
    """A port tree of nested dicts as ``{path: leaf}`` (a spec, a tuple,
    is a leaf)."""
    if isinstance(t, dict):
        out = {}
        for k, v in t.items():
            out.update(_flat(v, prefix + (str(k),)))
        return out
    return {prefix: t}


def _same_specs(got, want, what: str):
    g = _flat(got)
    w = _jflat(want, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert set(g) == set(w), what
    for path, spec in g.items():
        assert isinstance(spec, sharding.Spec), (what, path)
        assert tuple(spec) == tuple(w[path]), (what, path, spec, w[path])


def _same_shapes(got, want, what: str):
    g = _flat(got)
    w = _jflat(want)
    assert set(g) == set(w), what
    for path, t in g.items():
        assert t.device.type == "meta", (what, path)
        assert tuple(t.shape) == tuple(w[path].shape), (what, path)
        assert str(t.dtype).removeprefix("torch.") == \
            jnp.dtype(w[path].dtype).name, (what, path)


def test_configs_and_shapes_match_reference():
    assert ARCHS == jlist_configs()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_shape_matches_eval_shape(arch):
    cfg = get_config(arch)
    got = specs.params_shape(cfg)
    want = jspecs.params_shape(jget_config(arch))
    _same_shapes(got, want, "params")
    assert specs.count_params(got) == jspecs.count_params(want)


def test_counts_of_the_largest_configs():
    for arch, n in (("deepseek-moe-16b", 16_375_728_128),
                    ("llava-next-34b", 34_440_297_472),
                    ("kimi-k2-1t-a32b", 1_027_203_494_912)):
        assert specs.count_params(specs.params_shape(get_config(arch))) == n


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_decode_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        _same_shapes(specs.input_specs(cfg, shape),
                     jspecs.input_specs(jcfg, JSHAPES[name]), name)
        got = specs.decode_specs(cfg, shape)
        want = jspecs.decode_specs(jcfg, JSHAPES[name])
        _same_shapes(got, want, f"decode {name}")


def _draw_digest(params) -> str:
    h = hashlib.sha256()
    for path, t in tree.flatten_with_path(params):
        h.update("/".join(path).encode())
        h.update(t.float().numpy().tobytes())
    return h.hexdigest()[:16]


#: sha256 (first 16 hex digits) of ``init_params`` from a seed-0 CPU
#: generator at smoke width, recorded before the shape-only path was added
DRAWS = {"gemma2-2b": "e33fb92b9ce05301", "deepseek-moe-16b":
         "1f6f438d341f2e13", "hymba-1.5b": "a2238d222246dd00"}


@pytest.mark.parametrize("arch", sorted(DRAWS))
def test_init_params_draws_as_before(arch, monkeypatch):
    cfg = get_config(arch).smoke()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    assert _draw_digest(params) == DRAWS[arch]
    # the slice-at-a-time draw of the large leaves, and its meta form
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "SLICE_DRAW_NUMEL", 1)
    sliced = lm.init_params(torch.Generator().manual_seed(0), cfg)
    assert _draw_digest(sliced) == DRAWS[arch]
    meta = lm.init_params(None, cfg)
    for (path, a), (_, m) in zip(tree.flatten_with_path(sliced),
                                 tree.flatten_with_path(meta)):
        assert m.device.type == "meta" and m.shape == a.shape \
            and m.dtype == a.dtype, path


def _opt_shapes(arch: str, name: str):
    jcfg = jget_config(arch)
    jinit, _ = jopt.make_optimizer(jopt.OptConfig(name=name))
    jp = jspecs.params_shape(jcfg)
    tinit, _ = optimizer.make_optimizer(optimizer.OptConfig(name=name))
    return jax.eval_shape(jinit, jp), tinit(specs.params_shape(
        get_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    pshape, jpshape = specs.params_shape(cfg), jspecs.params_shape(jcfg)
    opts = {name: _opt_shapes(arch, name) for name in ("adamw",
                                                       "adafactor")}
    for sizes, names in MESHES:
        jm, m = AbstractMesh(sizes, names), mesh.Mesh.of(sizes, names)
        ps = sharding.param_specs(cfg, m, pshape)
        jps = jsharding.param_specs(jcfg, jm, jpshape)
        _same_specs(ps, jps, f"params {sizes}")
        for name, (jo, to) in opts.items():
            _same_shapes(to, jo, name)
            _same_specs(sharding.opt_specs(cfg, m, ps, to),
                        jsharding.opt_specs(jcfg, jm, jps, jo),
                        f"{name} {sizes}")


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_activation_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    jint8 = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    for sizes, names in MESHES:
        jm, m = AbstractMesh(sizes, names), mesh.Mesh.of(sizes, names)
        for sname, shape in SHAPES.items():
            jshape = JSHAPES[sname]
            _same_specs(
                sharding.batch_specs(cfg, m, specs.input_specs(cfg, shape)),
                jsharding.batch_specs(jcfg, jm, jspecs.input_specs(
                    jcfg, jshape)), f"batch {sname} {sizes}")
            for c, jc in ((cfg, jcfg), (int8, jint8)):
                _same_specs(
                    sharding.cache_specs(
                        c, m, specs.decode_specs(c, shape)["cache"]),
                    jsharding.cache_specs(
                        jc, jm, jspecs.decode_specs(jc, jshape)["cache"]),
                    f"cache {c.kv_cache_dtype} {sname} {sizes}")
        for groups in (0, 1, 16, 64, 512):
            got = sharding.activation_rules(cfg, m, n_moe_groups=groups)
            want = jsharding.activation_rules(jcfg, jm, n_moe_groups=groups)
            assert set(got) == set(want)
            for k, spec in got.items():
                assert tuple(spec) == tuple(want[k].spec), (k, groups)


def test_spec_holds_entries_as_partition_spec():
    for entries in ((("data",), None), (("pod", "data"), "model"),
                    ("model", None, None), ()):
        assert tuple(sharding.Spec(*entries)) == \
            tuple(PartitionSpec(*entries))
    m = mesh.make_production_mesh(multi_pod=True)
    assert sharding.spec_shards(
        sharding.Spec(("pod", "data"), None, "model"), m) == 512
    assert sharding.axis_size(m, None) == 1


@pytest.fixture
def jdryrun(monkeypatch):
    """The reference's dryrun module.  Its import sets ``XLA_FLAGS`` to
    512 host devices: the backend is started first (so this process keeps
    its devices) and the variable is restored afterwards (so later
    subprocesses do not inherit it)."""
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jd

    return jd


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "kratos-dd"])
def test_dryrun_counts_match_reference(jdryrun, arch):
    jcfg = jget_config(arch)
    jp = jspecs.params_shape(jcfg)
    n_params = jspecs.count_params(jp)
    n_active = jdryrun._active_params(jcfg, jp)
    for name, shape in JSHAPES.items():
        rec = dryrun.cell_record(arch, name, card_bytes=80 * 2**30)
        if not jshape_applicable(jcfg, shape)[0]:
            assert rec["status"] == "skipped"
            continue
        # lower_cell's model_flops, by kind
        T = shape.global_batch * (1 if shape.kind == "decode"
                                  else shape.seq_len)
        mult = {"train": 6, "prefill": 2, "decode": 2}[shape.kind]
        assert (rec["n_params"], rec["n_active_params"],
                rec["model_flops"]) == (n_params, n_active,
                                        mult * n_active * T), name
        want_opt = jdryrun._opt_config(jcfg).name if shape.kind == "train" \
            else None
        assert rec["optimizer"] == want_opt
        assert rec["argument_bytes"] == sum(rec["bytes"].values())
        assert rec["fits_one_card"] == (rec["argument_bytes"]
                                        <= 80 * 2**30)
        for tag, n in (("single", 256), ("multi", 512)):
            per = rec["per_device"][tag]
            assert per["n_devices"] == n
            assert rec["argument_bytes"] / n <= per["argument_bytes"] \
                <= rec["argument_bytes"]


def test_dryrun_bytes_by_role():
    """mamba2-2.7b at long_500k (one decode step, B 1): bf16 weights but
    the SSD's float32 leaves, the float32 state and the conv window in
    the compute type, one int32 token and the position."""
    cfg = get_config("mamba2-2.7b")
    rec = dryrun.cell_record("mamba2-2.7b", "long_500k")
    assert rec["fits_one_card"] is None and rec["card_bytes"] is None
    f32 = 3 * cfg.n_layers * cfg.ssm_heads   # dt_bias, a_log, d_skip
    assert rec["bytes"]["weights"] == 2 * (rec["n_params"] - f32) + 4 * f32
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    assert rec["bytes"]["cache"] == cfg.n_layers * (
        4 * H * P * N + 2 * (cfg.conv_kernel - 1) * H * P)
    assert rec["bytes"]["batch"] == 4 + 4
    train = dryrun.cell_record("kimi-k2-1t-a32b", "train_4k")
    assert train["optimizer"] == "adafactor"
    adam = dryrun.cell_record("tinyllama-1.1b", "train_4k")
    assert adam["bytes"]["optimizer"] == 8 * adam["n_params"] + 4


def test_dryrun_cli_writes_records(tmp_path, capsys):
    dryrun.main(["--arch", "mamba2-2.7b", "--out", str(tmp_path),
                 "--device", "cpu"])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f"mamba2-2.7b__{s}.json" for s in sorted(SHAPES)]
    rec = json.loads((tmp_path / "mamba2-2.7b__long_500k.json").read_text())
    assert rec["fits_one_card"] is None and rec["activations_counted"] is \
        False
    assert set(rec["per_device"]) == {"single", "multi"}
    out = capsys.readouterr().out
    assert out.count("mamba2-2.7b") == len(SHAPES)
    # a second run reads the records back unless forced
    (tmp_path / "mamba2-2.7b__long_500k.json").write_text(
        json.dumps({**rec, "n_params": -1}))
    assert dryrun.run_cell("mamba2-2.7b", "long_500k", tmp_path)[
        "n_params"] == -1
    assert dryrun.run_cell("mamba2-2.7b", "long_500k", tmp_path,
                           force=True)["n_params"] == rec["n_params"]


def test_meshes():
    single = mesh.make_production_mesh()
    multi = mesh.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, multi.size) == (("pod", "data", "model"), 512)
    # the host mesh: a DeviceMesh over the process group, here a gloo
    # group of one formed on the way
    try:
        host = mesh.make_host_mesh(device="cpu")
        assert host.mesh_dim_names == ("data", "model")
        assert tuple(host.shape) == (1, 1) and host.size() == 1
        assert mesh.as_record(host) == mesh.Mesh.of((1, 1),
                                                    ("data", "model"))
        with pytest.raises(ValueError, match="model_parallel"):
            mesh.make_host_mesh(2, device="cpu")
    finally:
        mesh.close_group()
    assert sharding.dp_axes(multi) == ("pod", "data")
    assert sharding.dp_axes(single) == ("data",)


def test_spec_placements_on_a_device_mesh():
    """A spec as DTensor placements: ``Shard(i)`` on each mesh dimension
    entry i names, a tuple entry over several (major first, in the
    mesh's order), ``Replicate()`` elsewhere."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    pod = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    flat = SimpleNamespace(mesh_dim_names=("data", "model"))
    P = sharding.Spec
    assert sharding.placements(P("model", ("pod", "data")), pod) == (
        Shard(1), Shard(1), Shard(0))
    assert sharding.placements(P(None, "model"), flat) == (
        Replicate(), Shard(1))
    assert sharding.placements(P(None, None), flat) == (Replicate(),) * 2
    with pytest.raises(ValueError, match="order"):
        sharding.placements(P(("data", "pod")), pod)


def test_constrain_is_identity_under_rules():
    x = torch.arange(6.0).reshape(2, 3)
    assert api.current_rules() is None
    rules = sharding.activation_rules(get_config("deepseek-moe-16b"),
                                      mesh.make_production_mesh())
    with api.sharding_rules(rules):
        assert api.current_rules() is rules
        assert api.constrain(x, "moe_dispatch") is x
        with api.sharding_rules({}):
            assert api.current_rules() == {}
        assert api.current_rules() is rules
    assert api.current_rules() is None
    assert api.constrain(x, "activation") is x


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

S_STAGES, N_MB, MB, D = 4, 8, 2, 16


def _mlp_inputs():
    r = np.random.default_rng(0)
    W = r.standard_normal((S_STAGES, D, D)).astype(np.float32) * 0.3
    b = r.standard_normal((S_STAGES, D)).astype(np.float32) * 0.1
    x = r.standard_normal((N_MB, MB, D)).astype(np.float32)
    return W, b, x


def _mlp_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def test_pipeline_mlp_matches_sequential():
    W, b, x = map(torch.from_numpy, _mlp_inputs())
    y = pipeline.pipeline_apply(_mlp_stage, {"w": W, "b": b}, x, S_STAGES)
    ref = x
    for s in range(S_STAGES):
        ref = torch.tanh(ref @ W[s] + b[s])
    assert float((y - ref).abs().max()) < 1e-5
    per_mb = torch.stack([_sequential(_mlp_stage, {"w": W, "b": b}, xm)
                          for xm in x])
    assert torch.equal(y, per_mb)
    assert abs(pipeline.bubble_fraction(N_MB, S_STAGES) - 3 / 11) < 1e-9
    assert pipeline.bubble_fraction(32, 4) < pipeline.bubble_fraction(8, 4)
    assert pipeline.bubble_fraction(8, 2) < pipeline.bubble_fraction(8, 4)


def _sequential(stage_fn, stacked, h):
    n = tree.leaves(stacked)[0].shape[0]
    for s in range(n):
        h = stage_fn(pipeline.stage_params(stacked, s), h)
    return h


def test_pipeline_drains_every_microbatch_once(monkeypatch):
    """Stages that add their index: the wavefront applies each stage to
    each microbatch exactly once, in stage order, and a tick that drains
    the wrong microbatch shows."""
    calls = []

    def stage(p, h):
        calls.append(int(p))
        return h * 10 + p

    x = torch.arange(5, dtype=torch.float64)[:, None]
    y = pipeline.pipeline_apply(stage, torch.arange(1, 4), x, 3)
    assert y[:, 0].tolist() == [v * 1000 + 123 for v in range(5)]
    assert sorted(calls) == [1] * 5 + [2] * 5 + [3] * 5
    monkeypatch.setattr(pipeline, "drain_index",
                        lambda t, n: (t - (n - 1) + 1) % 5)
    assert not torch.equal(
        pipeline.pipeline_apply(stage, torch.arange(1, 4), x, 3), y)


def _tf_weights():
    """tinyllama-1.1b's smoke config at 8 layers, the reference's seed-0
    weights, stacked 4 stages x 2 layers."""
    jcfg = dataclasses.replace(jget_config("tinyllama-1.1b").smoke(),
                               n_layers=8)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").smoke(),
                              n_layers=8)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return cfg, params


def _tf_stage(cfg, per_stage: int, positions, use_kernel=True):
    def stage(p, h):
        for i in range(per_stage):
            pi = {k: v[i] for k, v in p.items()}
            a, _ = blocks.attn_block(cfg, pi, h, positions,
                                     use_kernel=use_kernel)
            h = h + a
            h = h + blocks.ffn_block(cfg, pi, h)
        return h

    return stage


def _tf_inputs(cfg, seed: int = 1, Sq: int = 8):
    r = np.random.default_rng(seed)
    return torch.from_numpy((r.standard_normal(
        (N_MB, MB, Sq, cfg.d_model)) * 0.1).astype(np.float32))


def test_pipeline_transformer_matches_sequential():
    cfg, params = _tf_weights()
    x = _tf_inputs(cfg)
    Sq = x.shape[2]
    stacked = {k: v.reshape((S_STAGES, 2) + v.shape[1:])
               for k, v in params["blocks"].items()}
    pos = torch.arange(Sq)[None].expand(MB, Sq)
    stage = _tf_stage(cfg, 2, pos)
    y = pipeline.pipeline_apply(stage, stacked, x, S_STAGES)
    per_mb = torch.stack([_sequential(stage, stacked, xm) for xm in x])
    assert torch.equal(y, per_mb)
    ref = x.reshape(N_MB * MB, Sq, cfg.d_model)
    pos2 = torch.arange(Sq)[None].expand(N_MB * MB, Sq)
    ref = _tf_stage(cfg, 8, pos2)(params["blocks"], ref)
    ref = ref.reshape(N_MB, MB, Sq, cfg.d_model)
    assert float((y - ref).abs().max()) < 1e-3


REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config
from repro.models import blocks
from repro.models.lm import init_params
from repro.parallel.compat import AXIS_TYPE_AUTO, make_mesh
from repro.parallel.pipeline import pipeline_apply

mesh = make_mesh((4,), ("stage",), axis_types=(AXIS_TYPE_AUTO,))
W, b, x, xx = (np.load(sys.argv[1])[k] for k in ("W", "b", "x", "xx"))
y = pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                   {"w": jnp.asarray(W), "b": jnp.asarray(b)},
                   jnp.asarray(x), mesh)
cfg8 = dataclasses.replace(get_config("tinyllama-1.1b").smoke(), n_layers=8)
blk = init_params(jax.random.key(0), cfg8)["blocks"]
stage_params = jax.tree.map(lambda a: a.reshape((4, 2) + a.shape[1:]), blk)
B, Sq = xx.shape[1], xx.shape[2]
pos = jnp.broadcast_to(jnp.arange(Sq)[None], (B, Sq))

def tf_stage(p, h):
    for i in range(2):
        pi = jax.tree.map(lambda a: a[i], p)
        a, _ = blocks.attn_block(cfg8, pi, h, pos)
        h = h + a
        h = h + blocks.ffn_block(cfg8, pi, h)
    return h

y2 = pipeline_apply(tf_stage, stage_params, jnp.asarray(xx), mesh)
np.savez(sys.argv[2], y=np.asarray(y), y2=np.asarray(y2))
"""


@pytest.mark.slow  # a subprocess on an 8-device host mesh, as the one it mirrors
def test_pipeline_matches_reference_pipeline(tmp_path):
    W, b, x = _mlp_inputs()
    cfg, params = _tf_weights()
    xx = _tf_inputs(cfg)
    np.savez(tmp_path / "in.npz", W=W, b=b, x=x, xx=xx.numpy())
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npz")],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    W, b, x = map(torch.from_numpy, (W, b, x))
    y = pipeline.pipeline_apply(_mlp_stage, {"w": W, "b": b}, x, S_STAGES)
    np.testing.assert_allclose(y.numpy(), want["y"], rtol=1e-5, atol=1e-5)
    stacked = {k: v.reshape((S_STAGES, 2) + v.shape[1:])
               for k, v in params["blocks"].items()}
    Sq = xx.shape[2]
    y2 = pipeline.pipeline_apply(
        _tf_stage(cfg, 2, torch.arange(Sq)[None].expand(MB, Sq)), stacked,
        xx, S_STAGES)
    np.testing.assert_allclose(y2.numpy(), want["y2"], rtol=1e-3,
                               atol=1e-3)
