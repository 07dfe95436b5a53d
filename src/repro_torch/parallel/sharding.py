"""Sharding rules (the port of ``repro/parallel/sharding.py``): parameter,
optimizer, batch, cache and activation specs per (config, mesh).

Strategy (MaxText-style 2-D + optional pod axis), as the reference's:

* ``model`` axis — tensor parallelism: attention heads, FFN hidden, the
  expert axis, the vocabulary (when divisible);
* ``data`` axis (x ``pod`` when present) — batch data parallelism and
  FSDP-style parameter sharding on the d_model dimension;
* a dimension the axis size does not divide stays replicated, so the
  tables are computed, not written per arch.

The rule functions are pure: a config, a mesh (a
:class:`repro_torch.launch.mesh.Mesh` record or a ``DeviceMesh``) and a
tree of shapes (``meta`` tensors, nested dicts) in, a tree of
:class:`Spec` out.  The reference's ``named`` (a ``NamedSharding`` of a
spec) has no counterpart: :func:`activation_rules` returns the specs, and
:func:`placements` turns a spec into the DTensor placements of a
``DeviceMesh``; :func:`distribute` places a tree by its specs, the
counterpart of ``jax.device_put(x, NamedSharding(mesh, spec))``.
"""
from __future__ import annotations

from typing import Any, Callable

from ..configs.base import ModelConfig
from ..launch.mesh import Mesh, as_record


class Spec(tuple):
    """A partition spec: one entry per dimension, each an axis name, a
    tuple of names or None (replicated).  A one-name tuple is held as the
    name, as ``jax.sharding.PartitionSpec`` holds it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _map_with_path(fn: Callable, t, prefix: tuple = ()):
    """``fn(path, leaf)`` over a tree of nested dicts (tuples are leaves:
    a :class:`Spec` is one), keeping the nesting."""
    if isinstance(t, dict):
        return {k: _map_with_path(fn, v, prefix + (k,)) for k, v in t.items()}
    return fn(prefix, t)


def spec_paths(t, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` over a tree of nested dicts, a
    :class:`Spec` (a tuple) being a leaf."""
    if isinstance(t, dict):
        return [item for k in sorted(t)
                for item in spec_paths(t[k], prefix + (k,))]
    return [(prefix, t)]


def dp_axes(mesh: Mesh) -> tuple[str, ...]:
    mesh = as_record(mesh)
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    mesh = as_record(mesh)
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _div(dim: int, mesh: Mesh, axes):
    """axes if dim divides the axis product, else None (replicate)."""
    return axes if dim % max(1, axis_size(mesh, axes)) == 0 else None


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig, mesh: Mesh, params_shape) -> dict:
    """A :class:`Spec` tree matching ``params_shape``
    (:func:`repro_torch.launch.specs.params_shape`)."""
    mesh = as_record(mesh)
    DP = dp_axes(mesh)
    M = "model"

    def spec_for(path: tuple, shp) -> Spec:
        dims = list(shp.shape)
        nd = len(dims)
        leaf = path[-1]

        def last2(a, b):
            """spec with the last two dims sharded (a, b), L-prefixed."""
            return Spec(*([None] * (nd - 2)), a, b)

        if leaf == "embed":
            return Spec(_div(dims[0], mesh, M), _div(dims[1], mesh, DP))
        if leaf in ("lm_head", "patch_proj"):
            return Spec(_div(dims[0], mesh, DP), _div(dims[1], mesh, M))
        if nd <= 2:   # norms, scalars, per-layer vectors
            return Spec(*([None] * nd))
        if leaf in ("wq", "wk", "wv", "x_wq", "x_wk", "x_wv", "wi", "ws_i",
                    "in_proj"):
            return last2(_div(dims[-2], mesh, DP), _div(dims[-1], mesh, M))
        if leaf in ("wo", "x_wo", "wo_ff", "ws_o", "out_proj"):
            return last2(_div(dims[-2], mesh, M), _div(dims[-1], mesh, DP))
        if leaf == "router":
            return last2(_div(dims[-2], mesh, DP), _div(dims[-1], mesh, M))
        if leaf == "we_i":   # [L, E, d, 2f]
            return Spec(None, _div(dims[1], mesh, M),
                        _div(dims[2], mesh, DP), None)
        if leaf == "we_o":   # [L, E, f, d]
            return Spec(None, _div(dims[1], mesh, M), None,
                        _div(dims[3], mesh, DP))
        if leaf == "conv_w":  # [L, Kc, HP]
            return Spec(None, None, _div(dims[-1], mesh, M))
        return Spec(*([None] * nd))

    return _map_with_path(spec_for, params_shape)


def opt_specs(cfg: ModelConfig, mesh: Mesh, pspecs, opt_shape) -> dict:
    """Optimizer-state specs: AdamW's ``mu`` / ``nu`` and Adafactor's
    unfactored ``v`` mirror their parameter's spec; the factored
    statistics drop the dimension they reduce (``vr`` the last, ``vc``
    the second to last); the step count is replicated."""
    mesh = as_record(mesh)
    by_key = dict(spec_paths(pspecs))

    def spec_for(keys: tuple, leaf) -> Spec:
        if keys and keys[0] in ("mu", "nu", "v"):
            rest = keys[1:]
            tail = None
            if rest and rest[-1] in ("vr", "vc", "v"):
                tail = rest[-1]
                rest = rest[:-1]
            base = by_key.get(rest)
            if base is None:
                return Spec(*([None] * leaf.ndim))
            if tail == "vr":      # param dims minus last
                return Spec(*list(base)[:-1])
            if tail == "vc":      # param dims minus second-to-last
                return Spec(*(list(base)[:-2] + list(base)[-1:]))
            return base
        return Spec(*([None] * leaf.ndim))

    return _map_with_path(spec_for, opt_shape)


# ---------------------------------------------------------------------------
# batch / cache / activation specs
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, mesh: Mesh, batch_shape) -> dict:
    """Every batch leaf's leading (batch) axis over the data axes."""
    mesh = as_record(mesh)
    DP = dp_axes(mesh)

    def spec_for(path, leaf) -> Spec:
        dims = leaf.shape
        return Spec(_div(dims[0], mesh, DP), *([None] * (len(dims) - 1)))

    return _map_with_path(spec_for, batch_shape)


def _kv_time_axes(dims, b, h, mesh: Mesh, DP):
    """The time axis of a kv cache leaf picks up whatever axes remain
    unused and divide it (sequence-parallel KV: batch-1 long context, odd
    head counts)."""
    t_axes: list = []
    if b is None and dims[2] % axis_size(mesh, DP) == 0:
        t_axes += list(DP)
    if h is None and dims[2] % (
            axis_size(mesh, tuple(t_axes)) * mesh.shape["model"]) == 0:
        t_axes.append("model")
    return tuple(t_axes) if t_axes else None


def cache_specs(cfg: ModelConfig, mesh: Mesh, cache_shape) -> dict:
    """Decode caches: kv heads over ``model`` when divisible, batch over
    the data axes when divisible, the time axis over what is left."""
    mesh = as_record(mesh)
    DP = dp_axes(mesh)
    M = "model"

    def spec_for(path, leaf) -> Spec:
        key = path[-1]
        dims = list(leaf.shape)
        if key in ("k", "v", "xk", "xv", "k_scale", "v_scale"):
            # [L, B, T, Hkv, D]; the scales [L, B, T, Hkv]
            b = _div(dims[1], mesh, DP)
            h = _div(dims[3], mesh, M)
            t = _kv_time_axes(dims, b, h, mesh, DP)
            return Spec(None, b, t, h, *([None] * (len(dims) - 4)))
        if key == "ssm":                          # [L, B, H, P, N]
            return Spec(None, _div(dims[1], mesh, DP),
                        _div(dims[2], mesh, M), None, None)
        if key == "conv":                         # [L, B, Kc-1, HP]
            return Spec(None, _div(dims[1], mesh, DP), None,
                        _div(dims[3], mesh, M))
        return Spec(*([None] * len(dims)))

    return _map_with_path(spec_for, cache_shape)


def activation_rules(cfg: ModelConfig, mesh: Mesh, *,
                     n_moe_groups: int = 0) -> dict:
    """The rule table for :func:`repro_torch.parallel.api.constrain`,
    name -> :class:`Spec`."""
    mesh = as_record(mesh)
    DP = dp_axes(mesh)
    M = "model"
    rules = {"activation": Spec(DP, None, None)}
    if cfg.is_moe:
        n_ax = DP if (n_moe_groups and
                      n_moe_groups % axis_size(mesh, DP) == 0) else None
        rules["moe_dispatch"] = Spec(n_ax, None, M, None)
        rules["moe_expert_in"] = Spec(n_ax, M, None, None)
        # the fp8 expert weights gathered over the data axis (E stays on
        # model), dequantized locally afterwards
        rules["moe_expert_w8"] = Spec(M, None, None)
    return rules


def spec_shards(spec: Spec, mesh: Mesh) -> int:
    """How many pieces ``spec`` cuts a leaf into on ``mesh``: the product
    of the sizes of the axes its entries name."""
    mesh = as_record(mesh)
    n = 1
    for e in spec:
        n *= axis_size(mesh, e)
    return n


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh, shape=None) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    ``Shard(i)`` on each mesh dimension that entry ``i`` names,
    ``Replicate()`` on the others (and, given the tensor's ``shape``, on
    those of an entry whose axes do not divide its dimension, or whose
    dimension is of size 1: DTensor refuses to reshape a dimension of
    size 1 sharded even over a mesh dimension of one rank, such as a
    batch of one row over ``data`` on a one-card mesh).  A tuple
    entry such as ``("pod", "data")`` shards one tensor dimension over
    several mesh dimensions, the first named major, as JAX lays it out;
    DTensor orders them by mesh dimension, so the names must come in the
    mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if shape is not None and (shape[i] == 1
                                  or shape[i] % axis_size(mesh, axes)):
            continue
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {axes} of dimension {i} are "
                             f"not in the mesh's order {tuple(names)}")
        for m in dims:
            out[m] = Shard(i)
    return tuple(out)


def _spec_at(specs, path: tuple) -> Spec:
    for k in path:
        specs = specs[k]
    return specs


def distribute(tree_, specs, mesh):
    """Every tensor leaf of ``tree_`` (nested dicts and tuples) as a
    DTensor on ``mesh`` placed by its spec in ``specs`` (the same nesting,
    a :class:`Spec` per leaf).  Each rank keeps its own piece of the
    tensor it holds, with no communication: every rank must hold the same
    values, as ranks that drew them from one seed do.  A leaf whose piece
    is the whole tensor (replicated, or on a mesh of one) is wrapped as it
    is, with no copy: a mesh of one serves from the very weights a single
    card does."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from .. import tree

    def one(path, x):
        pl = placements(_spec_at(specs, path), mesh, x.shape)
        if all(not p.is_shard() or mesh.size(m) == 1
               for m, p in enumerate(pl)):
            return DTensor.from_local(x, mesh, pl, run_check=False,
                                      shape=x.shape, stride=x.stride())
        return distribute_tensor(x, mesh, pl, src_data_rank=None)

    return tree.unflatten(tree_, [one(path, x) for path, x in
                                  tree.flatten_with_path(tree_)])


def local_shape(shape, mesh, placements_) -> tuple[tuple, tuple]:
    """``(local shape, global offset)`` of this rank's shard of a tensor
    of ``shape`` placed by ``placements_`` on the ``DeviceMesh`` ``mesh``,
    from the rank's mesh coordinate alone (DTensor's own helper builds
    index vectors on the host).  Every dimension a placement shards must
    divide evenly, as the specs here make them."""
    local, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements_):
        if not p.is_shard():
            continue
        n = mesh.size(m)
        if local[p.dim] % n:
            raise ValueError(f"dimension {p.dim} of {tuple(shape)} does "
                             f"not divide over {n} ranks")
        local[p.dim] //= n
        off[p.dim] += coord[m] * local[p.dim]   # mesh dimensions major first
    return tuple(local), tuple(off)


def allocate(shapes, specs, mesh, device, fill=0):
    """Every leaf of a tree of ``meta`` tensors (nested dicts) as a
    DTensor on ``mesh`` placed by its spec in ``specs``, each rank
    allocating only its own shard on ``device``, filled with ``fill``
    (``None``: left uninitialised) — the counterpart of ``jax.jit``'s
    ``out_shardings`` on a zeroed tree.  No rank ever holds a whole
    leaf."""
    import torch
    from torch.distributed.tensor import DTensor

    from .. import tree

    def one(path, x):
        pl = placements(_spec_at(specs, path), mesh)
        shp, _ = local_shape(x.shape, mesh, pl)
        t = (torch.empty(shp, dtype=x.dtype, device=device) if fill is None
             else torch.full(shp, fill, dtype=x.dtype, device=device))
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    return tree.unflatten(shapes, [one(path, x) for path, x in
                                   tree.flatten_with_path(shapes)])
