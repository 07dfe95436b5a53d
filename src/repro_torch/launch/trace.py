"""The dry run's trace: a cell's real step on DTensors of ``meta``
tensors over a fake process group of the mesh's size, the counterpart of
the reference dry run's ``lower_cell`` + ``compile_cell``.

    python -m repro_torch.launch.trace --mesh single \\
        --cells '[["qwen1.5-0.5b", "train_4k"], ...]'

prints one JSON record per cell (:func:`start` and :func:`collect` run
it from another process).  The process forms the fake group
(``torch.distributed``'s ``fake`` backend: every collective is a no-op
that gives tensors of the right shapes) and builds a ``DeviceMesh`` of
the production shape on it, so it must be a process of its own: it
refuses to run where a process group is formed already.  Each argument
(weights, optimizer state, cache, batch) is a DTensor placed by the
specs ``launch.dryrun`` computes, over a ``meta`` tensor of this rank's
shard (a shape and a type, nothing allocated), and the
step is the one the port runs: ``train.step.make_train_step`` for a
train cell (donating its weights and optimizer state, as ``fit`` does),
``serve.decode.prefill`` or ``decode_step`` for a serving cell, under
the reference's ``activation_rules``, through the plain route
(``use_kernel=False``), as the reference's dry run lowers its jnp path.

A dispatch mode (:class:`Counter`) sits under DTensor and sees every op
a rank runs on its own shards, so every count is per device:

* ``memory``: ``argument_size_in_bytes`` (the local shards of the
  arguments), ``output_size_in_bytes`` and ``alias_size_in_bytes`` (of
  the outputs, and of those that are arguments updated in place: the
  cache, and a train step's weights and optimizer state, which the step
  donates as the reference's does), ``temp_size_in_bytes``: the peak of
  the bytes of the storages the step allocates that are alive at once,
  outputs included;
* ``cost``: ``flops``, the matrix products' and convolutions' (torch's
  ``flop_registry``, as ``FlopCounterMode`` counts them) on local shapes;
  ``transcendentals``, an element of each exp, log, tanh, sin, cos,
  rsqrt, sqrt, sigmoid, erf, pow, softmax and of the activations built
  on them; ``bytes accessed``, every operand and result of every op but
  views.  Unfused, that is an upper bound on a fused compile's figure;
* ``collectives``: the count and result bytes of each all-gather,
  all-reduce, reduce-scatter, all-to-all and collective-permute, and
  ``total_bytes``.  DTensor's CPU groups turn a shard-to-shard
  redistribution (an all-to-all on NCCL) into an all-gather and a chunk;
  the trace gives it the all-to-all the card runs instead.  A collective
  over a group of one rank moves nothing and is not recorded.

The ops DTensor runs on global shapes to learn an output's shape
(sharding propagation) are not the step's and are not counted.

A sequential SSD scan (``kernels.ref.ssd_recurrence``, a Python step per
token: the plain route's prefill, and its training without
``ssd_chunk``) past ``STEPWISE_MAX`` steps is traced in closed form
(:func:`_closed_recurrence`): five steps run, the middle one's ops and
the storages it leaves alive counted for the steps it stands for, in the
forward and in the backward.  Every count equals the stepwise trace's,
FLOPs per step x steps; such a record says so (``scan``, ``flops_are``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: collective ops of ``torch.distributed`` (functional, autograd, c10d and
#: DTensor's own) by the reference's kind
_COLLECTIVE = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                    "_dtensor")

#: ops counted as one transcendental per element of their result
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "sin", "cos", "tan", "rsqrt", "sqrt", "erf", "pow", "silu",
    "gelu", "softplus", "_softmax", "_log_softmax", "logaddexp",
    "logsumexp", "silu_backward", "gelu_backward"))

#: ops that allocate without touching memory
_NO_ACCESS = frozenset(("empty", "empty_strided", "empty_like", "device"))


def _tensors(x) -> list:
    """The tensors in ``x``: a tensor, or lists, tuples and dicts of them
    (an op's arguments and results)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return []
    return [t for item in x for t in _tensors(item)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _group_size(args) -> int | None:
    """The size of the process group a collective's arguments name (a
    group name or a ``ProcessGroup``), or None."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        try:
            if isinstance(a, str):
                return _resolve_process_group(a).size()
            if isinstance(a, torch.ScriptObject):
                return ProcessGroup.unbox(a).size()
        except (AttributeError, KeyError, RuntimeError, TypeError,
                ValueError):
            continue    # a reduce op's name or object
    return None


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class Counter(TorchDispatchMode):
    """A dispatch mode that counts the local ops of a step run on
    DTensors (ops on DTensors pass through to DTensor, which runs their
    local ops, and those come back here): FLOPs, transcendentals, bytes
    accessed, collectives, and the bytes of the storages the step
    allocates, alive at once at the peak.  Storages of ``held`` tensors
    (the arguments) are not the step's."""

    def __init__(self, held=()):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.collectives = {}
        self.live = 0
        self.peak = 0
        self.largest_real = 0
        #: each op counted this many times (a closed-form scan's step
        #: standing for many)
        self.scale = 1
        #: the sequential scans met: ``[steps, "stepwise" | "closed form"]``
        self.scans: list = []
        self._known = {_storage_key(t) for t in held}
        #: storage -> [bytes counted, serial of its allocation]
        self._mine: dict = {}
        #: the storages tracked so far (each one's serial)
        self.serial = 0
        self._quiet = 0

    @contextlib.contextmanager
    def quiet(self):
        """Ops run inside are not counted (sharding propagation's)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def _free(self, key, serial: int) -> None:
        rec = self._mine.get(key)
        if rec is not None and rec[1] == serial:
            del self._mine[key]
            self.live -= rec[0]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._known or key in self._mine:
            return
        st = t.untyped_storage()
        n = st.nbytes()
        self.serial += 1
        self._mine[key] = [n, self.serial]
        weakref.finalize(st, self._free, key, self.serial)
        self.live += n
        self.peak = max(self.peak, self.live)

    def alive_since(self, serial: int) -> list:
        """The storages allocated after ``serial`` (a past
        :attr:`serial`) that are alive now."""
        return [(k, s) for k, (_, s) in self._mine.items() if s > serial]

    def reweight(self, born: list, times: int) -> None:
        """Count each of ``born`` (:meth:`alive_since`) still alive
        ``times`` over: the storage of one step of a closed-form scan
        standing for that many steps' storages."""
        for key, serial in born:
            rec = self._mine.get(key)
            if rec is not None and rec[1] == serial:
                self.live += rec[0] * (times - 1)
                rec[0] *= times
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if func.namespace == "prim":    # metadata: device, layout
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for t in ins + outs:
            if t.device.type != "meta":
                self.largest_real = max(self.largest_real, _nbytes(t))
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        k = self.scale
        if ns in _COMM_NAMESPACES:
            kind = _COLLECTIVE.get(name)
            if kind is not None and _group_size(args) != 1:
                rec = self.collectives.setdefault(kind, {"count": 0,
                                                         "bytes": 0})
                rec["count"] += k
                rec["bytes"] += k * sum(_nbytes(t) for t in outs)
            for t in outs:
                self._track(t)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += k * flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        if name in _TRANSCENDENTAL:
            self.transcendentals += k * sum(t.numel() for t in outs)
        if _is_view(func) or name in _NO_ACCESS:
            return out
        self.bytes_accessed += k * sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        return out


_ABSENT = object()


@contextlib.contextmanager
def _patched(patches):
    """Each ``(owner, name, wrap)``: ``owner.name`` replaced by
    ``wrap(owner.name)`` for the ``with`` block, then restored (a name
    this torch does not have is left alone)."""
    patches = [p for p in patches if hasattr(p[0], p[1])]
    saved = [(owner, name, owner.__dict__.get(name, _ABSENT))
             for owner, name, _ in patches]
    for owner, name, wrap in patches:
        setattr(owner, name, wrap(getattr(owner, name)))
    try:
        yield
    finally:
        for owner, name, old in reversed(saved):
            if old is _ABSENT:
                delattr(owner, name)
            else:
                setattr(owner, name, old)


#: a sequential SSD scan (``kernels.ref.ssd_recurrence``) of at most this
#: many steps is traced step by step, a longer one in closed form
STEPWISE_MAX = 8


def _repeat(items, times) -> list:
    return [t for t, n in zip(items, times) for _ in range(n)]


class _Unbind(torch.autograd.Function):
    """``t.unbind(1)``'s views at ``picks``, the steps a closed-form scan
    runs.  Its backward is the stepwise scan's ``UnbindBackward``: one
    stack of every step's gradient, each pick's standing for ``times``
    steps."""

    @staticmethod
    def forward(ctx, t, picks, times):
        ctx.times = times
        views = t.unbind(1)
        return tuple(views[i] for i in picks)

    @staticmethod
    def backward(ctx, *grads):
        return torch.stack(_repeat(grads, ctx.times), 1), None, None


class _Stack(torch.autograd.Function):
    """The stepwise scan's ``torch.stack(ys, 1)`` of every step's output,
    each of ``ys`` standing for ``times`` steps; its backward gives each
    the first of its steps' gradient rows (views, as ``StackBackward``)."""

    @staticmethod
    def forward(ctx, times, *ys):
        ctx.starts = [sum(times[:j]) for j in range(len(times))]
        return torch.stack(_repeat(ys, times), 1)

    @staticmethod
    def backward(ctx, g):
        return (None, *(g.select(1, i) for i in ctx.starts))


def _step_nodes(outs, known: set) -> list:
    """The autograd nodes behind ``outs`` that are not in ``known`` (nor
    behind one of them); added to ``known``."""
    todo = [t.grad_fn for t in outs if t.grad_fn is not None]
    found = []
    while todo:
        node = todo.pop()
        if node is None or node in known:
            continue
        known.add(node)
        found.append(node)
        todo.extend(n for n, _ in node.next_functions)
    return found


class _Window:
    """The backward of a closed-form scan's middle step, standing for
    ``times`` steps: its nodes' ops counted ``times`` over, from its first
    node to the first node of the step before it; the storages it leaves
    alive past that step (its steps' input gradients, held for the
    stack) counted ``times`` over from the step before that."""

    def __init__(self, counter: Counter, times: int):
        self.counter, self.times = counter, times
        self.state = "idle"
        self.scale = self.mark = self.born = None

    def open(self, *_):
        if self.state == "idle":
            self.state = "open"
            self.scale = self.counter.scale
            self.counter.scale = self.times
            self.mark = self.counter.serial

    def close(self, *_):
        if self.state == "open":
            self.state = "closed"
            self.counter.scale = self.scale
            self.born = self.counter.alive_since(self.mark)

    def settle(self, *_):
        self.close()
        if self.state == "closed":
            self.state = "settled"
            self.counter.reweight(self.born, self.times)


def _closed_recurrence(counter: Counter, stepwise):
    """``kernels.ref.ssd_recurrence`` as the trace counts it: on ``meta``
    tensors past ``STEPWISE_MAX`` steps, five of its steps, the middle one
    standing for the other L - 4 (its ops counted L - 4 times over, the
    storages it leaves alive, such as its output row and the states
    autograd saves, counted L - 4 times over once the next step has shown
    which outlive it; likewise in the backward).  The first two and last
    two run as they are, since the first and last steps differ (no
    gradient to the initial state; none from the final state's next
    step) and a step's neighbours set what it frees.  The prologue (the
    per-step factors, formed for all steps at once) and the stack of the
    outputs run at full size; what the steps unbind and stack goes
    through :class:`_Unbind` and :class:`_Stack`, whose ops and backward
    are the stepwise scan's.  So every count equals the stepwise trace's
    (``tests/test_torch_dryrun_trace.py``)."""

    def run(x, dt, A, B, C, h=None):
        L = x.shape[1]
        if x.device.type != "meta" or L <= STEPWISE_MAX:
            counter.scans.append([L, "stepwise"])
            return stepwise(x, dt, A, B, C, h)
        counter.scans.append([L, "closed form"])
        # ref.ssd_recurrence's own ops from here to the stack
        Bb, _, H, P = x.shape
        N = B.shape[-1]
        if h is None:
            h = torch.zeros((Bb, H, P, N), dtype=torch.float32,
                            device=x.device)
        dtf = dt.float()
        decay = torch.exp(A.float()[None, None, :] * dtf)
        dtx = dtf[..., None] * x.float()
        Bf, Cf = B.float(), C.float()
        mid = L - 4
        picks, times = (0, 1, 2, L - 2, L - 1), (1, 1, mid, 1, 1)
        unbound = [_Unbind.apply(t, picks, times)
                   for t in (dtx, decay, Bf, Cf)]
        window = _Window(counter, mid)
        # the steps' nodes end at the unbinds' and the initial state's
        known = {t.grad_fn for t in (h, *(u[0] for u in unbound))
                 if t.grad_fn is not None}
        for node in known:
            node.register_prehook(window.settle)
        steps = zip(*unbound)
        ys = []
        for j, (dtx_t, dec_t, B_t, C_t) in enumerate(steps):
            if j == 2:
                scale, counter.scale = counter.scale, mid
                mark = counter.serial
            upd = dtx_t[..., None] * B_t[:, None, None, :]
            h = h * dec_t[..., None, None] + upd
            ys.append(torch.einsum("bhpn,bn->bhp", h, C_t))
            if j == 2:
                counter.scale = scale
                born = counter.alive_since(mark)
            elif j == 3:
                counter.reweight(born, mid)
            hook = {0: window.settle, 1: window.close, 2: window.open}.get(j)
            for node in _step_nodes((h, ys[-1]), known):
                if hook is not None:
                    node.register_prehook(hook)
        return _Stack.apply(times, *ys), h

    return run


@contextlib.contextmanager
def counting(counter: Counter):
    """``counter`` on, with DTensor's sharding propagation and shard
    bookkeeping kept out of it, a shard-to-shard redistribution run as
    the all-to-all it is on the card (``_dtensor::shard_dim_alltoall``,
    whose meta kernel gives the shape) where a CPU group would gather and
    chunk, and a long sequential SSD scan traced in closed form."""
    from torch.distributed._functional_collectives import \
        _resolve_group_name
    from torch.distributed.tensor import DTensor, placement_types

    from ..kernels import ref

    def quiet(fn):
        def run(*args, **kwargs):
            with counter.quiet():
                return fn(*args, **kwargs)
        return run

    def card_alltoall(_):
        def run(input, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                _resolve_group_name((mesh, mesh_dim)))
        return run

    prop = DTensor._op_dispatcher.sharding_propagator
    with _patched([(prop, "propagate_op_sharding", quiet),
                   (prop, "propagate_op_sharding_non_cached", quiet),
                   (prop, "_propagate_tensor_meta_non_cached", quiet),
                   # a strided shard's index bookkeeping (real index
                   # vectors of one dimension's length)
                   (placement_types._StridedShard,
                    "local_shard_size_and_offset", quiet),
                   (placement_types, "shard_dim_alltoall", card_alltoall),
                   (ref, "ssd_recurrence",
                    lambda fn: _closed_recurrence(counter, fn))]):
        with counter:
            yield counter


def collective_stats(counter: Counter) -> dict:
    """The reference's ``collective_stats`` layout: ``{kind: {count,
    bytes}}`` for each kind seen, and ``total_bytes``."""
    stats = {k: dict(counter.collectives[k]) for k in KINDS
             if k in counter.collectives}
    stats["total_bytes"] = sum(v["bytes"] for v in stats.values())
    return stats


def form_fake_group(world: int) -> None:
    """Join a fake process group of ``world`` ranks as rank 0.  Raises
    where a process group is formed already: a trace never runs beside a
    real group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is formed already; the trace "
                           "runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(sizes, names):
    """A ``DeviceMesh`` of ``sizes`` over the first ranks of the fake
    group (``cpu``-typed: no card is touched)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(sizes)
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(sizes)),
                      mesh_dim_names=tuple(names))


def _local_leaves(tree_) -> list:
    from .. import tree
    from ..parallel.api import is_distributed

    return [t.to_local() if is_distributed(t) else t
            for t in _tensors(tree.leaves(tree_))]


def _run_step(cfg, shape, mesh, placed: dict):
    """The cell's step on the placed arguments through the plain route (a
    train step donating them), under the reference's activation rules
    (``n_moe_groups``: tokens over the MoE group size for train and
    prefill, the batch for decode)."""
    from ..parallel.api import sharding_rules
    from ..parallel.sharding import activation_rules
    from ..serve.decode import decode_step, prefill
    from ..train.step import TrainConfig, make_train_step
    from .dryrun import _opt_config

    B, S = shape.global_batch, shape.seq_len
    T = B if shape.kind == "decode" else B * S
    rules = activation_rules(cfg, mesh, n_moe_groups=T // min(
        cfg.moe_group_size, T))
    batch = dict(placed["batch"])
    with sharding_rules(rules):
        if shape.kind == "train":
            step_fn, _ = make_train_step(
                cfg, TrainConfig(opt=_opt_config(cfg)), use_kernel=False,
                donate=True)
            return step_fn(placed["weights"], placed["optimizer"], batch)
        tokens = batch.pop("tokens")
        if shape.kind == "prefill":
            return prefill(cfg, placed["weights"], placed["cache"], tokens,
                           use_kernel=False, **batch)
        # the step at the cache's last position, as the card's run of the
        # cell takes it
        return decode_step(cfg, placed["weights"], placed["cache"], tokens,
                           S - 1, use_kernel=False)


def scan_steps(cfg, shape) -> int:
    """The steps of each SSD layer's sequential scan in the cell's step on
    the plain route: its recurrence over the prompt at prefill (one step
    at decode), or its sequential scan over the sequence at train unless
    the chunked form applies (``ssd_chunk``); 0 without one."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    S = 1 if shape.kind == "decode" else shape.seq_len
    if shape.kind == "train" and (
            cfg.ssd_chunk and S % cfg.ssd_chunk == 0 and S > cfg.ssd_chunk):
        return 0
    return S


def trace_cell(cfg, shape, mesh) -> dict:
    """Trace one cell's step on ``mesh`` (a ``DeviceMesh`` over a fake
    group): ``{"memory", "cost", "collectives", "trace_s", "route",
    "largest_real_bytes"}`` per device."""
    from ..parallel.sharding import allocate
    from .dryrun import _arg_specs, _cell_args

    args = _cell_args(cfg, shape)
    specs = _arg_specs(cfg, mesh, args)
    placed = {role: allocate(args[role], specs[role], mesh, "meta",
                             fill=None) for role in args}
    held = _local_leaves(placed)
    counter = Counter(held)
    t0 = time.perf_counter()
    with counting(counter):
        out = _run_step(cfg, shape, mesh, placed)
    trace_s = time.perf_counter() - t0
    arg_keys = {_storage_key(t) for t in held}
    outs = _local_leaves(out)
    memory = {
        "argument_size_in_bytes": sum(_nbytes(t) for t in held),
        "output_size_in_bytes": sum(_nbytes(t) for t in outs),
        "alias_size_in_bytes": sum(_nbytes(t) for t in outs
                                   if _storage_key(t) in arg_keys),
        "temp_size_in_bytes": counter.peak}
    rec = {"route": "plain", "memory": memory,
           "cost": {"flops": float(counter.flops),
                    "transcendentals": float(counter.transcendentals),
                    "bytes accessed": float(counter.bytes_accessed)},
           "bytes_accessed_is": "unfused: an upper bound on a fused "
                                "compile's",
           "collectives": collective_stats(counter),
           "largest_real_bytes": counter.largest_real,
           "trace_s": trace_s}
    if counter.scans:
        rec["scan"] = {
            "steps_per_layer": scan_steps(cfg, shape),
            "layers": cfg.n_layers, "traced_calls": len(counter.scans),
            "counted": sorted({how for _, how in counter.scans})}
        rec["flops_are"] = ("per step x steps: every step of the "
                            "sequential scans counted (XLA's cost "
                            "analysis counts a scan's body once)")
    return rec


def shape_of(spec):
    """A cell's shape: a name in ``SHAPES``, or ``[kind, batch, seq_len]``
    for a step of another size (the card's own runs)."""
    from ..configs.base import SHAPES, ShapeConfig

    if isinstance(spec, str):
        return SHAPES[spec]
    kind, batch, seq = spec
    return ShapeConfig(f"{kind}_{batch}x{seq}", int(seq), int(batch), kind)


def trace_jobs(jobs: list):
    """Trace each ``(arch, shape, sizes, names, smoke)`` job in this
    process, which forms the fake group over the largest mesh (``shape``
    as :func:`shape_of` takes it); yields ``(job, record)``, the record
    ``status: "error"`` with its message where the trace failed."""
    from ..configs.base import get_config

    form_fake_group(max(math.prod(j[2]) for j in jobs))
    for job in jobs:
        arch, shape_name, sizes, names, smoke = job
        try:
            cfg = get_config(arch)
            cfg = cfg.smoke() if smoke else cfg
            rec = trace_cell(cfg, shape_of(shape_name),
                             fake_mesh(sizes, names))
            rec["status"] = "ok"
        except Exception as e:  # noqa: BLE001 - recorded, as in the reference
            rec = {"status": "error", "error": f"{type(e).__name__}: {e}"}
        yield job, rec


def start(cells: list, mesh: str | None = None, sizes=None, names=None,
          nice: int = 0) -> subprocess.Popen:
    """This module run over ``cells`` (``[arch, shape]`` pairs, as
    ``--cells`` takes them) on the production ``mesh``, or on a mesh of
    ``sizes`` named ``names``, in a process of its own at ``nice``
    priority; :func:`collect` reads it."""
    where = (["--mesh", mesh] if sizes is None else
             ["--sizes", json.dumps(list(sizes)), "--names",
              json.dumps(list(names))])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(Path(__file__).resolve().parents[2])]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.trace", *where,
         "--cells", json.dumps(cells)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        preexec_fn=(lambda: os.nice(nice)) if nice else None)


def collect(proc: subprocess.Popen, cells: list,
            timeout: float | None = None) -> list:
    """The record of each of ``cells`` from :func:`start`'s ``proc``, in
    their order, without the ``arch``, ``shape`` and ``mesh`` it printed;
    a cell the process left unrecorded (it failed, or passed ``timeout``
    seconds and was killed) has ``status: "error"`` and the process's
    exit code and errors."""
    try:
        out, err = proc.communicate(timeout=timeout)
        why = f"the trace process exited {proc.returncode}"
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        why = f"the trace process passed its {timeout} s and was killed"
    got = {}
    for line in out.splitlines():
        if line.startswith("{"):
            r = json.loads(line)
            r.pop("mesh", None)
            got[(r.pop("arch"), json.dumps(r.pop("shape")))] = r
    return [got.get((a, json.dumps(s)), {
        "status": "error", "error": f"{why}: {err[-2000:]}"})
        for a, s in cells]


def main(argv=None) -> int:
    from .dryrun import MESHES
    from .mesh import make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True,
                    help='JSON list of [arch, shape] pairs, a shape a name '
                         'or [kind, batch, seq_len]')
    ap.add_argument("--mesh", default="single", choices=sorted(MESHES),
                    help="the production mesh")
    ap.add_argument("--sizes", default=None,
                    help="JSON mesh shape in place of the production one, "
                         'with --names (e.g. "[4, 2]")')
    ap.add_argument("--names", default=None)
    args = ap.parse_args(argv)
    if args.sizes:
        sizes = json.loads(args.sizes)
        names = json.loads(args.names)
    else:
        m = make_production_mesh(multi_pod=MESHES[args.mesh])
        sizes, names = [m.shape[a] for a in m.axis_names], m.axis_names
    jobs = [(a, s, list(sizes), list(names), False)
            for a, s in json.loads(args.cells)]
    for job, rec in trace_jobs(jobs):
        print(json.dumps({"arch": job[0], "shape": job[1],
                          "mesh": args.mesh, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
