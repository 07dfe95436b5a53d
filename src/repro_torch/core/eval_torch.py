"""Bit-parallel netlist evaluation in PyTorch (the port of
``repro/core/eval_jax.py``).

Width-bucketed fused engine
---------------------------
The netlist is lowered once (per content digest) to the functional
:class:`~repro_torch.core.circuit_ir.CircuitIR` and compiled into a
:class:`FusedPlan`: the level sequence is cut into at most
``max_buckets`` contiguous width buckets by the shared padded-volume DP
(:func:`repro_torch.core.plan.segment_levels`), each padded only to its
own envelope ``[l_b, M_b, 6]`` / ``[l_b, C_b, B_b]``.  The plan's numpy
arrays equal the reference's.

Evaluation walks the buckets in order and, per level:

* gathers the level's LUT input lanes from the value buffer
  (``vals[ins]`` -> ``[M, 6, N]``), runs one ``lut_eval6`` call — the CUDA
  kernel on the card — and ``index_copy_``\\ s the outputs back;
* ripples the level's stacked ``[C, B]`` carry chains as a Python loop
  over the bit positions, in torch ops (the reference ripples in plain
  jnp too; a fused kernel for it is a later, optional slice);
* padded rows read constant-0 lanes and write a reserved sink row.

The value buffer is updated in place, which the reference obtains by
donating its buffer to the jit.  Lanes are int32 bit patterns on the
device and leave as numpy uint32.

Suite-scale batched evaluation
------------------------------
:func:`eval_netlists_batched` clusters plans into compatible-envelope
groups (:func:`repro_torch.core.plan.group_by_envelope`).  The
reference's ``vmap`` over a group becomes an explicit group dimension:
the buffer is ``[G, S + 1, N]``, seen as ``[G * (S + 1), N]`` with every
member's signal indices offset by its row block, so one level of the
whole group is one gather to ``[G * M, 6, N]`` and one kernel launch.

The seed per-level dispatcher survives as :func:`eval_netlist_levels`,
the baseline the fused engine is measured against: one ``lut_eval`` call
per level (two plus a select for 6-input levels) and one ripple per
chain.  The reference's jit-cache bookkeeping has no counterpart: eager
torch compiles nothing per shape.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from . import plan as _planner
from .circuit_ir import CircuitIR, levelize, lower_netlist_ir
from .netlist import CONST0, CONST1, Netlist
from .plan import segment_levels

DEFAULT_MAX_BUCKETS = 3
DEFAULT_MAX_GROUPS = 4

_PLAN_CACHE = _planner.register_cache("eval_plans", cap=64)
_GROUP_CACHE = _planner.register_cache("eval_groups", cap=16)


def netlist_digest(net: Netlist) -> str:
    """Content digest of a netlist's structure (the plan-cache key)."""
    return net.content_digest()


def _to_int32(a: np.ndarray) -> np.ndarray:
    """uint32 words as int32 bit patterns (torch has no usable uint32)."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@dataclass
class PlanBucket:
    """One contiguous run of levels padded to its own envelope."""

    n_levels: int
    has_luts: bool
    has_chains: bool
    lut_ins: np.ndarray     # [l, M, 6] int32 (padded pins/rows -> CONST0)
    lut_tt_lo: np.ndarray   # [l, M] uint32
    lut_tt_hi: np.ndarray   # [l, M] uint32
    lut_out: np.ndarray     # [l, M] int32 (padded rows -> sink)
    ch_a: np.ndarray        # [l, C, B] int32
    ch_b: np.ndarray        # [l, C, B] int32
    ch_cin: np.ndarray      # [l, C] int32
    ch_sums: np.ndarray     # [l, C, B] int32 (padded -> sink)
    ch_cout: np.ndarray     # [l, C] int32 (chains without cout -> sink)
    ch_last: np.ndarray     # [l, C] int32 (index of the last real bit)

    def arrays(self):
        return (self.lut_ins, self.lut_tt_lo, self.lut_tt_hi, self.lut_out,
                self.ch_a, self.ch_b, self.ch_cin, self.ch_sums,
                self.ch_cout, self.ch_last)

    @property
    def shape(self) -> tuple[int, int, int, int]:
        """(levels, M, C, B) envelope of this bucket."""
        return (self.n_levels, self.lut_out.shape[1],
                self.ch_cout.shape[1], self.ch_a.shape[2])

    @property
    def padded_lut_rows(self) -> int:
        l, M, _, _ = self.shape
        return l * (M if self.has_luts else 0)

    @property
    def padded_chain_bits(self) -> int:
        l, _, C, B = self.shape
        return l * (C * B if self.has_chains else 0)


@dataclass
class FusedPlan:
    """Width-bucketed level tensors; ``sink = n_signals`` swallows padding."""

    n_signals: int
    n_levels: int
    buckets: tuple[PlanBucket, ...]
    real_luts: int = 0
    real_chain_bits: int = 0
    _dev: dict = field(default_factory=dict, repr=False)

    @property
    def sink(self) -> int:
        return self.n_signals

    @property
    def has_luts(self) -> bool:
        return any(bk.has_luts for bk in self.buckets)

    @property
    def has_chains(self) -> bool:
        return any(bk.has_chains for bk in self.buckets)

    @property
    def flags(self) -> tuple[tuple[bool, bool], ...]:
        """Per-bucket (has_luts, has_chains)."""
        return tuple((bk.has_luts, bk.has_chains) for bk in self.buckets)

    @property
    def envelope(self) -> tuple[int, int, int, int]:
        """The single worst-case (L, M, C, B) envelope (pre-bucketing).
        Dimensions whose side is absent are 0, not the array floor of 1 —
        a pure-LUT circuit must not be charged L phantom chain rows."""
        return (self.n_levels,
                max((bk.shape[1] if bk.has_luts else 0)
                    for bk in self.buckets),
                max((bk.shape[2] if bk.has_chains else 0)
                    for bk in self.buckets),
                max((bk.shape[3] if bk.has_chains else 0)
                    for bk in self.buckets))

    @property
    def padded_lut_rows(self) -> int:
        return sum(bk.padded_lut_rows for bk in self.buckets)

    @property
    def padded_chain_bits(self) -> int:
        return sum(bk.padded_chain_bits for bk in self.buckets)

    def arrays(self):
        return tuple(bk.arrays() for bk in self.buckets)

    def device_buckets(self, device) -> list[_DeviceBucket]:
        """Plan tensors on ``device``, uploaded once per plan and device —
        reusing a plan across calls must not re-transfer its indices."""
        dev = resolve_device(device)
        key = str(dev)
        if key not in self._dev:
            self._dev[key] = _device_buckets([self], self.flags,
                                             self.n_signals + 1, dev)
        return self._dev[key]


def _bucket_from_ir(ir: CircuitIR, i: int, j: int, M: int, C: int, B: int,
                    sink: int) -> PlanBucket:
    """Pad IR levels ``[i, j)`` to the bucket envelope ``[l, M, C, B]``."""
    l = max(j - i, 1)
    has_luts = M > 0
    has_chains = C > 0
    lut_ins = np.full((l, max(M, 1), 6), CONST0, dtype=np.int32)
    lut_tt_lo = np.zeros((l, max(M, 1)), dtype=np.uint32)
    lut_tt_hi = np.zeros((l, max(M, 1)), dtype=np.uint32)
    lut_out = np.full((l, max(M, 1)), sink, dtype=np.int32)
    ch_a = np.full((l, max(C, 1), max(B, 1)), CONST0, dtype=np.int32)
    ch_b = np.full((l, max(C, 1), max(B, 1)), CONST0, dtype=np.int32)
    ch_cin = np.full((l, max(C, 1)), CONST0, dtype=np.int32)
    ch_sums = np.full((l, max(C, 1), max(B, 1)), sink, dtype=np.int32)
    ch_cout = np.full((l, max(C, 1)), sink, dtype=np.int32)
    ch_last = np.zeros((l, max(C, 1)), dtype=np.int32)
    for t in range(i, min(j, ir.n_levels)):
        r = t - i
        ll, cl = ir.lut_levels[t], ir.chain_levels[t]
        m = ll.out.shape[0]
        if m:
            lut_ins[r, :m] = ll.ins
            lut_tt_lo[r, :m] = ll.tt_lo
            lut_tt_hi[r, :m] = ll.tt_hi
            lut_out[r, :m] = ll.out
        c = cl.cout.shape[0]
        if c:
            bb = cl.a_sig.shape[1]
            ch_a[r, :c, :bb] = cl.a_sig
            ch_b[r, :c, :bb] = cl.b_sig
            ch_cin[r, :c] = cl.cin_sig
            s = cl.sums.copy()
            s[s < 0] = sink
            ch_sums[r, :c, :bb] = s
            co = cl.cout.copy()
            co[co < 0] = sink
            ch_cout[r, :c] = co
            ch_last[r, :c] = cl.last
    return PlanBucket(n_levels=l, has_luts=has_luts, has_chains=has_chains,
                      lut_ins=lut_ins, lut_tt_lo=lut_tt_lo,
                      lut_tt_hi=lut_tt_hi, lut_out=lut_out, ch_a=ch_a,
                      ch_b=ch_b, ch_cin=ch_cin, ch_sums=ch_sums,
                      ch_cout=ch_cout, ch_last=ch_last)


def plan_from_ir(ir: CircuitIR,
                 max_buckets: int = DEFAULT_MAX_BUCKETS,
                 n_signals: int | None = None,
                 bounds=None, envelopes=None) -> FusedPlan:
    """Compile a :class:`CircuitIR` (functional or packed — only the
    functional columns are read) into width-bucketed level tensors.  Pass
    ``bounds`` / ``envelopes`` to pad to a shared group layout (suite
    batching)."""
    m, c, b = ir.level_profile()
    if not m:
        m, c, b = [0], [0], [0]
    if bounds is None:
        bounds = segment_levels(m, c, b, max_buckets)
    if envelopes is None:
        envelopes = _planner.bucket_envelopes(m, c, b, bounds)
    if n_signals is None:
        n_signals = ir.n_signals
    sink = n_signals
    buckets = tuple(_bucket_from_ir(ir, i, j, M, C, B, sink)
                    for (i, j), (M, C, B) in zip(bounds, envelopes))
    n_levels = sum(max(j - i, 1) for i, j in bounds) if bounds else 1
    return FusedPlan(
        n_signals=n_signals, n_levels=n_levels, buckets=buckets,
        real_luts=int(sum(lv.out.shape[0] for lv in ir.lut_levels)),
        real_chain_bits=int(sum((lv.sums >= 0).sum()
                                for lv in ir.chain_levels)))


def plan_netlist(net: Netlist,
                 max_buckets: int = DEFAULT_MAX_BUCKETS) -> FusedPlan:
    """Compile a netlist into width-bucketed level tensors (content-cached,
    via the content-cached functional :class:`CircuitIR`)."""
    digest = netlist_digest(net)
    key = (digest, max_buckets)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached
    ir = lower_netlist_ir(net, digest=digest)
    plan = plan_from_ir(ir, max_buckets=max_buckets)
    _PLAN_CACHE.put(key, plan)
    return plan


# ---------------------------------------------------------------------------
# device tensors and the level walk
# ---------------------------------------------------------------------------


@dataclass
class _DeviceBucket:
    """One bucket of one or more stacked members on a device.  Member
    ``g``'s signal indices are offset by ``g * row_stride`` so that the
    stacked buffer ``[G * row_stride, N]`` is addressed like one circuit;
    LUT rows and chains of the members are concatenated."""

    n_levels: int
    has_luts: bool
    has_chains: bool
    lut_ins: torch.Tensor    # [l, G*M, 6] int64
    tt_lo: torch.Tensor      # [l, G*M] int32
    tt_hi: torch.Tensor      # [l, G*M] int32
    lut_out: torch.Tensor    # [l, G*M] int64
    ch_a: torch.Tensor       # [l, G*C, B] int64
    ch_b: torch.Tensor       # [l, G*C, B] int64
    ch_cin: torch.Tensor     # [l, G*C] int64
    ch_sums: torch.Tensor    # [l, G*C, B] int64
    ch_cout: torch.Tensor    # [l, G*C] int64
    ch_last: torch.Tensor    # [l, G*C] int64
    ch_rows: torch.Tensor    # [G*C] int64 (arange, for the cout pick)


def _device_buckets(member_plans: list[FusedPlan], flags, row_stride: int,
                    device: torch.device) -> list[_DeviceBucket]:
    out = []
    for bi, (has_luts, has_chains) in enumerate(flags):
        per = [p.buckets[bi].arrays() for p in member_plans]
        offs = [g * row_stride for g in range(len(member_plans))]

        def sig(ai):  # signal-index array: offset per member, concatenate
            a = np.concatenate([m[ai].astype(np.int64) + o
                                for m, o in zip(per, offs)], axis=1)
            return torch.from_numpy(a).to(device)

        def word(ai):  # table words: uint32 -> int32 bit patterns
            a = np.concatenate([m[ai] for m in per], axis=1)
            return torch.from_numpy(_to_int32(a)).to(device)

        last = np.concatenate([m[9].astype(np.int64) for m in per], axis=1)
        out.append(_DeviceBucket(
            n_levels=per[0][0].shape[0], has_luts=has_luts,
            has_chains=has_chains, lut_ins=sig(0), tt_lo=word(1),
            tt_hi=word(2), lut_out=sig(3), ch_a=sig(4), ch_b=sig(5),
            ch_cin=sig(6), ch_sums=sig(7), ch_cout=sig(8),
            ch_last=torch.from_numpy(last).to(device),
            ch_rows=torch.arange(last.shape[1], device=device)))
    return out


def _ripple(vals: torch.Tensor, bk: _DeviceBucket, r: int) -> None:
    """Ripple level ``r``'s stacked chains and scatter sums and couts."""
    av = vals[bk.ch_a[r]]                            # [C, B, N]
    bv = vals[bk.ch_b[r]]
    c = vals[bk.ch_cin[r]]                           # [C, N]
    C, B, N = av.shape
    ss = torch.empty_like(av)
    cys = torch.empty_like(av)
    for bi in range(B):
        a, b = av[:, bi], bv[:, bi]
        x = a ^ b
        ss[:, bi] = x ^ c
        c = (a & b) | (c & x)
        cys[:, bi] = c
    vals.index_copy_(0, bk.ch_sums[r].reshape(-1), ss.reshape(C * B, N))
    # cout is the carry *after the chain's last real bit* — padded tail
    # bits add 0+0 and would zero the carry, so index, don't take last
    vals.index_copy_(0, bk.ch_cout[r], cys[bk.ch_rows, bk.ch_last[r]])


def _run_buckets(vals: torch.Tensor, buckets: list[_DeviceBucket],
                 use_kernel: bool) -> None:
    """Walk the buckets in topological order, updating ``vals[R, N]`` in
    place (the reference donates its buffer to the jit for the same
    effect): per level, gather -> ``lut_eval6`` -> scatter, then the
    stacked chain ripple."""
    for bk in buckets:
        for r in range(bk.n_levels):
            if bk.has_luts:
                gathered = vals[bk.lut_ins[r]]       # [M, 6, N]
                out = ops.lut_eval6(gathered, bk.tt_lo[r], bk.tt_hi[r],
                                    use_kernel=use_kernel)
                vals.index_copy_(0, bk.lut_out[r], out)
            if bk.has_chains:
                _ripple(vals, bk, r)


def _init_vals(n_members: int, n_rows: int, pi_lanes_list,
               n_lane_words: int, device: torch.device) -> torch.Tensor:
    """Value buffer ``[n_members * n_rows, N]`` int32: CONST1 all-ones,
    PI rows from the uint32 lanes, everything else 0."""
    vals = np.zeros((n_members, n_rows, n_lane_words), dtype=np.uint32)
    vals[:, CONST1] = 0xFFFFFFFF
    for row, lanes in enumerate(pi_lanes_list):
        for s, v in lanes.items():
            vals[row, s] = np.asarray(v, dtype=np.uint32)
    flat = vals.reshape(n_members * n_rows, n_lane_words)
    return torch.from_numpy(flat.view(np.int32)).to(device)


def _to_uint32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def eval_netlist_fused(net: Netlist, pi_lanes: dict[int, np.ndarray],
                       n_lane_words: int, use_kernel: bool = True,
                       plan: FusedPlan | None = None,
                       device=None) -> np.ndarray:
    """Fused evaluation; returns ``vals[n_signals, n_lane_words]`` uint32
    (the counterpart of the reference's ``eval_netlist_jax``).

    ``pi_lanes[signal]`` is a uint32 vector of packed test vectors.  Pass
    a precompiled ``plan`` to skip the content-digest cache lookup.
    """
    dev = resolve_device(device)
    if plan is None:
        plan = plan_netlist(net)
    vals = _init_vals(1, plan.n_signals + 1, [pi_lanes], n_lane_words, dev)
    _run_buckets(vals, plan.device_buckets(dev), use_kernel)
    return _to_uint32(vals[:plan.n_signals])


# ---------------------------------------------------------------------------
# envelope-grouped suite evaluation
# ---------------------------------------------------------------------------


def group_plans_by_envelope(plans, max_groups: int = DEFAULT_MAX_GROUPS,
                            signal_weight: float = 1.0) -> list[list[int]]:
    """Cluster plans (or any ``.envelope`` / ``.n_signals`` carriers, e.g.
    :class:`CircuitIR`) into <= ``max_groups`` compatible-envelope groups
    — delegated to the shared planner
    (:func:`repro_torch.core.plan.group_by_envelope`)."""
    return _planner.group_by_envelope(plans, max_groups=max_groups,
                                      signal_weight=signal_weight)


def grouping_padded_value_rows(plans, groups: list[list[int]]) -> dict:
    """Value-buffer padding accounting for a grouping: every member is
    padded to its group's largest ``n_signals``."""
    real = sum(p.n_signals for p in plans)
    padded = sum(len(g) * max(plans[i].n_signals for i in g) for g in groups)
    return {"real_rows": real, "padded_rows": padded,
            "waste": 1.0 - real / max(padded, 1)}


def group_layout(irs, max_buckets: int = DEFAULT_MAX_BUCKETS):
    """Shared padded layout of one envelope group: combined width profile,
    bucket bounds, envelopes and the per-member padded row volume.  Used
    by the group builder below and by the flow's grouped-vs-per-circuit
    cost model without building any device tensors."""
    L = max((ir.n_levels for ir in irs), default=0)
    if L == 0:
        L = 1
    m, c, b = _planner.combined_profile([ir.level_profile() for ir in irs],
                                        L)
    bounds = segment_levels(m, c, b, max_buckets)
    envelopes = _planner.bucket_envelopes(m, c, b, bounds)
    return {"bounds": bounds, "envelopes": envelopes,
            "rows_per_member": _planner.padded_rows(bounds, envelopes)}


@dataclass
class GroupProgram:
    """One envelope group: the member plans padded to the group layout
    (sharing the value-buffer height ``n_signals``), the per-bucket flags,
    and the stacked device tensors per device."""

    n_signals: int
    flags: tuple[tuple[bool, bool], ...]
    member_plans: list[FusedPlan]
    _dev: dict = field(default_factory=dict, repr=False)

    def device_buckets(self, device: torch.device) -> list[_DeviceBucket]:
        key = str(device)
        if key not in self._dev:
            self._dev[key] = _device_buckets(self.member_plans, self.flags,
                                             self.n_signals + 1, device)
        return self._dev[key]


def _build_group(nets: list[Netlist], max_buckets: int) -> GroupProgram:
    """Pad one envelope group's members to the group layout.

    Bucket boundaries are recomputed on the group's combined width profile
    and every member is padded to the group envelope; each member's sink
    rows point at its own ``n_sig`` row.
    """
    irs = [lower_netlist_ir(net) for net in nets]
    n_sig = max(net.n_signals for net in nets)
    layout = group_layout(irs, max_buckets=max_buckets)
    bounds, envelopes = layout["bounds"], layout["envelopes"]
    member_plans = [
        plan_from_ir(ir, n_signals=n_sig, bounds=bounds,
                     envelopes=envelopes)
        for ir in irs]
    flags = tuple(
        (any(p.buckets[bi].has_luts for p in member_plans),
         any(p.buckets[bi].has_chains for p in member_plans))
        for bi in range(len(bounds)))
    return GroupProgram(n_signals=n_sig, flags=flags,
                        member_plans=member_plans)


def get_group_program(nets: list[Netlist],
                      max_buckets: int = DEFAULT_MAX_BUCKETS
                      ) -> GroupProgram:
    """Cached group layout (and its device tensors) for one envelope group
    of netlists."""
    key = (tuple(netlist_digest(net) for net in nets), max_buckets)
    cached = _GROUP_CACHE.get(key)
    if cached is None:
        cached = _build_group(nets, max_buckets)
        _GROUP_CACHE.put(key, cached)
    return cached


@dataclass
class SuiteProgram:
    """A suite's clustering + stacked device tensors, prepared once.

    ``run`` evaluates new lanes without re-digesting, re-clustering or
    re-uploading anything — the handle benchmark loops should reuse.
    """

    n_signals: list[int]          # per input circuit
    names: list[str]
    groups: list[list[int]]       # member indices per envelope group
    programs: list[GroupProgram]
    stats: dict
    device: torch.device

    def run(self, pi_lanes_list: list[dict[int, np.ndarray]],
            n_lane_words: int, use_kernel: bool = True) -> list[np.ndarray]:
        outs: list = [None] * len(self.n_signals)
        for members, prog in zip(self.groups, self.programs):
            rows = prog.n_signals + 1
            vals = _init_vals(len(members), rows,
                              [pi_lanes_list[i] for i in members],
                              n_lane_words, self.device)
            _run_buckets(vals, prog.device_buckets(self.device), use_kernel)
            # the copy to the host waits for the device: timing loops over
            # run() measure execution, not dispatch
            out = _to_uint32(vals).reshape(len(members), rows, n_lane_words)
            for row, i in enumerate(members):
                outs[i] = out[row, :self.n_signals[i]]
        return outs


def prepare_suite_program(nets: list[Netlist],
                          max_groups: int = DEFAULT_MAX_GROUPS,
                          max_buckets: int = DEFAULT_MAX_BUCKETS,
                          plans: list[FusedPlan] | None = None,
                          groups: list[list[int]] | None = None,
                          device=None) -> SuiteProgram:
    """Cluster a suite into <= ``max_groups`` compatible-envelope groups and
    build (or fetch from the content cache) each group's stacked tensors
    on ``device``.  Pass precomputed ``plans``/``groups`` (e.g. from a
    cost-model pass) to skip re-planning and the O(n^2) clustering."""
    dev = resolve_device(device)
    if plans is None:
        plans = [plan_netlist(net, max_buckets=max_buckets) for net in nets]
    if groups is None:
        groups = group_plans_by_envelope(plans, max_groups=max_groups)
    programs = [get_group_program([nets[i] for i in members],
                                  max_buckets=max_buckets)
                for members in groups]
    stats = {"n_groups": len(groups), "groups": []}
    for members, prog in zip(groups, programs):
        prog.device_buckets(dev)
        gp = prog.member_plans[0]
        stats["groups"].append({
            "members": [nets[i].name for i in members],
            "n_buckets": len(gp.buckets),
            "bucket_shapes": [bk.shape for bk in gp.buckets],
            "padded_lut_rows": gp.padded_lut_rows * len(members),
            "padded_chain_bits": gp.padded_chain_bits * len(members),
        })
    return SuiteProgram(n_signals=[p.n_signals for p in plans],
                        names=[net.name for net in nets],
                        groups=groups, programs=programs, stats=stats,
                        device=dev)


def eval_netlists_batched(nets: list[Netlist],
                          pi_lanes_list: list[dict[int, np.ndarray]],
                          n_lane_words: int,
                          use_kernel: bool = True,
                          max_groups: int = DEFAULT_MAX_GROUPS,
                          max_buckets: int = DEFAULT_MAX_BUCKETS,
                          return_stats: bool = False,
                          program: SuiteProgram | None = None,
                          device=None):
    """Evaluate a suite of circuits group by group (one kernel launch per
    level of each envelope group).

    ``max_groups=1, max_buckets=1`` reproduces the single-worst-case-
    envelope layout.  Pass a prepared ``program`` to skip clustering and
    uploads in hot loops (its device wins over ``device``).  Returns
    per-circuit ``vals`` arrays in input order (plus a stats record when
    ``return_stats``).
    """
    if program is None:
        program = prepare_suite_program(nets, max_groups=max_groups,
                                        max_buckets=max_buckets,
                                        device=device)
    outs = program.run(pi_lanes_list, n_lane_words, use_kernel=use_kernel)
    if return_stats:
        return outs, program.stats
    return outs


# ---------------------------------------------------------------------------
# seed per-level dispatcher (perf baseline)
# ---------------------------------------------------------------------------


def eval_netlist_levels(net: Netlist, pi_lanes: dict[int, np.ndarray],
                        n_lane_words: int, use_kernel: bool = True,
                        device=None) -> np.ndarray:
    """The pre-fusion evaluator: one Python-dispatched ``lut_eval`` call
    per LUT level (two plus a select for a 6-input level) and one ripple
    per chain.  Kept as the measured baseline for the fused engine.
    Returns ``vals[n_signals, n_lane_words]`` uint32."""
    dev = resolve_device(device)
    by_luts, by_chains, _ = levelize(net)
    levels = sorted(set(by_luts) | set(by_chains))

    vals = np.zeros((net.n_signals, n_lane_words), dtype=np.uint32)
    vals[CONST1] = 0xFFFFFFFF
    for s, v in pi_lanes.items():
        vals[s] = np.asarray(v, dtype=np.uint32)
    vals = torch.from_numpy(vals.view(np.int32)).to(dev)

    def idx(seq) -> torch.Tensor:
        return torch.as_tensor(np.asarray(seq, dtype=np.int64), device=dev)

    def words(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(_to_int32(a.astype(np.uint32))).to(dev)

    for lv in levels:
        ids = by_luts.get(lv)
        if ids:
            kmax = max(1, max(len(net.lut_inputs[i]) for i in ids))
            ins = np.zeros((len(ids), kmax), dtype=np.int64)
            tts = np.zeros(len(ids), dtype=np.uint64)
            outs = np.zeros(len(ids), dtype=np.int64)
            for r, i in enumerate(ids):
                sig_ins = net.lut_inputs[i]
                k = len(sig_ins)
                ins[r, :k] = sig_ins
                tt = net.lut_tt[i]
                full = 0
                for rr in range(1 << (kmax - k)):
                    full |= tt << (rr * (1 << k))
                tts[r] = full & ((1 << min(64, 1 << kmax)) - 1)
                outs[r] = net.lut_out[i]
            gathered = vals[idx(ins)]
            if kmax <= 5:
                out = ops.lut_eval(gathered, words(tts),
                                   use_kernel=use_kernel)
            else:
                tt_lo = words(tts & np.uint64(0xFFFFFFFF))
                tt_hi = words(tts >> np.uint64(32))
                g5 = gathered[:, :5, :].contiguous()
                sel = gathered[:, 5, :]
                lo = ops.lut_eval(g5, tt_lo, use_kernel=use_kernel)
                hi = ops.lut_eval(g5, tt_hi, use_kernel=use_kernel)
                out = (sel & hi) | (~sel & lo)
            vals.index_copy_(0, idx(outs), out)
        for ci in by_chains.get(lv, ()):
            ch = net.chains[ci]
            av = vals[idx(ch.a)]
            bv = vals[idx(ch.b)]
            c = vals[ch.cin]
            ss = torch.empty_like(av)
            for bi in range(av.shape[0]):
                x = av[bi] ^ bv[bi]
                ss[bi] = x ^ c
                c = (av[bi] & bv[bi]) | (c & x)
            vals.index_copy_(0, idx(ch.sums), ss)
            if ch.cout is not None:
                vals[ch.cout] = c
    return _to_uint32(vals)
