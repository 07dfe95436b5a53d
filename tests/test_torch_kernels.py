"""The port's LUT kernels' plain versions (and their dispatch on CPU
tensors) against the JAX package's oracles and Pallas kernels (interpret
mode), bit for bit.  The CUDA kernels themselves run only on the card,
where ``chip_smoke.py`` holds them to these plain versions."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref


def rng(seed=0):
    return np.random.default_rng(seed)


def t32(a: np.ndarray) -> torch.Tensor:
    """uint32 words -> int32 bit-pattern tensor on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("m,k,nlanes", [(8, 2, 4), (64, 3, 16), (300, 4, 8),
                                        (1000, 5, 2)])
def test_lut_eval_matches_reference(m, k, nlanes):
    r = rng(m + k)
    ins = r.integers(0, 2**32, size=(m, k, nlanes), dtype=np.uint32)
    tts = r.integers(0, 2**(2**k), size=(m,),
                     dtype=np.uint64).astype(np.uint32) \
        if k < 5 else r.integers(0, 2**32, size=(m,), dtype=np.uint32)
    want = np.asarray(jref.lut_eval_ref(jnp.asarray(ins), jnp.asarray(tts)))
    want_pallas = np.asarray(jops.lut_eval(jnp.asarray(ins),
                                           jnp.asarray(tts)))
    assert np.array_equal(want, want_pallas)
    got = u32(ref.lut_eval_ref(t32(ins), t32(tts)))
    assert np.array_equal(got, want)
    assert np.array_equal(u32(ops.lut_eval(t32(ins), t32(tts))), want)


def test_lut_eval_known_functions():
    # AND2 / XOR2 bit-parallel
    ins = np.zeros((2, 2, 1), dtype=np.uint32)
    ins[:, 0, 0] = 0b1100
    ins[:, 1, 0] = 0b1010
    tts = np.array([0b1000, 0b0110], dtype=np.uint32)  # AND2, XOR2
    got = u32(ops.lut_eval(t32(ins), t32(tts)))
    assert got[0, 0] == 0b1000
    assert got[1, 0] == 0b0110
    want = np.asarray(jops.lut_eval(jnp.asarray(ins), jnp.asarray(tts)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("m,nlanes", [(8, 4), (300, 8), (513, 2)])
def test_lut_eval6_matches_reference(m, nlanes):
    r = rng(m * 7)
    ins = r.integers(0, 2**32, size=(m, 6, nlanes), dtype=np.uint32)
    tt_lo = r.integers(0, 2**32, size=(m,), dtype=np.uint32)
    tt_hi = r.integers(0, 2**32, size=(m,), dtype=np.uint32)
    tt_hi[::3] = tt_lo[::3]   # narrower LUTs replicate their table
    args = [jnp.asarray(a) for a in (ins, tt_lo, tt_hi)]
    want = np.asarray(jref.lut_eval6_ref(*args))
    assert np.array_equal(want, np.asarray(jops.lut_eval6(*args)))
    targs = [t32(a) for a in (ins, tt_lo, tt_hi)]
    assert np.array_equal(u32(ref.lut_eval6_ref(*targs)), want)
    assert np.array_equal(u32(ops.lut_eval6(*targs)), want)


def test_lut_eval6_shannon_select():
    # pin5 selects between the lo/hi table words: table = XOR2 in lo,
    # AND2 in hi, pin5 toggling per lane bit
    ins = np.zeros((1, 6, 1), dtype=np.uint32)
    ins[0, 0, 0] = 0b1100
    ins[0, 1, 0] = 0b1010
    ins[0, 5, 0] = 0b0011  # vector bits 0-1 read hi, bits 2-3 read lo
    lo = np.array([0x66666666], dtype=np.uint32)  # XOR2 replicated
    hi = np.array([0x88888888], dtype=np.uint32)  # AND2 replicated
    got = u32(ops.lut_eval6(t32(ins), t32(lo), t32(hi)))
    # bits 2,3 (lo): XOR2(1,0)=1, XOR2(1,1)=0; bits 0,1 (hi): AND2=0
    assert got[0, 0] == 0b0100
    want = np.asarray(jops.lut_eval6(jnp.asarray(ins), jnp.asarray(lo),
                                     jnp.asarray(hi)))
    assert np.array_equal(got, want)


def test_cpu_dispatch_counts_no_launches():
    """A CPU tensor takes the plain version, whatever ``use_kernel`` says,
    and the launch counters move only where a kernel launches."""
    r = rng(1)
    ins = t32(r.integers(0, 2**32, size=(5, 6, 3), dtype=np.uint32))
    tt = t32(r.integers(0, 2**32, size=(5,), dtype=np.uint32))
    before = ops.launch_counts()
    for use_kernel in (True, False):
        ops.lut_eval6(ins, tt, tt, use_kernel=use_kernel)
        ops.lut_eval(ins[:, :5].contiguous(), tt, use_kernel=use_kernel)
    assert ops.launch_counts() == before


def test_cuda_launchers_refuse_host_tensors():
    """The kernel launchers take CUDA tensors only; they raise rather than
    fall back."""
    from repro_torch.kernels.lut_eval import lut_eval6_cuda, lut_eval_cuda

    ins = torch.zeros((2, 6, 4), dtype=torch.int32)
    tt = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        lut_eval6_cuda(ins, tt, tt)
    with pytest.raises(ValueError):
        lut_eval_cuda(ins[:, :5].contiguous(), tt)


def test_plain_versions_reject_bad_widths():
    with pytest.raises(ValueError):
        ref.lut_eval_ref(torch.zeros((1, 6, 1), dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        ref.lut_eval6_ref(torch.zeros((1, 5, 1), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32))


def test_build_paths_and_missing_nvcc(monkeypatch, tmp_path):
    """Libraries land under build/repro_torch_kernels/ named by their
    source hash; with no nvcc the build raises."""
    assert build.sources() == ["bitplane_matmul", "flash_attention",
                               "lut_eval", "popcount_matmul", "ssd_scan"]
    p = build.library_path("lut_eval")
    assert p.parent == build.BUILD_DIR
    assert p.parent.parts[-2:] == ("build", "repro_torch_kernels")
    assert p.name.startswith("lut_eval-") and p.suffix == ".so"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(build.KernelBuildError):
        build.nvcc_path()


def _level_inputs(seed: int, R: int = 40, M: int = 12, N: int = 3):
    """A LUT level laid out as the evaluator's planner lays one out, over
    a random value buffer ``vals[R, N]``: outputs on distinct rows that no
    pin reads, some real pins on CONST0 / CONST1, every fourth LUT a
    padding row (table 0, pins on CONST0) writing the sink row R - 1, so
    the sink is written several times in one call."""
    r = rng(seed)
    vals = r.integers(0, 2**32, size=(R, N), dtype=np.uint32)
    vals[0], vals[1] = 0, 0xFFFFFFFF
    rows = r.permutation(R - 3) + 2
    out_idx = rows[:M].astype(np.int64)
    ins = r.choice(rows[M:], size=(M, 6)).astype(np.int64)
    ins[1, 3], ins[2, 0] = 0, 1
    tt_lo = r.integers(0, 2**32, size=M, dtype=np.uint32)
    tt_hi = r.integers(0, 2**32, size=M, dtype=np.uint32)
    tt_hi[1::3] = tt_lo[1::3]
    pad = np.arange(M) % 4 == 0
    out_idx[pad], ins[pad], tt_lo[pad], tt_hi[pad] = R - 1, 0, 0, 0
    assert (out_idx == R - 1).sum() >= 2
    return vals, ins, tt_lo, tt_hi, out_idx


@pytest.mark.parametrize("seed,R,M,N", [(0, 40, 12, 3), (1, 300, 64, 8),
                                        (2, 20, 5, 1)])
def test_lut_eval6_level_matches_composition_and_reference(seed, R, M, N):
    """The fused level on the CPU equals gather -> ``lut_eval6_ref`` ->
    ``index_copy_``, and the reference's level body ``_fused_body`` (its
    LUT half, the Pallas kernel in interpret mode) on the same inputs,
    duplicate sink writes and CONST0 pins included."""
    from repro.core.eval_jax import _fused_body

    vals, ins, tt_lo, tt_hi, out_idx = _level_inputs(seed, R, M, N)
    args = (torch.from_numpy(ins), t32(tt_lo), t32(tt_hi),
            torch.from_numpy(out_idx))
    got = ops.lut_eval6_level(t32(vals).clone(), *args)
    v = t32(vals).clone()
    v.index_copy_(0, args[3], ref.lut_eval6_ref(v[args[0]], args[1],
                                                args[2]))
    assert torch.equal(got, v)
    assert torch.equal(ops.lut_eval6_level(t32(vals).clone(), *args,
                                           use_kernel=False), v)
    xs = (jnp.asarray(ins.astype(np.int32)), jnp.asarray(tt_lo),
          jnp.asarray(tt_hi), jnp.asarray(out_idx.astype(np.int32)),
          None, None, None, None, None, None)
    want, _ = _fused_body(jnp.asarray(vals), xs, has_luts=True,
                          has_chains=False, use_pallas=True)
    assert np.array_equal(u32(got), np.asarray(want))
    # rows no LUT writes are untouched, the sink holds 0
    untouched = np.setdiff1d(np.arange(R), out_idx)
    assert np.array_equal(u32(got)[untouched], vals[untouched])
    assert (u32(got)[R - 1] == 0).all()


def test_cpu_dispatch_moves_no_variant_counter():
    """On CPU tensors neither ``lut_eval6`` nor its level variant moves
    a launch or variant counter, whatever ``use_kernel`` says."""
    ops.reset_launch_counts()
    vals, ins, lo, hi, out = _level_inputs(3)
    ti = t32(np.random.default_rng(3).integers(
        0, 2**32, size=(4, 6, 2), dtype=np.uint32))
    for use_kernel in (True, False):
        ops.lut_eval6_level(t32(vals), torch.from_numpy(ins), t32(lo),
                            t32(hi), torch.from_numpy(out),
                            use_kernel=use_kernel)
        ops.lut_eval6(ti, t32(lo[:4]), t32(hi[:4]), use_kernel=use_kernel)
    assert ops.launch_counts()["lut_eval6"] == 0
    assert ops.variant_counts()["lut_eval6"] == {"op": 0, "level": 0}


def test_level_launcher_refuses_host_tensors():
    """The level kernel's launcher takes CUDA tensors only; it raises
    rather than fall back."""
    from repro_torch.kernels.lut_eval import lut_eval6_level_cuda

    vals = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.zeros((2, 6), dtype=torch.int64)
    tt = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        lut_eval6_level_cuda(vals, idx, tt, tt, idx[:, 0].contiguous())


def test_vector_width_rule():
    """The 6-input kernels take 128-bit accesses only where every row of
    every lane tensor starts 16-byte aligned: N a multiple of 4 and
    aligned base pointers."""
    from repro_torch.kernels.lut_eval import vector_width

    base = torch.zeros(4 * 64 + 1, dtype=torch.int32)
    assert base.data_ptr() % 16 == 0
    assert vector_width(8, base) == 4
    assert vector_width(6, base) == 1
    assert vector_width(8, base[1:]) == 1
    assert vector_width(8, base, base[4:]) == 4
    assert vector_width(8, base, base[2:]) == 1
