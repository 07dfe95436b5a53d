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
    assert build.sources() == ["lut_eval"]
    p = build.library_path("lut_eval")
    assert p.parent == build.BUILD_DIR
    assert p.parent.parts[-2:] == ("build", "repro_torch_kernels")
    assert p.name.startswith("lut_eval-") and p.suffix == ".so"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(build.KernelBuildError):
        build.nvcc_path()
