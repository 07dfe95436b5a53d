"""The port's SSD scan and binary GEMM plain versions (and their dispatch on
CPU tensors) against the JAX package: its plain versions, and its Pallas
kernels in interpret mode, at the tolerances of the reference's own kernel
tests (SSD 3e-4 against the kernel, 1e-5 between the plain versions;
popcount exact).  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them to these plain versions."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.popcount_matmul import popcount_matmul_cuda
from repro_torch.kernels.ssd_scan import (check_shapes, chunk_of,
                                         ssd_scan_cuda)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _ssd_inputs(bb, L, H, P, N, seed):
    """Drawn as the reference's kernel test draws them."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((bb, L, H, P)).astype(np.float32) * 0.5
    dt = (0.001 + 0.05 * r.random((bb, L, H))).astype(np.float32)
    A = (-0.5 - r.random(H)).astype(np.float32)
    B = r.standard_normal((bb, L, N)).astype(np.float32) * 0.5
    C = r.standard_normal((bb, L, N)).astype(np.float32) * 0.5
    return x, dt, A, B, C


def _continuity_inputs():
    """The reference's state-continuity case: two chunks of one head."""
    r = np.random.default_rng(21)
    x = r.standard_normal((1, 256, 1, 8)).astype(np.float32) * 0.3
    dt = (0.01 + 0.02 * r.random((1, 256, 1))).astype(np.float32)
    A = np.array([-1.0], dtype=np.float32)
    B = r.standard_normal((1, 256, 4)).astype(np.float32)
    C = r.standard_normal((1, 256, 4)).astype(np.float32)
    return x, dt, A, B, C


SSD_SHAPES = [(1, 128, 2, 16, 8), (2, 256, 2, 32, 16), (1, 512, 4, 16, 32)]


@pytest.mark.parametrize("shape", SSD_SHAPES + ["continuity"], ids=str)
def test_ssd_scan_matches_pallas(shape):
    if shape == "continuity":
        args = _continuity_inputs()
    else:
        args = _ssd_inputs(*shape, seed=sum(shape))
    want = np.asarray(jops.ssd_scan(*map(jnp.asarray, args),
                                    use_pallas=True))
    got = ref.ssd_scan_ref(*map(t, args))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)
    assert torch.equal(ops.ssd_scan(*map(t, args)), got)


@pytest.mark.parametrize("shape", SSD_SHAPES + [(2, 24, 4, 16, 8),
                                                (1, 7, 3, 8, 5)], ids=str)
def test_ssd_scan_ref_matches_reference_ref(shape):
    args = _ssd_inputs(*shape, seed=7 + sum(shape))
    want = np.asarray(jref.ssd_scan_ref(*map(jnp.asarray, args)))
    got = ref.ssd_scan_ref(*map(t, args))
    assert got.dtype == torch.float32 and got.shape == shape[:4]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ssd_scan_ref_bf16_matches_reference_ref():
    """bfloat16 x / B / C, float32 dt / A: the state stays float32 and
    the output is rounded once to bfloat16, in both packages."""
    x, dt, A, B, C = _ssd_inputs(2, 64, 2, 16, 8, seed=3)
    bf = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, B, C)]
    want = np.asarray(jref.ssd_scan_ref(bf[0], jnp.asarray(dt),
                                        jnp.asarray(A), bf[1], bf[2]),
                      dtype=np.float32)
    tb = [t(a).to(torch.bfloat16) for a in (x, B, C)]
    got = ref.ssd_scan_ref(tb[0], t(dt), t(A), tb[1], tb[2])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("bb,L,H,P,N,chunk", [
    (1, 128, 2, 8, 4, 32),
    (2, 256, 3, 16, 8, 64),
    (1, 512, 2, 8, 16, 128),
    (1, 96, 2, 8, 4, 50),   # not a divisor: the sequential form
])
def test_ssd_scan_chunked_matches_reference(bb, L, H, P, N, chunk):
    args = _ssd_inputs(bb, L, H, P, N, seed=L + chunk)
    want = np.asarray(jref.ssd_scan_chunked_ref(*map(jnp.asarray, args),
                                                chunk=chunk))
    got = ref.ssd_scan_chunked_ref(*map(t, args), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    seq = ref.ssd_scan_ref(*map(t, args))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=3e-4,
                               atol=3e-4)


def test_ssd_recurrence_continues_from_a_state():
    """Two halves with the state handed over equal one whole run: the
    cached serving path's recurrence."""
    x, dt, A, B, C = map(t, _ssd_inputs(2, 40, 3, 8, 4, seed=11))
    y, h = ref.ssd_recurrence(x, dt, A, B, C)
    y1, h1 = ref.ssd_recurrence(x[:, :25], dt[:, :25], A, B[:, :25],
                                C[:, :25])
    y2, h2 = ref.ssd_recurrence(x[:, 25:], dt[:, 25:], A, B[:, 25:],
                                C[:, 25:], h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), rtol=1e-6, atol=1e-6)


def test_ssd_scan_keeps_the_chunk_contract():
    """chunk = min(128, L) must divide L: the reference's kernel refuses
    L = 200, and so do the dispatch (on any device) and the launcher."""
    args = [t(a) for a in _ssd_inputs(1, 200, 2, 8, 4, seed=0)]
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(*args)
    with pytest.raises(ValueError, match="multiple"):
        check_shapes(*args)
    assert chunk_of(100) == 100 and chunk_of(384) == 128
    short = [t(a) for a in _ssd_inputs(1, 100, 2, 8, 4, seed=0)]
    assert ops.ssd_scan(*short).shape == (1, 100, 2, 8)


# ---------------------------------------------------------------------------
# popcount_matmul
# ---------------------------------------------------------------------------


def _words(r, rows, words):
    return r.integers(0, 2**32, size=(rows, words), dtype=np.uint32)


@pytest.mark.parametrize("m,n,words", [(4, 4, 1), (16, 8, 2), (130, 70, 3),
                                       (256, 128, 4)])
@pytest.mark.parametrize("mode", ["and", "xnor"])
def test_popcount_matmul_matches_pallas(m, n, words, mode):
    r = np.random.default_rng(m * 7 + n)
    x, w = _words(r, m, words), _words(r, n, words)
    kb = words * 32
    want = np.asarray(jops.popcount_matmul(jnp.asarray(x), jnp.asarray(w),
                                           mode=mode, k_bits=kb))
    want_ref = np.asarray(jref.popcount_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), mode=mode, k_bits=kb))
    got = ref.popcount_matmul_ref(t(x.view(np.int32)), t(w.view(np.int32)),
                                  mode=mode, k_bits=kb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_ref)
    assert torch.equal(ops.popcount_matmul(t(x.view(np.int32)),
                                           t(w.view(np.int32)), mode=mode,
                                           k_bits=kb), got)


@pytest.mark.parametrize("K", [64, 70])
def test_popcount_matmul_matches_integer_dot(K):
    """Against the integer dot of the unpacked bits (0/1 for "and", +/-1
    for "xnor"), K not a word multiple included (zero padding bits)."""
    r = np.random.default_rng(K)
    xb = r.integers(0, 2, size=(5, K)).astype(np.int64)
    wb = r.integers(0, 2, size=(7, K)).astype(np.int64)

    def pack(bits):
        out = np.zeros((bits.shape[0], -(-K // 32)), dtype=np.uint32)
        for k in range(K):
            out[:, k // 32] |= bits[:, k].astype(np.uint32) << np.uint32(k % 32)
        return t(out.view(np.int32))

    got = ref.popcount_matmul_ref(pack(xb), pack(wb), mode="and")
    np.testing.assert_array_equal(got.numpy(), xb @ wb.T)
    if K % 32 == 0:  # xnor counts every packed bit
        got = ref.popcount_matmul_ref(pack(xb), pack(wb), mode="xnor",
                                      k_bits=K)
        np.testing.assert_array_equal(got.numpy(),
                                      (2 * xb - 1) @ (2 * wb - 1).T)


def test_popcount_matmul_refuses_bad_calls():
    x = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="k_bits"):
        ref.popcount_matmul_ref(x, x, mode="xnor")
    with pytest.raises(ValueError):
        ref.popcount_matmul_ref(x, x, mode="or")
    with pytest.raises(ValueError, match="word counts"):
        ref.popcount_matmul_ref(x, torch.zeros((2, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# dispatch and launchers
# ---------------------------------------------------------------------------


def test_cpu_dispatch_counts_no_launches():
    ops.reset_launch_counts()
    ops.ssd_scan(*map(t, _ssd_inputs(1, 16, 2, 8, 4, seed=1)))
    x = torch.ones((4, 2), dtype=torch.int32)
    ops.popcount_matmul(x, x, mode="xnor", k_bits=64)
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 0 and counts["popcount_matmul"] == 0
    assert set(counts) == {"lut_eval6", "lut_eval", "flash_attention",
                           "bitplane_matmul", "ssd_scan", "popcount_matmul"}


def test_cuda_launchers_refuse_host_tensors():
    args = [t(a) for a in _ssd_inputs(1, 16, 2, 8, 4, seed=2)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(*args)
    x = torch.ones((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        popcount_matmul_cuda(x, x, mode="and")


@pytest.mark.parametrize("bad,match", [
    ("dt", "do not match"), ("A", "do not match"), ("rank", "takes")])
def test_ssd_shape_checks(bad, match):
    x, dt, A, B, C = [t(a) for a in _ssd_inputs(1, 16, 2, 8, 4, seed=4)]
    if bad == "dt":
        dt = dt[:, :8]
    elif bad == "A":
        A = torch.zeros(3)
    else:
        x = x[0]
    with pytest.raises(ValueError, match=match):
        check_shapes(x, dt, A, B, C)
