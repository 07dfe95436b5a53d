"""The tensor-core variants of the port's SSD scan and binary GEMM, checked
where the CPU can check them: the plain versions that round and sum as
the kernels do (``ref.ssd_scan_mma_ref``: bfloat16 W, x w_u and state
copy; ``ref.popcount_matmul_bits_ref``: the integer product of the
unpacked bits with the xnor identity) against the JAX package's Pallas
kernels in interpret mode and its plain versions, at the reference's own
tolerances (SSD bfloat16 2e-2; popcount exact), and the launchers' choices
(variant, P block, 16-byte staging) as pure functions.  The CUDA kernels
themselves run only on the card, where ``chip_smoke.py`` holds every
variant to these plain versions."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import popcount_matmul as pm
from repro_torch.kernels import ssd_scan as ss

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

BF16_TOL = 2e-2


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _ssd_inputs(bb, L, H, P, N, seed):
    """Drawn as the reference's kernel test draws them; x, B and C then
    rounded to bfloat16 (the models' type, and the mma variant's)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((bb, L, H, P)).astype(np.float32) * 0.5
    dt = (0.001 + 0.05 * r.random((bb, L, H))).astype(np.float32)
    A = (-0.5 - r.random(H)).astype(np.float32)
    B = r.standard_normal((bb, L, N)).astype(np.float32) * 0.5
    C = r.standard_normal((bb, L, N)).astype(np.float32) * 0.5
    return x, dt, A, B, C


def _both(args):
    """The same inputs for both packages: x, B, C bfloat16; dt, A
    float32."""
    x, dt, A, B, C = args
    j = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, B, C)]
    tb = [t(a).to(torch.bfloat16) for a in (x, B, C)]
    return ((j[0], jnp.asarray(dt), jnp.asarray(A), j[1], j[2]),
            (tb[0], t(dt), t(A), tb[1], tb[2]))


# the reference test's shapes, a ragged P block (48), N in {8, 16}, one
# short chunk
MMA_SHAPES = [(1, 128, 2, 16, 8), (2, 256, 2, 32, 16), (1, 512, 4, 16, 32),
              (1, 256, 2, 48, 16), (2, 128, 3, 48, 8), (1, 24, 4, 16, 8)]


@pytest.mark.parametrize("shape", MMA_SHAPES, ids=str)
def test_ssd_mma_ref_matches_pallas(shape):
    jargs, targs = _both(_ssd_inputs(*shape, seed=sum(shape)))
    want = np.asarray(jops.ssd_scan(*jargs, use_pallas=True),
                      dtype=np.float32)
    got = ref.ssd_scan_mma_ref(*targs)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape[:4]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("shape", MMA_SHAPES, ids=str)
def test_ssd_mma_ref_matches_reference_ref(shape):
    jargs, targs = _both(_ssd_inputs(*shape, seed=3 + sum(shape)))
    want = np.asarray(jref.ssd_scan_ref(*jargs), dtype=np.float32)
    got = ref.ssd_scan_mma_ref(*targs)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)
    # and the port's own plain version, which rounds only the output
    plain = ref.ssd_scan_ref(*targs)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_ssd_mma_ref_rounds_where_the_kernel_rounds():
    """In float32 inputs the rounding model differs from the float32
    chunked scan by bfloat16 rounding (about 2^-9 of the terms), not by
    float32 rounding: it does round, and only that much."""
    args = [t(a) for a in _ssd_inputs(1, 256, 3, 16, 16, seed=5)]
    got = ref.ssd_scan_mma_ref(*args)
    want = ref.ssd_scan_chunked_ref(*args, chunk=128)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert 1e-5 * scale < err < 2 ** -7 * scale


def test_ssd_mma_ref_keeps_the_chunk_contract():
    args = [t(a) for a in _ssd_inputs(1, 200, 2, 8, 4, seed=0)]
    with pytest.raises(ValueError, match="multiple"):
        ref.ssd_scan_mma_ref(*args)


def test_ssd_mma_ref_model_like_inputs_stay_finite():
    """Steps up to ~4 (cum reaches hundreds below 0 inside a chunk): the
    exponent is formed only where t >= u, so nothing overflows."""
    r = np.random.default_rng(9)
    x = r.standard_normal((1, 256, 2, 16)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((1, 256, 2)))).astype(np.float32)
    A = -np.ones(2, dtype=np.float32)
    B = r.standard_normal((1, 256, 16)).astype(np.float32)
    C = r.standard_normal((1, 256, 16)).astype(np.float32)
    _, targs = _both((x, dt, A, B, C))
    got = ref.ssd_scan_mma_ref(*targs).float()
    plain = ref.ssd_scan_ref(*targs).float()
    assert bool(torch.isfinite(got).all())
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) <= BF16_TOL * max(1.0, scale)


# ---------------------------------------------------------------------------
# popcount_matmul
# ---------------------------------------------------------------------------


def _words(r, rows, words):
    return r.integers(0, 2**32, size=(rows, words), dtype=np.uint32)


@pytest.mark.parametrize("m,n,words,k_bits", [
    (4, 4, 1, 32), (130, 70, 3, 96), (257, 129, 1, 32), (33, 17, 2, 64),
    (130, 70, 3, 70), (9, 5, 1, 20), (16, 24, 4, 100)])
@pytest.mark.parametrize("mode", ["and", "xnor"])
def test_popcount_bits_ref_matches_pallas(m, n, words, k_bits, mode):
    r = np.random.default_rng(m + 31 * n + words)
    x, w = _words(r, m, words), _words(r, n, words)
    want = np.asarray(jops.popcount_matmul(jnp.asarray(x), jnp.asarray(w),
                                           mode=mode, k_bits=k_bits))
    got = ref.popcount_matmul_bits_ref(t(x.view(np.int32)),
                                       t(w.view(np.int32)), mode=mode,
                                       k_bits=k_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref.popcount_matmul_ref(
        t(x.view(np.int32)), t(w.view(np.int32)), mode=mode,
        k_bits=k_bits).numpy())


def test_unpack_bits_order():
    words = torch.tensor([[0b1011, -1], [-(1 << 31), 0]], dtype=torch.int32)
    bits = ref.unpack_bits(words)
    assert bits.shape == (2, 64)
    assert bits[0, :5].tolist() == [1, 1, 0, 1, 0]
    assert bool(bits[0, 32:].eq(1).all()) and int(bits[1].sum()) == 1
    assert bits[1, 31].item() == 1


def test_popcount_bits_ref_refuses_bad_calls():
    x = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="k_bits"):
        ref.popcount_matmul_bits_ref(x, x, mode="xnor")
    with pytest.raises(ValueError):
        ref.popcount_matmul_bits_ref(x, x, mode="or")
    with pytest.raises(ValueError, match="word counts"):
        ref.popcount_matmul_bits_ref(x, torch.zeros((2, 4),
                                                    dtype=torch.int32))


# ---------------------------------------------------------------------------
# the launchers' choices, and the counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,N,want", [
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 8, "mma"), (torch.bfloat16, 129, "ffma"),
    (torch.float32, 16, "ffma"), (torch.float32, 128, "ffma")])
def test_ssd_variant(dtype, N, want):
    assert ss.variant(dtype, N) == want


@pytest.mark.parametrize("Bb,H,P,want", [
    (2, 80, 64, 32),    # mamba2-2.7b: 320 CTAs of 32 columns
    (2, 25, 64, 16),    # hymba-1.5b: 100 would leave SMs idle; 200 of 16
    (2, 72, 48, 32),    # 288 CTAs, the last block ragged (16 of 32)
    (1, 4, 16, 16)])
def test_ssd_p_block(Bb, H, P, want):
    assert ss.p_block(Bb, H, P) == want


def test_ssd_staged_16b():
    x = torch.zeros((2, 8, 3, 64), dtype=torch.bfloat16)
    assert ss.staged_16b(x)
    proj = torch.zeros((2, 8, 2 * 16 + 3), dtype=torch.bfloat16)
    assert not ss.staged_16b(proj[..., 1:17])       # odd rows and offset
    assert not ss.staged_16b(torch.zeros((2, 8, 3, 12),
                                         dtype=torch.bfloat16))
    assert not ss.staged_16b(x.transpose(2, 3))     # not unit stride


def test_popcount_variant():
    assert {pm.variant(M, N, W) for M, N, W in cs.POPCOUNT_CASES} == \
        {"tensor_core"}
    assert pm.variant(*cs.POPCOUNT_MAIN) == "tensor_core"


def test_cpu_calls_count_no_variant():
    ops.reset_launch_counts()
    _, targs = _both(_ssd_inputs(1, 16, 2, 8, 4, seed=1))
    ops.ssd_scan(*targs)
    ops.ssd_scan(*[a.float() for a in targs])
    x = torch.ones((4, 2), dtype=torch.int32)
    ops.popcount_matmul(x, x, mode="xnor", k_bits=64)
    counts = ops.variant_counts()
    assert counts["ssd_scan"] == {"mma": 0, "ffma": 0}
    assert counts["popcount_matmul"] == {"tensor_core": 0}
    assert ops.launch_counts()["ssd_scan"] == 0


def _ssm_rec(gate, bf16, fwd, layers=4, cut=None):
    cut = cut or {"mma": 2, "ffma": 0}
    return {"arch": "x", "layers": layers,
            "gate": {"forward": {"variants": {"ssd_scan": gate}},
                     "forward_bf16": {"variants": {"ssd_scan": bf16}},
                     "forward_bf16_first_layers": {
                         "layers": 2, "variants": {"ssd_scan": cut}}},
            "forward": {"variants": {"ssd_scan": fwd}}}


def test_check_ssd_variants():
    cs.check_ssd_variants(_ssm_rec({"mma": 0, "ffma": 4},
                                   {"mma": 4, "ffma": 0},
                                   {"mma": 4, "ffma": 0}))
    for bad in (_ssm_rec({"mma": 4, "ffma": 0}, {"mma": 4, "ffma": 0},
                         {"mma": 4, "ffma": 0}),
                _ssm_rec({"mma": 0, "ffma": 4}, {"mma": 3, "ffma": 1},
                         {"mma": 4, "ffma": 0}),
                _ssm_rec({"mma": 0, "ffma": 4}, {"mma": 4, "ffma": 0},
                         {"mma": 0, "ffma": 4}),
                _ssm_rec({"mma": 0, "ffma": 4}, {"mma": 4, "ffma": 0},
                         {"mma": 4, "ffma": 0}, cut={"mma": 1, "ffma": 1})):
        with pytest.raises(cs.SmokeFailure):
            cs.check_ssd_variants(bad)


def test_new_parity_cases_cover_the_variants():
    """chip_smoke's SSD cases reach both P blocks with a ragged last
    block, N = 16 and 128, one short chunk and sliced B / C; its popcount
    cases ragged tiles, one word and k_bits < 32 words."""
    blocks = {(ss.p_block(Bb, H, P), P % ss.p_block(Bb, H, P) != 0)
              for Bb, L, H, P, N in cs.SSD_CASES}
    assert (16, True) in blocks and (32, True) in blocks
    assert {16, 128} <= {N for *_, N in cs.SSD_CASES}
    assert any(L < 128 and L % 16 for _, L, *_ in cs.SSD_CASES)
    assert any(P % 8 for *_, P, _ in cs.SSD_CASES)  # x staged by element
    assert cs.SSD_SLICED_CASES
    assert any(M % 128 and N % 128 for M, N, _ in cs.POPCOUNT_CASES)
    assert 1 in {W for *_, W in cs.POPCOUNT_CASES}
    assert all(kb < 32 * W for *_, W, kb in cs.POPCOUNT_KBITS_CASES)


def test_ssd_sliced_inputs_are_column_slices():
    gen = torch.Generator().manual_seed(0)
    x, dt, A, B, C = cs.ssd_inputs(gen, 2, 32, 3, 16, 8, torch.bfloat16,
                                   torch.device("cpu"), sliced=True)
    assert B.stride() == C.stride() == (32 * 19, 19, 1)
    assert not ss.staged_16b(B) and ss.staged_16b(x)


@pytest.mark.parametrize("shape", [(1, 1, 2, 4, 8), (2, 24, 3, 8, 16),
                                   (1, 256, 2, 16, 8)], ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_drop_diagonal_leaves_out_each_steps_own_input(shape, dtype):
    """chip_smoke's planted fault is the scan with the mask t > u: at one
    step nothing is left, and over a sequence it is the plain scan less
    the t = u terms."""
    gen = torch.Generator().manual_seed(sum(shape))
    x, dt, A, B, C = cs.ssd_inputs(gen, *shape, dtype, torch.device("cpu"))
    got = cs.drop_diagonal(ops.ssd_scan)(x, dt, A, B, C, use_kernel=True)
    assert got.dtype == dtype and got.shape == x.shape
    own = (C.float() * B.float()).sum(-1)[:, :, None, None] \
        * dt[..., None] * x.float()
    want = ref.ssd_scan_ref(x.float(), dt, A, B.float(), C.float()) - own
    tol = 3e-4 if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=tol,
                               atol=tol)
    if shape[1] == 1:
        assert float(got.float().abs().max()) <= tol


def test_mma_ref_reading():
    want = torch.tensor([1.0, -2.0, 0.0])
    got = torch.tensor([1.0 + 2 ** -7, -2.0, 1e-3])
    r = cs.mma_ref_reading(got, want)
    assert r["max_abs_err"] == pytest.approx(2 ** -7)
    assert r["beyond_one_ulp"] == pytest.approx(1e-3)
    assert cs._worse({"a": 1.0, "b": 3.0}, {"a": 2.0, "b": 0.5}) == \
        {"a": 2.0, "b": 3.0}
