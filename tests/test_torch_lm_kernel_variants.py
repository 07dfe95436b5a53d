"""The Hopper variants of the port's attention and bit-plane kernels,
checked where the CPU can check them: the split (decode) attention's
plain version against the JAX package's Pallas kernel in interpret mode
and against ``flash_attention_ref``; the float32 attention's arithmetic
(the two-way tf32 split of every operand, attention through three-pass
tf32 products with each tile's sums added in float32) against the JAX
package's reference and Pallas kernel; the exactness the tensor-core
bit-plane product rests on (the three-way bf16 split of x, W in bf16);
and the launchers' variant choice, split counts and alignment checks as
pure functions.  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds every variant to the plain versions."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import bitplane_matmul as bp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref


def rng(seed=0):
    return np.random.default_rng(seed)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# split (decode) attention
# ---------------------------------------------------------------------------

# T is at most one of the Pallas kernel's 128-key blocks or a multiple of
# it (its interpret mode reads a ragged last block as NaN); the splits are
# ragged instead
SPLIT_CASES = [
    # B, Hq, Hkv, S, T, D, causal, window, softcap, keys_per_split
    (2, 4, 4, 1, 77, 16, True, None, None, 16),       # G 1, 5 splits, ragged
    (1, 8, 4, 1, 256, 32, True, 200, 50.0, 48),      # G 2, window + softcap
    (2, 10, 2, 3, 128, 16, True, 64, None, 32),      # G 5, S 3 (15 rows)
    (1, 5, 1, 1, 97, 16, False, None, 30.0, 16),     # G 5, not causal
    (1, 4, 2, 2, 128, 16, True, None, 30.0, 48),     # S 2 at the tail
    (2, 2, 1, 4, 45, 16, True, 8, None, 16),         # window inside a split
]


def _inputs(case, dtype=np.float32):
    B, Hq, Hkv, S, T, D = case[:6]
    r = rng(sum(case[:6]))
    return (r.standard_normal((B, Hq, S, D)).astype(dtype),
            r.standard_normal((B, Hkv, T, D)).astype(dtype),
            r.standard_normal((B, Hkv, T, D)).astype(dtype))


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_ref_matches_pallas_and_plain(case):
    B, Hq, Hkv, S, T, D, causal, window, softcap, kps = case
    q, k, v = _inputs(case)
    k_first = fa.split_plan(B, Hkv, S, T, window)[0]
    assert (T - k_first) % kps, "each case has a ragged last split"
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref.flash_attention_split_ref(t(q), t(k), t(v), k_first=k_first,
                                        keys_per_split=kps, **kw)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=True,
        **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    plain = ref.flash_attention_ref(t(q), t(k), t(v), **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_split_ref_bf16_matches_pallas():
    case = (1, 8, 4, 1, 256, 32, True, 128, 50.0, 48)
    B, Hq, Hkv, S, T, D, causal, window, softcap, kps = case
    q, k, v = _inputs(case)
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)),
        window=window, softcap=softcap, use_pallas=True), dtype=np.float32)
    bf = [t(a).to(torch.bfloat16) for a in (q, k, v)]
    k_first = fa.split_plan(B, Hkv, S, T, window)[0]
    got = ref.flash_attention_split_ref(*bf, window=window, softcap=softcap,
                                        k_first=k_first, keys_per_split=kps)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("B,Hkv,S,T,window", [
    (2, 4, 1, 4616, 4096),        # gemma2-2b decode, local layers
    (2, 4, 1, 4616, 1 << 30),     # ... global layers
    (8, 12, 1, 576, 1 << 30),     # kratos-dd decode
    (8, 5, 1, 2080, 1024),        # hymba-1.5b decode, local
    (8, 5, 1, 2080, 1 << 30),     # ... global
    (1, 2, 3, 150, 64),
    (3, 2, 1, 77, None),
    (64, 8, 1, 40, None),         # many groups, few keys
])
@pytest.mark.parametrize("slots", [132, 2 * 132, 5 * 132])
def test_split_plan(B, Hkv, S, T, window, slots):
    k_first, kps, n = fa.split_plan(B, Hkv, S, T, window, slots)
    win = window if window is not None else T + 1
    # every key some tail query sees is covered, and none before k_first
    assert k_first == max(0, T - S - win + 1)
    assert kps % fa.SPLIT_KEY_QUANTUM == 0 and kps >= 16
    n_keys = T - k_first
    assert (n - 1) * kps < n_keys <= n * kps
    # one wave: no more CTAs than the card holds (one split per group when
    # the groups alone outnumber the slots), and at least half of them
    # when there are keys enough
    assert B * Hkv * n <= max(slots, B * Hkv)
    want = max(1, slots // (B * Hkv))
    if n_keys >= 16 * want:
        assert 2 * B * Hkv * n >= min(slots, B * Hkv * want)
    assert fa.split_plan(B, Hkv, S, T, window, 2 * slots)[2] >= n


def test_split_ref_equals_plain_with_the_plan():
    """With the launcher's own plan (many splits of a long decode), the
    split sum equals the plain attention to float32 rounding."""
    case = (1, 8, 4, 1, 1500, 16, True, 1024, 50.0, None)
    q, k, v = _inputs(case)
    k_first, kps, n = fa.split_plan(1, 4, 1, 1500, 1024)
    assert n > 30
    got = ref.flash_attention_split_ref(t(q), t(k), t(v), window=1024,
                                        softcap=50.0, k_first=k_first,
                                        keys_per_split=kps)
    want = ref.flash_attention_ref(t(q), t(k), t(v), window=1024,
                                   softcap=50.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype,S,G,want", [
    (torch.float32, 1, 1, "tf32x3"), (torch.float32, 512, 2, "tf32x3"),
    (torch.bfloat16, 1, 1, "split"), (torch.bfloat16, 1, 5, "split"),
    (torch.bfloat16, 16, 1, "split"), (torch.bfloat16, 3, 5, "split"),
    (torch.bfloat16, 8, 2, "split"), (torch.bfloat16, 17, 1, "mma"),
    (torch.bfloat16, 4, 5, "mma"), (torch.bfloat16, 512, 1, "mma"),
])
def test_flash_variant_choice(dtype, S, G, want):
    assert fa.variant(dtype, S, G) == want


@pytest.mark.parametrize("kind,D,rows", [
    ("tf32x3", 16, 128), ("tf32x3", 64, 128), ("tf32x3", 128, 64),
    ("tf32x3", 256, 64), ("mma", 64, 64), ("mma", 256, 64)])
def test_query_rows_per_cta(kind, D, rows):
    assert fa.block_q(kind, D) == rows


def test_row_alignment_check():
    base = torch.zeros((2, 3, 8, 16), dtype=torch.bfloat16)
    fa.check_row_alignment(("q", base), ("k", base.transpose(1, 2)))
    # a single row needs no stride check; a 1-element offset is misaligned
    fa.check_row_alignment(("q", base[:, :, :1]))
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_row_alignment(("k", torch.zeros(
            base.numel() + 1, dtype=torch.bfloat16)[1:].view(base.shape)))
    wide = torch.zeros((1, 2, 4, 20), dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_row_alignment(("v", wide))


def test_row_alignment_check_float32():
    """The float32 kernel copies rows with 16-byte cp.async too: four
    floats make a chunk, so a one-float offset or a stride of an odd
    number of floats is refused."""
    base = torch.zeros((2, 3, 8, 16))
    fa.check_row_alignment(("q", base), ("k", base.transpose(1, 2)))
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_row_alignment(("q", torch.zeros(base.numel() + 1)[1:]
                                .view(base.shape)))
    with pytest.raises(ValueError, match="16-byte"):
        fa.check_row_alignment(("k", torch.zeros((1, 2, 4, 18))[..., :16]))
    fa.check_row_alignment(("v", torch.zeros((1, 2, 4, 20))[..., :16]))


# ---------------------------------------------------------------------------
# tf32x3 (float32) attention
# ---------------------------------------------------------------------------


def _tf32_ulp(x: torch.Tensor) -> torch.Tensor:
    """One tf32 ulp (10 stored significand bits) of each nonzero x."""
    _, e = torch.frexp(x.double())  # x = m 2^e, 0.5 <= |m| < 1
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 11)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 1e4),
                                        (3, 1e-20), (4, 1e30)])
def test_tf32_split(seed, scale):
    x = t((rng(seed).standard_normal(20000) * scale).astype(np.float32))
    hi, lo = ref.split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    # both parts are tf32 values: the 13 low significand bits are zero
    for part in (hi, lo):
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    # hi + lo is x to 2^-21 (exact sum in float64)
    xd = x.double()
    assert bool(((hi.double() + lo.double() - xd).abs()
                 <= xd.abs() * 2.0 ** -21).all())
    # hi is x rounded to nearest: lo is at most half an ulp of hi
    nz = hi != 0
    assert bool((lo.double().abs()[nz] <= _tf32_ulp(hi[nz]) / 2).all())


def test_tf32_rounds_ties_away_from_zero():
    """Halfway between two tf32 values (bit 12 set, the 12 below clear)
    rounds away from zero in both signs, as cvt.rna does; just below
    halfway rounds down (lo then rounds too); a carry runs into the
    exponent."""
    one = 1.0 + 2.0 ** -11
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      2.0 - 2.0 ** -12], dtype=torch.float32)
    hi, lo = ref.split_tf32(x)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 2.0]
    assert lo.tolist() == [-2.0 ** -11, 2.0 ** -11, 2.0 ** -11, -2.0 ** -12]


def _three_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel forms it on the tensor cores: both operands
    split, a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo dropped), the sum
    over one tile exact here (float64) and rounded once to float32."""
    (ah, al), (bh, bl) = ref.split_tf32(a), ref.split_tf32(b)
    ah, al, bh, bl = (x.double() for x in (ah, al, bh, bl))
    return (al @ bh + ah @ bl + ah @ bh).float()


def tf32x3_attention(q, k, v, causal=True, window=None, softcap=None,
                     bk=32):
    """Attention over key tiles of ``bk`` as the tf32x3 kernel computes
    it (Hq == Hkv): per tile s = three-pass q k^T -> scale -> softcap ->
    mask to -1e30, the online softmax in float32 (exp of the
    log2(e)-scaled argument, as exp2f), P V in three passes and added to
    the running output with alpha in float32."""
    B, H, S, D = q.shape
    T = k.shape[2]
    scale = D ** -0.5
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    qpos = torch.arange(S)[:, None] + (T - S)
    for k0 in range(0, T, bk):
        kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        s = _three_pass(q, kt.transpose(-1, -2)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        vis = torch.ones((S, kt.shape[2]), dtype=torch.bool)
        if causal:
            vis = vis & (kpos <= qpos)
        if window is not None:
            vis = vis & (kpos > qpos - window)
        s = torch.where(vis, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * log2e)
        p = torch.exp2((s - m_new) * log2e)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _three_pass(p, vt)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


@pytest.mark.parametrize("case", [
    # B, H, S, T, D, causal, window, softcap, bk, pallas (bk: the kernel's
    # keys per tile at D)
    # whisper-small's 1,500 keys, not causal: the plain reference only
    # (interpret mode reads padding past a ragged 128-key block)
    (1, 2, 1500, 1500, 64, False, None, None, 32, False),
    # D 256 (16-key tiles), causal with a window and softcap
    (1, 2, 128, 128, 256, True, 48, 30.0, 16, True),
], ids=str)
def test_tf32x3_attention_matches_reference(case):
    B, H, S, T, D, causal, window, softcap, bk, pallas = case
    r = rng(sum(case[:5]))
    q, k, v = (r.standard_normal(shape).astype(np.float32)
               for shape in ((B, H, S, D), (B, H, T, D), (B, H, T, D)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = tf32x3_attention(t(q), t(k), t(v), bk=bk, **kw).numpy()
    want = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    if pallas:
        kern = np.asarray(jops.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=True,
            **kw))
        np.testing.assert_allclose(got, kern, rtol=2e-4, atol=2e-4)
    # the port's plain version, which the kernel is held to on the card
    plain = ref.flash_attention_ref(t(q), t(k), t(v), **kw).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# bit-plane product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 1e4),
                                        (3, 1e-20)])
def test_bf16x3_split_is_exact(seed, scale):
    x = t((rng(seed).standard_normal(20000) * scale).astype(np.float32))
    hi, mid, lo = ref.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # the exact sum (float64 holds it) is x, bit for bit, and so is the
    # float32 sum in the kernel's order hi + (mid + lo)
    exact = hi.double() + mid.double() + lo.double()
    assert torch.equal(exact, x.double())
    assert torch.equal(hi.float() + (mid.float() + lo.float()), x)
    # each part is at most half an ulp of the one above it
    assert bool((mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("B", range(1, 9))
def test_bf16_holds_w_for_up_to_8_planes(B):
    r = rng(B)
    planes = r.integers(0, 2, size=(B, 64, 48)).astype(np.float32)
    planes[:, 0, 0] = 1.0           # W = -1
    planes[:, 0, 1] = 0.0           # W = 0
    planes[:-1, 0, 2] = 1.0         # W = 2^(B-1) - 1, the largest
    planes[-1, 0, 2] = 0.0
    planes[:-1, 0, 3] = 0.0         # W = -2^(B-1), the smallest
    planes[-1, 0, 3] = 1.0
    w = sum(c * planes[b] for b, c in enumerate(ref.bitplane_coeffs(B)))
    wt = t(w.astype(np.float32))
    assert torch.equal(wt.to(torch.bfloat16).float(), wt)
    assert w[0, 2] == 2 ** (B - 1) - 1 and w[0, 3] == -2 ** (B - 1)


def test_three_pass_product_matches_plain():
    """The tensor-core variant's algebra on the CPU: three bf16-part
    products against the bf16 W, each 16-deep k step summed in fresh
    float32 and added to the running float32 sum, equal the plain
    version within its tolerance."""
    r = rng(7)
    M, K, N, B = 33, 200, 40, 6
    x = t(r.standard_normal((M, K)).astype(np.float32))
    planes = t(r.integers(0, 2, size=(B, K, N)).astype(np.float32))
    scale = t(r.standard_normal(N).astype(np.float32) * 0.1)
    w = sum(c * planes[b] for b, c in enumerate(ref.bitplane_coeffs(B)))
    wb = w.to(torch.bfloat16).double()
    parts = [p.double() for p in ref.split_bf16x3(x)]
    acc = torch.zeros((M, N), dtype=torch.float32)
    for k0 in range(0, K, 16):
        step = sum(p[:, k0:k0 + 16] @ wb[k0:k0 + 16] for p in parts[::-1])
        acc = acc + step.float()
    want = ref.bitplane_matmul_ref(x, planes, scale)
    np.testing.assert_allclose((acc * scale).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("M,B,want", [
    (1, 6, "small_m"), (8, 6, "small_m"), (16, 8, "small_m"),
    (17, 8, "tensor_core"), (4096, 6, "tensor_core"), (65, 1, "tensor_core"),
    (8, 9, "ffma"), (4096, 10, "ffma"), (1, 16, "ffma"),
])
def test_bitplane_variant_choice(M, B, want):
    assert bp.variant(M, B) == want


@pytest.mark.parametrize("K,N,vec", [(768, 4096, 4), (768, 130, 1),
                                     (1, 1, 1), (77, 4096, 4),
                                     (100000, 64, 4), (201, 128, 4)])
def test_small_m_splits(K, N, vec):
    n, kps = bp.small_m_splits(K, N, vec)
    assert 1 <= kps <= bp.SMALL_M_MAX_SLICE
    assert (n - 1) * kps < K <= n * kps
    col_blocks = -(-N // (bp.SMALL_M_THREADS * vec))
    if K >= -(-4 * 132 // col_blocks):
        assert col_blocks * n >= 4 * 132
    if (K, N) == (768, 4096):  # the quantized flow's decode shape
        assert (n, kps) == (34, 23)


def test_cpu_calls_count_no_variant():
    ops.reset_launch_counts()
    x = t(rng(1).standard_normal((4, 8)).astype(np.float32))
    planes = t(rng(2).integers(0, 2, (3, 8, 5)).astype(np.float32))
    ops.bitplane_matmul(x, planes, torch.ones(5))
    q, k, v = (t(a) for a in _inputs((1, 2, 1, 1, 9, 16)))
    ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert ops.variant_counts() == {
        "lut_eval6": {"op": 0, "level": 0},
        "flash_attention": {"mma": 0, "split": 0, "tf32x3": 0},
        "bitplane_matmul": {"tensor_core": 0, "small_m": 0, "ffma": 0},
        "ssd_scan": {"mma": 0, "ffma": 0},
        "popcount_matmul": {"tensor_core": 0}}
