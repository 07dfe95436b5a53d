"""The port's attention and bit-plane kernels' plain versions (and their
dispatch on CPU tensors) against the JAX package's Pallas kernels in
interpret mode, at the tolerances of the reference's own kernel tests
(fp32 2e-4, bf16 2e-2; bit-plane rtol 1e-5 / atol 1e-4).  The CUDA kernels
themselves run only on the card, where ``chip_smoke.py`` holds them to
these plain versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitplane_matmul import bitplane_matmul_cuda
from repro_torch.kernels.flash_attention import (check_shapes,
                                                 flash_attention_cuda)
from repro_torch.models import layers


def rng(seed=0):
    return np.random.default_rng(seed)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

CASES = [
    # B, Hq, Hkv, S, T, D, causal, window, softcap
    (1, 2, 2, 64, 64, 32, True, None, None),
    (2, 4, 2, 128, 128, 64, True, None, None),       # GQA
    (1, 8, 1, 64, 64, 32, True, None, None),         # MQA
    (1, 2, 2, 64, 64, 32, True, 32, None),           # sliding window
    (1, 2, 2, 64, 64, 32, True, None, 30.0),         # softcap (gemma2)
    (1, 2, 1, 16, 128, 32, True, None, None),        # decode: S < T
    (1, 2, 2, 64, 64, 32, False, None, None),        # bidirectional
    (2, 4, 2, 1, 40, 16, True, None, None),          # one query at the tail
    (1, 4, 2, 37, 83, 16, True, 20, 50.0),           # ragged S, T; all options
    (1, 2, 1, 50, 50, 64, False, 16, None),          # window, not causal
]


def _attn_inputs(case, dtype=np.float32):
    B, Hq, Hkv, S, T, D = case[:6]
    r = rng(sum(case[:6]))
    q = r.standard_normal((B, Hq, S, D)).astype(dtype)
    k = r.standard_normal((B, Hkv, T, D)).astype(dtype)
    v = r.standard_normal((B, Hkv, T, D)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_attention_matches_pallas(case):
    causal, window, softcap = case[6:]
    q, k, v = _attn_inputs(case)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, softcap=softcap, use_pallas=True))
    got = ref.flash_attention_ref(t(q), t(k), t(v), causal=causal,
                                  window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    via_ops = ops.flash_attention(t(q), t(k), t(v), causal=causal,
                                  window=window, softcap=softcap)
    assert torch.equal(via_ops, got)


def test_flash_attention_bf16_matches_pallas():
    case = (1, 4, 2, 48, 64, 32, True, 24, 50.0)
    q, k, v = _attn_inputs(case)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q, dtype=jnp.bfloat16), jnp.asarray(k, dtype=jnp.bfloat16),
        jnp.asarray(v, dtype=jnp.bfloat16), window=24, softcap=50.0,
        use_pallas=True), dtype=np.float32)
    bf = [t(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ref.flash_attention_ref(*bf, window=24, softcap=50.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_huge_window_is_no_window():
    """Global layers pass the reference's HUGE_WINDOW (1 << 30); the
    mask must not overflow."""
    q, k, v = _attn_inputs((1, 2, 2, 9, 30, 16))
    a = ref.flash_attention_ref(t(q), t(k), t(v), window=1 << 30)
    b = ref.flash_attention_ref(t(q), t(k), t(v), window=None)
    assert torch.equal(a, b)


def test_cpu_dispatch_counts_no_launches():
    ops.reset_launch_counts()
    q, k, v = _attn_inputs((1, 2, 2, 8, 8, 16))
    ops.flash_attention(t(q), t(k), t(v))
    x = t(rng(1).standard_normal((4, 8)).astype(np.float32))
    planes = t(rng(2).integers(0, 2, (3, 8, 5)).astype(np.float32))
    ops.bitplane_matmul(x, planes, torch.ones(5))
    assert ops.launch_counts() == {"lut_eval6": 0, "lut_eval": 0,
                                   "flash_attention": 0,
                                   "bitplane_matmul": 0, "ssd_scan": 0,
                                   "popcount_matmul": 0}


def test_cuda_launchers_refuse_host_tensors():
    q, k, v = (t(a) for a in _attn_inputs((1, 2, 2, 8, 8, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        bitplane_matmul_cuda(torch.ones(2, 3), torch.ones(1, 3, 4),
                             torch.ones(4))


@pytest.mark.parametrize("qs,ks,window,match", [
    ((1, 2, 8, 48), (1, 2, 8, 48), None, "not instantiated"),
    ((1, 2, 9, 16), (1, 2, 8, 16), None, "tail"),
    ((1, 3, 8, 16), (1, 2, 8, 16), None, "multiple"),
    ((1, 2, 8, 16), (1, 2, 8, 16), 0, "window"),
])
def test_flash_shape_checks(qs, ks, window, match):
    with pytest.raises(ValueError, match=match):
        check_shapes(torch.empty(qs), torch.empty(ks), torch.empty(ks),
                     window)


# ---------------------------------------------------------------------------
# the attention dispatch of the model layer
# ---------------------------------------------------------------------------


def _bshd(a: np.ndarray) -> torch.Tensor:
    return t(a).transpose(1, 2)  # [B, H, S, D] -> [B, S, H, D] view


@pytest.mark.parametrize("end,window", [(5, None), (11, 4), (12, None)])
def test_cached_attention_slices_the_prefix(end, window):
    """Over a cache of 12 slots, the kernel route (prefix of kv_len keys,
    queries at its tail) equals the reference's masked attention."""
    cfg = get_config("kratos-dd").smoke()
    S = 3 if end > 3 else 1
    q, _, _ = _attn_inputs((2, 4, 2, S, S, 16))
    _, k, v = _attn_inputs((2, 4, 2, 12, 12, 16))
    qb, kb, vb = _bshd(q), _bshd(k), _bshd(v)
    kv_len = torch.full((2,), end)
    pos = torch.arange(end - S, end)[None].expand(2, S)
    want = layers.attention_ref(qb, kb, vb, window=window, kv_len=kv_len,
                                q_positions=pos)
    got = layers.attention(cfg, qb, kb, vb, window=window, kv_len=kv_len,
                           q_positions=pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    plain = layers.attention(cfg, qb, kb, vb, window=window, kv_len=kv_len,
                             q_positions=pos, use_kernel=False)
    assert torch.equal(plain, want)


def test_cached_attention_refuses_what_the_kernel_cannot_do():
    cfg = get_config("kratos-dd").smoke()
    q = torch.zeros(2, 1, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="uniform"):
        layers.attention(cfg, q, k, k, kv_len=torch.tensor([3, 4]))
    with pytest.raises(ValueError, match="q_positions"):
        layers.attention(cfg, q, k, k, kv_len=torch.tensor([4, 4]),
                         q_positions=torch.tensor([[2], [3]]))


# ---------------------------------------------------------------------------
# bitplane_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n,b", [(4, 8, 4, 2), (32, 64, 16, 4),
                                     (128, 256, 128, 3), (65, 130, 70, 8),
                                     (9, 200, 33, 6), (5, 77, 12, 1)])
def test_bitplane_matmul_matches_pallas(m, k, n, b):
    r = rng(m + k + n + b)
    x = r.standard_normal((m, k)).astype(np.float32)
    planes = r.integers(0, 2, size=(b, k, n)).astype(np.float32)
    scale = (r.standard_normal(n).astype(np.float32)) * 0.1
    want = np.asarray(jops.bitplane_matmul(
        jnp.asarray(x), jnp.asarray(planes), jnp.asarray(scale),
        use_pallas=True))
    got = ref.bitplane_matmul_ref(t(x), t(planes), t(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(ops.bitplane_matmul(t(x), t(planes), t(scale)), got)


def test_single_plane_is_minus_one():
    """B = 1: the only plane is the top plane, weighted -1."""
    r = rng(3)
    x = r.standard_normal((6, 10)).astype(np.float32)
    planes = r.integers(0, 2, size=(1, 10, 7)).astype(np.float32)
    got = ref.bitplane_matmul_ref(t(x), t(planes), torch.ones(7))
    np.testing.assert_allclose(got.numpy(), -(x @ planes[0]), rtol=1e-5,
                               atol=1e-5)
    assert ref.bitplane_coeffs(1) == [-1.0]
    assert ref.bitplane_coeffs(4) == [1.0, 2.0, 4.0, -8.0]


def test_bitplane_matmul_matches_int_quantized():
    r = rng(5)
    m, k, n, b = 8, 16, 8, 4
    w_int = r.integers(-(2 ** (b - 1)), 2 ** (b - 1), size=(k, n))
    w_uint = (w_int % (2 ** b)).astype(np.uint32)
    planes = np.stack([(w_uint >> bit) & 1 for bit in range(b)]
                      ).astype(np.float32)
    x = r.standard_normal((m, k)).astype(np.float32)
    got = ops.bitplane_matmul(t(x), t(planes), torch.full((n,), 0.5))
    np.testing.assert_allclose(got.numpy(), (x @ w_int.astype(np.float32))
                               * 0.5, rtol=1e-5, atol=1e-4)
