"""The flash route under autograd against the JAX package's.

The reference's ``flash_attention`` (``use_pallas=True``: the Pallas
forward in interpret mode under its ``custom_vjp``, whose backward
recomputes through ``flash_attention_ref``) and the port's
``FlashAttentionFn`` on the CPU (the plain forward; the backward the same
recompute) get the same q, k, v and upstream gradient, made with numpy
from a seed: outputs and dq, dk, dv within 1e-4 in float32, the North
star's grads tolerance.  The port's backward also equals autograd through
its plain version bit for bit, which is what the card's
``flash_backward_parity`` holds the CUDA route to; remat recomputes each
layer's attention once more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.train import losses

TOL = 1e-4
#: (label, B, Hq, Hkv, S, T, D, causal, window, softcap)
CASES = [
    ("causal", 2, 4, 4, 40, 40, 16, True, None, None),
    ("bidirectional", 1, 4, 4, 33, 33, 32, False, None, None),
    ("gqa2", 1, 4, 2, 40, 40, 16, True, None, None),
    ("mqa", 2, 4, 1, 24, 24, 16, True, None, None),
    ("window", 1, 4, 2, 48, 48, 16, True, 16, None),
    ("softcap", 1, 2, 1, 36, 36, 32, True, None, 30.0),
    ("tail", 2, 4, 2, 9, 50, 16, True, None, None),
    # two query and two key blocks of the reference's kernel (128 each; it
    # reads a ragged last block's padding, NaN in interpret mode, so T is
    # a multiple of 128 past one block)
    ("window_softcap_two_blocks", 1, 2, 1, 256, 256, 16, True, 64, 50.0),
]


def _inputs(B, Hq, Hkv, S, T, D, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = r.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = r.standard_normal((B, Hkv, T, D)).astype(np.float32)
    g = r.standard_normal((B, Hq, S, D)).astype(np.float32)
    return q, k, v, g


def _port_grads(q, k, v, g, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*ts, **kw)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return out, grads


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_gradients_match_reference(case):
    _, B, Hq, Hkv, S, T, D, causal, window, softcap = case
    q, k, v, g = _inputs(B, Hq, Hkv, S, T, D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want, vjp = jax.vjp(
        lambda a, b, c: jops.flash_attention(a, b, c, use_pallas=True, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    out, grads = _port_grads(q, k, v, g, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    for name, got, w in zip("qkv", grads, want_grads):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_backward_is_the_plain_recompute(case):
    """dq, dk, dv of ``FlashAttentionFn`` equal autograd through the plain
    version, bit for bit."""
    _, B, Hq, Hkv, S, T, D, causal, window, softcap = case
    q, k, v, g = _inputs(B, Hq, Hkv, S, T, D, seed=1)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, grads = _port_grads(q, k, v, g, **kw)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*ts, **kw), ts,
                               torch.from_numpy(g))
    for got, w in zip(grads, want):
        assert torch.equal(got, w)


class _CountForwards:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b"])
def test_remat_recomputes_each_layer(arch, monkeypatch):
    """With ``remat`` the gradients are those without it, bit for bit, and
    each layer's attention forward runs twice a step (once more in the
    backward's recompute): the 2 L flash calls per step that
    ``chip_smoke``'s training phase counts on the card."""
    cfg = get_config(arch).smoke()
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 24)))
    counter = _CountForwards(ops._flash_forward)
    monkeypatch.setattr(ops, "_flash_forward", counter)
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = {k: v.detach().requires_grad_() for k, v in
                  params["blocks"].items()}
        p = {**params, "blocks": leaves}
        counter.calls = 0
        hidden, _ = lm.forward(c, p, toks, return_hidden=True)
        loss = losses.chunked_xent(c, p, hidden, toks)
        assert counter.calls == cfg.n_layers
        grads[remat] = torch.autograd.grad(loss, list(leaves.values()))
        assert counter.calls == (2 if remat else 1) * cfg.n_layers
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)
