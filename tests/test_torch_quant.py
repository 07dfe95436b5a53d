"""The port's bitplane quantization against the JAX package's:
planes and scales exactly, dequantization, sparsity and the bit-plane
projection within 1e-4; and the quantized-serving flow on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import bitplane as jbp
from repro_torch.configs.base import get_config
from repro_torch.launch import quantized_serve, serve
from repro_torch.quant import bitplane as bp


def _w(k: int, n: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((k, n)) * 0.05
            ).astype(np.float32)


@pytest.mark.parametrize("k,n,bits", [(64, 48, 4), (100, 33, 6), (40, 7, 2),
                                      (96, 130, 8)])
def test_quantize_matches_reference(k, n, bits):
    w = _w(k, n, seed=k + n + bits)
    w[:, 0] = 0.0  # an all-zero column takes the 1e-8 floor
    jplanes, jscale = jbp.quantize_bitplanes(jnp.asarray(w), bits=bits)
    planes, scale = bp.quantize_bitplanes(torch.from_numpy(w), bits=bits)
    assert np.array_equal(planes.numpy(), np.asarray(jplanes))
    assert np.array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_allclose(bp.dequantize(planes, scale).numpy(),
                               np.asarray(jbp.dequantize(jplanes, jscale)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(bp.plane_sparsity(planes)),
                               float(jbp.plane_sparsity(jplanes)),
                               rtol=1e-4, atol=1e-4)
    x = np.random.default_rng(1).standard_normal((3, 5, k)).astype(np.float32)
    want = np.asarray(jbp.bitplane_linear(jnp.asarray(x), jplanes, jscale))
    got = bp.bitplane_linear(torch.from_numpy(x), planes, scale)
    assert got.shape == (3, 5, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = bp.bitplane_linear(torch.from_numpy(x), planes, scale,
                               use_kernel=False)
    assert torch.equal(plain, got)


def test_quantize_tree_matches_reference():
    tree = {"a": _w(256, 256, 1), "b": {"c": _w(8, 8, 2),
                                        "d": _w(300, 220, 3)},
            "e": np.zeros(70000, np.float32)}
    want = jax.tree.map(np.asarray, jbp.quantize_tree(
        jax.tree.map(jnp.asarray, tree), bits=4))
    got = bp.quantize_tree({"a": torch.from_numpy(tree["a"]),
                            "b": {"c": torch.from_numpy(tree["b"]["c"]),
                                  "d": torch.from_numpy(tree["b"]["d"])},
                            "e": torch.from_numpy(tree["e"])}, bits=4)
    for path in (("a",), ("b", "d")):
        g, w = got, want
        for p in path:
            g, w = g[p], w[p]
        assert set(g) == {"planes", "scale"}
        assert np.array_equal(g["planes"].numpy(), w["planes"])
        assert np.array_equal(g["scale"].numpy(), w["scale"])
    assert np.array_equal(got["b"]["c"].numpy(), tree["b"]["c"])
    assert np.array_equal(got["e"].numpy(), tree["e"])


def test_quantized_serve_run_on_cpu():
    cfg = get_config("kratos-dd").smoke()
    params = serve.make_params(cfg, "cpu")
    res = quantized_serve.run(cfg, params, bits=6, rows=(8, 33))
    assert res["layers"] == cfg.n_layers
    assert res["wi_shape"] == [cfg.d_model, 2 * cfg.d_ff]
    assert 0.3 < res["plane_sparsity"] < 0.7
    for errs in res["mean_rel_err"].values():
        assert len(errs) == cfg.n_layers
        assert max(errs) < quantized_serve.MAX_REL_ERR


def test_quantized_serve_cli(capsys):
    res = quantized_serve.main(["--smoke", "--device", "cpu", "--bits", "4"])
    assert res["bits"] == 4
    assert "plane sparsity" in capsys.readouterr().out


def test_too_few_bits_fail_the_bound():
    """Two planes cannot hold the FFN weights: the flow's bound catches
    it."""
    cfg = get_config("kratos-dd").smoke()
    params = serve.make_params(cfg, "cpu")
    with pytest.raises(RuntimeError, match="mean rel err"):
        quantized_serve.run(cfg, params, bits=2)
