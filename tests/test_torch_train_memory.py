"""What a training step holds beside its train state, against what the
reference's donated, fused step holds.

- The in-place AdamW update and the gradient norm a chunk of rows at a
  time (``optimizer.CHUNK``): the update bit for bit the one over whole
  leaves at the same clipping scale (here 1: nothing clipped), the norm
  within float32 rounding of it (a sum of the chunks' sums), and no
  float32 temporary larger than a chunk; with chunks of a few rows, of
  one row, and a leaf whole, against the reference's update and norm.
  Before, each leaf's update made
  a float32 copy of its clipped gradient and a float32 buffer of the
  leaf's size, and the norm a float32 copy and its square: for
  deepseek-moe-16b's expert stacks on a ``(2, 2)`` mesh 2 x 9.3 GiB a card
  at once, where the reference's fused update holds none, and its
  full-depth train step ran out of memory on four H100s.
- The train launcher's weights: ``fit`` steps the very tensors the
  launcher drew (it donates them, as the reference's launcher donates its
  arrays); before, ``fit`` stepped a copy while the launcher kept its
  own alive, one more copy of the weights through every step.
  ``--ckpt-every 0`` writes no checkpoint.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.train import optimizer

CHUNK = 4096
SHAPES = {"stack": (3, 40, 64), "embed": (1000, 64), "bias": (64,),
          "wide": (2, 5000)}


def _leaves(dtype, seed: int = 0):
    r = np.random.default_rng(seed)
    params = {k: torch.from_numpy(r.standard_normal(s).astype(np.float32))
              .to(dtype) for k, s in SHAPES.items()}
    grads = {k: torch.from_numpy(r.standard_normal(s).astype(np.float32)
                                 * 3).to(dtype) for k, s in SHAPES.items()}
    return params, grads


def _update(dtype, chunk: int, monkeypatch, steps: int = 2):
    monkeypatch.setattr(optimizer, "CHUNK", chunk, raising=False)
    cfg = optimizer.OptConfig(lr=3e-3, warmup_steps=1, decay_steps=10,
                              clip_norm=1e9)
    params, _ = _leaves(dtype)
    state = optimizer.adamw_init(params)
    norms = []
    for s in range(steps):
        _, grads = _leaves(dtype, seed=s + 1)
        params, state, gnorm = optimizer.adamw_update(cfg, grads, state,
                                                      params, in_place=True)
        norms.append(float(gnorm))
    return params, state, norms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_update_is_the_whole_leaf_update(dtype, monkeypatch):
    whole = _update(dtype, 1 << 30, monkeypatch)
    chunked = _update(dtype, CHUNK, monkeypatch)
    for a, b in zip(tree.leaves(whole[:2]), tree.leaves(chunked[:2])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_allclose(chunked[2], whole[2], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_update_matches_reference(dtype, monkeypatch):
    """``test_torch_donate``'s three AdamW updates against the
    reference's, with leaves cut into several chunks: at 12 elements the
    ``(7, 6)`` embedding runs in chunks of two rows and a last of one,
    the ``(2, 6, 5)`` stack a row (30 elements) at a time, the rest
    whole."""
    from test_torch_donate import test_in_place_update_matches_reference

    monkeypatch.setattr(optimizer, "CHUNK", 12, raising=False)
    test_in_place_update_matches_reference("adamw", dtype)


class _Temporaries(TorchDispatchMode):
    """The largest float32 tensor an op makes (storage of its own, not
    one of its inputs')."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        given = {t.untyped_storage().data_ptr()
                 for t in tree.leaves((args, kwargs or {}))
                 if isinstance(t, torch.Tensor)}
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32 \
                    and t.untyped_storage().data_ptr() not in given:
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_temporaries_are_at_most_a_chunk(dtype, monkeypatch):
    monkeypatch.setattr(optimizer, "CHUNK", CHUNK, raising=False)
    cfg = optimizer.OptConfig(lr=3e-3, warmup_steps=1, decay_steps=10)
    params, grads = _leaves(dtype)
    state = optimizer.adamw_init(params)
    with _Temporaries() as seen:
        optimizer.adamw_update(cfg, grads, state, params, in_place=True)
    biggest = max(int(np.prod(s)) for s in SHAPES.values())
    assert biggest > CHUNK
    # a row of "wide" is 5,000 elements: one row where a row is more
    assert 0 < seen.largest <= 5000


def test_launcher_steps_the_weights_it_drew(monkeypatch, tmp_path):
    """The launcher hands its weights to ``fit`` to step in place, so no
    second copy of them lives through the run (the reference's launcher
    donates its arrays); ``--ckpt-every 0`` writes no checkpoint."""
    from repro_torch.launch import train as train_launch

    given = []
    fit = train_launch.fit

    def spy(cfg, params, *a, **kw):
        given.extend(tree.leaves(params))
        return fit(cfg, params, *a, **kw)

    monkeypatch.setattr(train_launch, "fit", spy)
    res = train_launch.main(
        ["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "2", "--seq-len",
         "16", "--batch", "2", "--ckpt-dir", str(tmp_path / "ckpt"),
         "--ckpt-every", "0", "--device", "cpu"])
    stepped = tree.leaves(res["params"])
    assert len(given) == len(stepped) > 0
    assert all(a is b for a, b in zip(given, stepped))
    assert not (tmp_path / "ckpt").exists()
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
