"""The sharded train step of ``tests/test_torch_mesh_train.py`` split
over two hosts: the reference's half where jax is installed, the port's
8 gloo ranks on another torch installation (one without jax), and the
comparison back where the reference ran, as the test makes it.  The
batches travel with the weights: ``batch_for_step`` draws them with
numpy's generators, whose streams may differ between numpy versions, so
the port's ranks read the ones this host drew (``batches.npz``).

    # jax and torch: each case's initial weights, the reference's sharded
    # step (8 host devices) and, for the uneven cases, its unsharded one
    PYTHONPATH=src:tests python scripts/mesh_train_versions.py ref DIR
    # any torch: the port's 8 ranks from DIR's initial weights
    PYTHONPATH=src:tests python scripts/mesh_train_versions.py port DIR
    # jax and torch: every rank's losses and the port's final parameters
    # and optimizer state against the reference's, within GRAD_TOL
    PYTHONPATH=src:tests python scripts/mesh_train_versions.py compare DIR

``compare`` prints one line per case and its worst distance, and exits
1 if any is outside the test's tolerance.
"""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

TEST = Path(__file__).resolve().parents[1] / "tests" / "test_torch_mesh_train.py"


def _test_string(name: str) -> str:
    """A string constant of the test module, read without importing it
    (the module imports jax)."""
    for node in ast.parse(TEST.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def ref(root: Path) -> None:
    import test_torch_mesh_train as t

    cases = t._init_cases(root, t.CASES)
    env = dict(os.environ, PYTHONPATH=str(t.SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", t.REF_SCRIPT, json.dumps(cases),
         json.dumps([a for a, _ in t.UNEVEN_CASES])],
        capture_output=True, text=True, env=env, check=True).stdout
    (root / "cases.json").write_text(json.dumps(cases))
    (root / "ref.json").write_text(out.strip().splitlines()[-1])
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import batch_for_step

    cfgs = [get_config(arch).smoke() for arch, _, _ in cases]
    np.savez(root / "batches.npz", **{
        f"{cfg.name}/{s}/{k}": v for cfg in cfgs for s in range(STEPS)
        for k, v in batch_for_step(cfg, 64, 8, s).items()})


#: the test's steps, each from ``batch_for_step(cfg, 64, 8, step)``
STEPS = 3

#: put before the port's script: ``batch_for_step`` reads the batches
#: the reference's host drew
READ_BATCHES = r"""
import numpy as _np
from repro_torch.data import pipeline as _pipeline

_saved = _np.load(ARGS[1])


def _saved_batch(cfg, seq_len, global_batch, step, *args, **kwargs):
    assert (seq_len, global_batch) == (64, 8) and not args and not kwargs
    head = f"{cfg.name}/{step}/"
    return {k[len(head):]: _saved[k] for k in _saved.files
            if k.startswith(head)}


_pipeline.batch_for_step = _saved_batch
"""


def port(root: Path) -> None:
    from _torch_ranks import run_ranks

    # the case directories as this host sees them
    cases = [[a, mp, str(root / a)]
             for a, mp, _ in json.loads((root / "cases.json").read_text())]
    recs = run_ranks(READ_BATCHES + _test_string("PORT_SCRIPT"), 8, root,
                     json.dumps(cases), str(root / "batches.npz"),
                     timeout=900)
    (root / "port.json").write_text(json.dumps(recs))


def _worst(got, want) -> float:
    """The largest ``|got - want| / (1 + |want|)``: at most ``GRAD_TOL``
    where ``assert_allclose(rtol=GRAD_TOL, atol=GRAD_TOL)`` holds."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (1 + np.abs(want)),
                        initial=0.0))


def compare(root: Path) -> int:
    import test_torch_mesh_train as t

    ref_rec = json.loads((root / "ref.json").read_text())
    ranks = json.loads((root / "port.json").read_text())
    uneven = [a for a, _ in t.UNEVEN_CASES]
    bad = 0
    for arch, mp, _ in json.loads((root / "cases.json").read_text()):
        got = t._arrays(root / arch / "port")
        against = [("ref", "losses")] + ([("one", "one_losses")]
                                         if arch in uneven else [])
        for name, losses in against:
            want = t._arrays(root / arch / name)
            assert sorted(got) == sorted(want), arch
            worst = max([_worst(r[arch]["losses"], ref_rec[arch][losses])
                         for r in ranks]
                        + [_worst(got[k], want[k]) for k in want])
            shares = all(r[arch]["bad_shares"] == [] for r in ranks)
            ok = worst <= t.GRAD_TOL and shares
            bad += not ok
            print(json.dumps({"arch": arch, "mp": mp, "against": name,
                              "worst": worst, "shares_ok": shares,
                              "ok": ok}))
    return 1 if bad else 0


def main() -> int:
    what, root = sys.argv[1], Path(sys.argv[2]).resolve()
    root.mkdir(parents=True, exist_ok=True)
    if what == "ref":
        ref(root)
    elif what == "port":
        port(root)
    elif what == "compare":
        return compare(root)
    else:
        raise SystemExit(f"unknown step {what!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
