"""The port stands alone: it imports neither jax nor the JAX package, and
it never quietly falls back to the CPU."""
import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import device as device_mod

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_runs_with_jax_and_reference_blocked():
    """With ``jax`` and ``repro`` made unimportable, every module of the
    port and ``chip_smoke`` import, and a tiny evaluation runs on the CPU."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import numpy as np
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        from repro_torch.core import circuits, flow
        net = circuits.sha_like(rounds=1)
        lanes = flow.random_lanes(net, 2, seed=0)
        vals = flow.evaluate_netlist(net, lanes, 2, device="cpu")
        assert flow.oracle_check(net, lanes, vals, 2)
        from repro_torch.core import sweep
        from repro_torch.core.alm import arch_grid
        grid = arch_grid(wire_delays=((0, 0, 0), (25, 40, 120)))[:4]
        res = flow.sweep_architectures([net], archs=grid, place=True,
                                       device="cpu")
        assert sweep.oracle_parity(res, [net], grid, place=True)
        found = flow.search_design_space([net], archs=grid, backend="torch",
                                         device="cpu", min_circuits=1)
        assert found.winner in {a.name for a in grid}
        import tempfile
        import repro_torch.checkpoint.ckpt, repro_torch.data.pipeline
        import repro_torch.launch.train, repro_torch.train.loop
        from repro_torch.launch import train
        with tempfile.TemporaryDirectory() as d:
            res = train.main(["--arch", "kratos-dd", "--smoke", "--steps",
                              "2", "--seq-len", "16", "--batch", "2",
                              "--ckpt-dir", d, "--device", "cpu"])
        assert res["final_step"] == 2
        from repro_torch.launch import serve
        for arch in ("deepseek-moe-16b", "whisper-small", "llava-next-34b"):
            toks = serve.main(["--arch", arch, "--smoke", "--batch", "2",
                               "--prompt-len", "6", "--max-new", "3",
                               "--device", "cpu"])
            assert toks.shape == (2, 3)
        import dataclasses
        from repro_torch.configs.base import get_config
        from repro_torch.serve import decode
        import torch
        cfg = dataclasses.replace(get_config("deepseek-moe-16b").smoke(),
                                  kv_cache_dtype="int8")
        params = serve.make_params(cfg, "cpu")
        out = decode.greedy_generate(cfg, params, serve.make_inputs(
            cfg, 1, 5, "cpu")[0], 3)
        assert out.shape == (1, 3)
        assert not any(k == "jax" or k.startswith("jax.")
                       or k == "repro" or k.startswith("repro.")
                       for k, v in sys.modules.items() if v is not None)
        print("ISOLATED")
    """)
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    text = path.read_text()
    for bad in ("import jax", "from jax", "import repro.", "from repro.",
                "import repro\n", "from repro import"):
        assert bad not in text, (path, bad)
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device(None)
    with pytest.raises(RuntimeError):
        device_mod.resolve_device("cuda")
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    assert device_mod.resolve_device(torch.device("cpu")).type == "cpu"


def test_entry_points_default_to_the_card(monkeypatch):
    """Entry points that build tensors take the card unless asked for the
    CPU: without one they raise instead of running on the host."""
    from repro_torch.core import circuits, flow
    from repro_torch.core.eval_torch import eval_netlist_levels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = circuits.sha_like(rounds=1)
    lanes = flow.random_lanes(net, 1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.evaluate_netlist(net, lanes, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.evaluate_suite([net], [lanes], 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_netlist_levels(net, lanes, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.eval_mode_cost_model([net])
    from repro_torch.core.alm import ARCHS
    from repro_torch.core.packing import pack
    from repro_torch.core.timing_vec import (analyze_ir,
                                             build_suite_timing_program)

    grid = [ARCHS["baseline"], ARCHS["dd5"]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.sweep_architectures([net], archs=grid)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.search_design_space([net], archs=grid, backend="torch",
                                 min_circuits=1)
    ir = pack(net, ARCHS["dd5"]).lower_ir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_suite_timing_program([ir])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze_ir(ir, ARCHS["dd5"], backend="torch")
    from repro_torch.core import anneal, place
    from repro_torch.core.serve_flow import FlowRequest, FlowServer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlowServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flow.serve([FlowRequest(net, "dd5")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place.place_ir(ir, ARCHS["dd5"], backend="torch")
    seed_pl = place.place_ir(ir, ARCHS["dd5"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        anneal.refine_placement(ir, ARCHS["dd5"], seed_pl, backend="torch")
    from repro_torch.configs.base import get_config
    from repro_torch.launch import quantized_serve, serve
    from repro_torch.serve.kvcache import init_cache

    argv = ["--arch", "kratos-dd", "--smoke", "--max-new", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(argv)
    from repro_torch.data.pipeline import batch_for_step, to_device
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "kratos-dd", "--smoke", "--steps", "1"])
    cfg = get_config("kratos-dd").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_device(batch_for_step(cfg, 8, 2, 0))
    assert to_device(batch_for_step(cfg, 8, 2, 0), "cpu")["tokens"] \
        .device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantized_serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(get_config("kratos-dd").smoke(), 1, 4)
    for arch in ("deepseek-moe-16b", "whisper-small", "llava-next-34b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", arch, "--smoke", "--max-new", "2"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_cache(get_config(arch).smoke(), 1, 4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", arch, "--smoke", "--steps", "1"])
    import dataclasses
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(dataclasses.replace(get_config("kratos-dd").smoke(),
                                       kv_cache_dtype="int8"), 1, 4)
    assert serve.main(argv + ["--device", "cpu"]).shape == (4, 2)
    assert flow.evaluate_netlist(net, lanes, 1, device="cpu").shape == \
        (net.n_signals, 1)
    assert len(flow.sweep_architectures([net], archs=grid,
                                        device="cpu").records[0]) == 2
    assert flow.serve([FlowRequest(net, "dd5")], device="cpu")[0] \
        .record["alms"] > 0
