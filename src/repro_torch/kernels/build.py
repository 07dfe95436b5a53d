"""Build and load the port's CUDA kernels (nvcc route, ctypes binding).

Every ``csrc/*.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the root of the checkout.  The library's
file name carries a hash of its source, of the shared ``csrc/*.cuh``
headers and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.  Nothing here runs
at import time: the CPU tests import every module of the port.

A build or load failure raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: loaded libraries by source name
_LIBS: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA "
            "kernels can only be built on a machine with the CUDA toolkit")
    return found


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.blake2b(src + headers + repr(NVCC_FLAGS).encode(),
                        digest_size=8).hexdigest()
    return BUILD_DIR / f"{name}-{h}.so"


def _start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists.
    Returns ``(process, tmp_path, final_path, t0)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish_build(name: str, started) -> float:
    """Wait for nvcc, raise on failure, publish the library; returns the
    build's seconds."""
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return time.perf_counter() - t0


def build_all() -> dict[str, float]:
    """Build every kernel source at once (one nvcc each, started
    together) and return the seconds each build took (0.0 when its
    library was already built)."""
    started = {name: _start_build(name) for name in sources()}
    return {name: 0.0 if st is None else _finish_build(name, st)
            for name, st in started.items()}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill counts) from the build of
    ``name``'s current library, or "" when it has not been built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    st = _start_build(name)
    if st is not None:
        _finish_build(name, st)
    lib = ctypes.CDLL(str(library_path(name)))
    _LIBS[name] = lib
    return lib
