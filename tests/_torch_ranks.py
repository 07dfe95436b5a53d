"""Run one script in ``world`` CPU processes joined by a gloo group.

Each rank is a subprocess of ``python -c``: :data:`PRELUDE` forms the
group from a ``file://`` store under the test's ``tmp_path`` (no TCP
port, so tests running side by side never collide) and binds ``RANK``,
``WORLD`` and ``ARGS``; the script follows.  Every rank's standard output
and errors go to files, its last output line is read as JSON, and the
launch as a whole has one timeout: a hung rank fails its test, every rank
is killed and the errors of the first failing rank are shown.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PRELUDE = r"""
import sys
import torch.distributed as dist
RANK, WORLD, _INIT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ARGS = sys.argv[4:]
dist.init_process_group("gloo", init_method=_INIT, rank=RANK,
                        world_size=WORLD)
"""


def run_ranks(script: str, world: int, tmp_path, *args,
              timeout: float = 240.0, env: dict | None = None) -> list:
    """Each rank's last output line as JSON, in rank order."""
    tmp = Path(tmp_path)
    store = tmp / f"store_{time.monotonic_ns()}"
    full_env = dict(os.environ)
    full_env.update({"PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1",
                     "MKL_NUM_THREADS": "1"})
    full_env.pop("WORLD_SIZE", None)
    full_env.pop("LOCAL_RANK", None)
    full_env.update(env or {})
    procs, outs = [], []
    for rank in range(world):
        out = open(tmp / f"rank{rank}.out", "w+")
        err = open(tmp / f"rank{rank}.err", "w+")
        outs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PRELUDE + script, str(rank), str(world),
             f"file://{store}", *map(str, args)],
            stdout=out, stderr=err, env=full_env))
    deadline = time.monotonic() + timeout
    try:
        # until every rank is done, one fails (the others would wait for
        # it in a collective) or the time is up
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out, err in outs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        # a rank that failed by itself first, else one that was stopped
        rank = next((r for r, c in enumerate(codes) if c > 0),
                    next(r for r, c in enumerate(codes) if c))
        raise AssertionError(f"rank {rank} of {world} exited {codes[rank]} "
                             f"(all: {codes}; a negative code is a rank "
                             f"stopped at the time limit or after another "
                             f"failed):\n{texts[rank][1][-3000:]}")
    return [json.loads(t.strip().splitlines()[-1]) for t, _ in texts]
