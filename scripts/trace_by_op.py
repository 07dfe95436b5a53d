"""A traced cell's FLOPs and collective bytes by op and model site, and
the redistributions DTensor's own dispatch asked for, so that two torch
versions' traces of one cell can be compared op by op.

    PYTHONPATH=src python scripts/trace_by_op.py OUT CELLS MESH [LAYERS]
    python scripts/trace_by_op.py --diff A.json B.json [ROWS]

``CELLS`` is a JSON list of ``[arch, shape]`` pairs (a shape a name of
``configs.base.SHAPES`` or ``[kind, batch, seq_len]``), ``MESH``
``single`` or ``multi`` (the production meshes), ``LAYERS`` a depth cut
(0: the config's own).  Each cell is traced as ``launch.trace`` traces
it (one process forms the fake group) and written to
``OUT/<arch>__<shape>__<mesh>.json``: the totals, ``by`` (``[kind, op,
site, amount]``: kind ``flops`` or a collective's; the site the model's
three innermost frames, ``BW:<node>`` in the backward) and ``redist``
(``[op, moves, site, count]``: every input DTensor's dispatch moved to
another placement).  ``--diff`` prints the rows of two such files that
differ, largest first, and the redistributions only one of them asked
for.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import sys
import traceback


def _site() -> str:
    import torch

    frames = [f"{os.path.basename(f.filename)}:{f.lineno}"
              for f in traceback.extract_stack()
              if "repro_torch" in f.filename
              and "launch/trace.py" not in f.filename][-3:]
    node = torch._C._current_autograd_node()
    where = "BW:" + node.name() if node is not None else "FW"
    return where + " " + " < ".join(reversed(frames))


def profile(out_dir: str, cells: list, mesh_tag: str, layers: int = 0):
    import torch
    import torch.utils._pytree as pytree
    from torch.distributed.tensor._dispatch import OpDispatcher
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    from repro_torch.configs.base import get_config
    from repro_torch.launch import trace
    from repro_torch.launch.mesh import make_production_mesh

    by, red = collections.Counter(), collections.Counter()
    counted = trace.Counter.__torch_dispatch__
    moved = OpDispatcher.redistribute_local_args

    def dispatch(self, func, types, args=(), kwargs=None):
        f0 = self.flops
        c0 = {k: v["bytes"] for k, v in self.collectives.items()}
        out = counted(self, func, types, args, kwargs)
        name = func._schema.name.split("::")[-1]
        if self.flops != f0:
            by[("flops", name, _site())] += self.flops - f0
        for k, v in self.collectives.items():
            if v["bytes"] != c0.get(k, 0):
                by[(k, name, _site())] += v["bytes"] - c0.get(k, 0)
        return out

    def redistribute_args(op_info, suggested, *a, **k):
        flat = (tuple(pytree.tree_leaves(suggested.args_schema))
                if op_info.args_tree_spec is not None
                else suggested.args_schema)
        moves = [f"{tuple(x.placements)}->{tuple(y.placements)}"
                 for x, y in zip(op_info.flat_args_schema, flat)
                 if isinstance(x, DTensorSpec)
                 and x.placements != y.placements]
        if moves:
            red[(str(suggested.op), " ; ".join(moves), _site())] += 1
        return moved(op_info, suggested, *a, **k)

    trace.Counter.__torch_dispatch__ = dispatch
    OpDispatcher.redistribute_local_args = staticmethod(redistribute_args)
    m = make_production_mesh(multi_pod=(mesh_tag == "multi"))
    sizes, names = [m.shape[a] for a in m.axis_names], list(m.axis_names)
    trace.form_fake_group(math.prod(sizes))
    os.makedirs(out_dir, exist_ok=True)
    for arch, shape in cells:
        by.clear()
        red.clear()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        rec = trace.trace_cell(cfg, trace.shape_of(shape),
                               trace.fake_mesh(sizes, names))
        tag = shape if isinstance(shape, str) else "_".join(map(str, shape))
        with open(f"{out_dir}/{arch}__{tag}__{mesh_tag}.json", "w") as f:
            json.dump({"torch": torch.__version__,
                       "flops": rec["cost"]["flops"],
                       "memory": rec["memory"],
                       "collectives": rec["collectives"],
                       "by": [[*k, v] for k, v in by.most_common()],
                       "redist": [[*k, v] for k, v in red.items()]}, f)
        print(arch, tag, mesh_tag, "ok", flush=True)


def diff(path_a: str, path_b: str, rows: int = 25) -> None:
    a, b = (json.load(open(p)) for p in (path_a, path_b))
    print(a["torch"], b["torch"], "TFLOPs", a["flops"] / 1e12,
          b["flops"] / 1e12, "temporaries GB",
          a["memory"]["temp_size_in_bytes"] / 1e9,
          b["memory"]["temp_size_in_bytes"] / 1e9)
    ca, cb = collections.Counter(), collections.Counter()
    for kind, op, site, v in a["by"]:
        ca[(kind, op, site)] += v
    for kind, op, site, v in b["by"]:
        cb[(kind, op, site)] += v
    keys = sorted(set(ca) | set(cb), key=lambda k: -abs(ca[k] - cb[k]))
    for k in keys[:rows]:
        if ca[k] != cb[k]:
            print(f"{ca[k] / 1e9:14.4f} {cb[k] / 1e9:14.4f}  {k}")
    ra = {tuple(r[:3]): r[3] for r in a["redist"]}
    rb = {tuple(r[:3]): r[3] for r in b["redist"]}
    for who, x, y in ((a["torch"], ra, rb), (b["torch"], rb, ra)):
        print("redistributions only in", who)
        for k in sorted(set(x) - set(y)):
            print("  ", x[k], k)


def main(argv) -> int:
    if argv and argv[0] == "--diff":
        diff(argv[1], argv[2], int(argv[3]) if len(argv) > 3 else 25)
        return 0
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    profile(argv[0], json.loads(argv[1]), argv[2],
            int(argv[3]) if len(argv) > 3 else 0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
