"""``models.layers.linear`` on 4 gloo ranks, a ``(2, 2)`` ``("data",
"model")`` mesh.

A weight's split over the data axes (FSDP) is settled by ``linear``: the
weight gathered over them, or, outside autograd where that moves less, the
product taken on the weight's own shards: a column-parallel weight
``[d on data, n on model]`` contracted over its split rows, a row-parallel
one ``[F on model, d on data]`` kept in its column blocks.  Each case is a
weight and an ``x`` (rows split over data, or whole as a decode batch of
one is; for the row-parallel weight its last dimension split over model,
or whole and sliced), held to the plain product of the whole tensors, with
the form the size rule takes: a contracted one for a decode step's few
rows, the gather for many rows and wherever autograd records the product.
"""
import json

import pytest

from _torch_ranks import run_ranks

pytestmark = pytest.mark.slow   # subprocesses: 4 ranks

#: case -> the form linear takes
CASES = {
    "column_rows_split": "contract", "column_rows_whole": "contract",
    "row_rows_split": "contract", "row_rows_whole": "contract",
    "row_x_whole_over_model": "contract", "column_many_rows": "gather",
    "row_many_rows": "gather", "row_under_autograd": "gather",
}
TOL = 1e-5

SCRIPT = r"""
import json
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers

mesh = make_host_mesh(2, torch.device("cpu"))
R, S = Replicate(), Shard
COL, ROW = (S(0), S(1)), (S(1), S(0))   # over (data, model)
gen = torch.Generator().manual_seed(0)
# case: (weight shape, its placements, x shape, x's placements, grad)
cases = {
    "column_rows_split": ((16, 32), COL, (2, 1, 16), (S(0), R), False),
    "column_rows_whole": ((16, 32), COL, (1, 1, 16), (R, R), False),
    "row_rows_split": ((32, 16), ROW, (2, 1, 32), (S(0), S(2)), False),
    "row_rows_whole": ((32, 16), ROW, (1, 1, 32), (R, S(2)), False),
    "row_x_whole_over_model": ((32, 16), ROW, (1, 1, 32), (R, R), False),
    "column_many_rows": ((16, 32), COL, (64, 8, 16), (S(0), R), False),
    "row_many_rows": ((32, 16), ROW, (64, 8, 32), (S(0), S(2)), False),
    "row_under_autograd": ((32, 16), ROW, (1, 1, 32), (R, S(2)), True),
}
real, forms = layers.gathered, []


def gathered(w):
    forms.append("gather")
    return real(w)


layers.gathered = gathered
out = {}
for name, (ws, wpl, xs, xpl, grad) in cases.items():
    w = torch.randn(ws, generator=gen)
    x = torch.randn(xs, generator=gen)
    wd = distribute_tensor(w, mesh, wpl).requires_grad_(grad)
    xd = distribute_tensor(x, mesh, xpl)
    forms.clear()
    y = layers.linear(xd, wd)
    err = float((y.full_tensor() - x @ w).abs().max())
    out[name] = {"form": forms[0] if forms else "contract", "err": err}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(SCRIPT, 4, tmp_path_factory.mktemp("linear_mesh"),
                     timeout=240)


@pytest.mark.parametrize("case", sorted(CASES))
def test_linear_on_a_mesh_is_the_plain_product(ranks, case):
    for rank in ranks:
        rec = rank[case]
        assert rec["err"] <= TOL, rec
        assert rec["form"] == CASES[case], rec
