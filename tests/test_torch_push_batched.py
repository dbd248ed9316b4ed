"""The ``[n, 3]`` payload cells of the binned-push grid of
``test_torch_push.py``: the port's plain version on the CPU against the
reference's ``coo_push_pallas`` (strategy "scan") in Pallas interpret
mode, over combine × dtype × msg. Integer, min and max results bit for
bit, float sums to rtol = atol = 1e-5."""

import pytest

from test_torch_kernels import GRID, GRID_IDS
from test_torch_push import check_push_cell
from test_torch_push import push_graphs  # noqa: F401  (module fixture)

BATCHED_CELLS = [(cell, i) for cell, i in zip(GRID, GRID_IDS)
                 if cell[3] is not None]


@pytest.mark.parametrize("combine,dtype,msg,batch",
                         [c for c, _ in BATCHED_CELLS],
                         ids=[i for _, i in BATCHED_CELLS])
def test_coo_push_matches_pallas(push_graphs, combine, dtype, msg, batch):
    check_push_cell(push_graphs, combine, dtype, msg, batch)
