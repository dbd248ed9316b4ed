"""The port's frontier ELL pull against the JAX package's
``ell_pull_frontier_pallas``, with the harness, graphs and tolerances of
``test_torch_kernels.py``: the port's plain version on the CPU, the
reference kernel in Pallas interpret mode, over combine × dtype × msg ×
payload rank. The scattered ``_full`` form must equal the masked full
scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ell_pull_frontier import (
    ell_pull_frontier_pallas, frontier_rows as ref_frontier_rows)
from repro_torch.core.primitives import mask_untouched
from repro_torch.kernels.ell_pull_frontier import (ell_pull_frontier,
                                                   ell_pull_frontier_full,
                                                   frontier_rows)
from repro_torch.kernels.ell_spmv import ell_spmv
from test_torch_kernels import GRID, GRID_IDS, ROWS, assert_same, payload
from test_torch_kernels import graphs  # noqa: F401  (module fixture)


@pytest.mark.parametrize("combine,dtype,msg,batch", GRID, ids=GRID_IDS)
def test_ell_pull_frontier_matches_pallas(graphs, combine, dtype, msg,
                                          batch):
    touched = np.random.default_rng(3).random(graphs["union"][0].n) < 0.25
    for g, tg in graphs.values():
        x = payload(g.n + 1, dtype, batch)
        x[-1] = 0
        rows = ref_frontier_rows(jnp.asarray(touched), ROWS)
        trows = frontier_rows(torch.from_numpy(touched), ROWS)
        np.testing.assert_array_equal(trows.numpy(), np.asarray(rows))
        want = ell_pull_frontier_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                                        rows, combine=combine, msg=msg,
                                        block_r=16, interpret=True)
        xt = torch.from_numpy(x)
        got = ell_pull_frontier(xt, tg.ell_idx, tg.ell_w, trows,
                                combine=combine, msg=msg)
        assert_same(got, want, combine)
        # the scattered form equals the masked full scan
        full = ell_pull_frontier_full(xt, tg.ell_idx, tg.ell_w, trows,
                                      combine=combine, msg=msg)
        masked = mask_untouched(
            ell_spmv(xt, tg.ell_idx, tg.ell_w, combine=combine, msg=msg),
            torch.from_numpy(touched), combine)
        assert_same(full, masked.numpy(), combine)
