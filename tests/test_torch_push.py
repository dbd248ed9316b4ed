"""The port's binned push against the JAX package's ``coo_push_pallas``.

Same harness as ``test_torch_kernels.py``: the port's plain version on
the CPU against the reference kernel in Pallas interpret mode (strategy
"scan"), over combine × dtype × msg × payload rank, on the disjoint
union of the adversarial graph cases and on an edgeless graph (the
``[n, 3]`` payload cells are in ``test_torch_push_batched.py``, so that
each file stays well under a minute on one worker). The push
output keeps the message dtype (no int32 widening, unlike pull). The
port's bin plan must hold the same per-bin edges and pointers as the
reference's ``build_push_plan``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs.structure import build_graph as ref_build_graph
from repro.kernels.coo_push import build_push_plan as ref_build_push_plan
from repro.kernels.coo_push import coo_push_pallas
from repro.kernels.coo_push import default_bin_cap as ref_default_bin_cap
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays
from repro_torch.kernels.coo_push import (build_push_plan, coo_push,
                                          default_bin_cap)
from test_torch_kernels import GRID, GRID_IDS, assert_same, payload
from test_torch_kernels import union_graph

BIN_N = 8          # several bins on the 96-vertex union graph
ALIGN = 128        # one plan capacity for every case


@pytest.fixture(scope="module")
def push_graphs():
    u = union_graph()
    e = ref_build_graph(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        n=u.n, d_ell=u.d_ell)
    out = {}
    for name, g in (("union", u), ("edgeless", e)):
        tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                                for f in GRAPH_ARRAYS},
                               n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
        ref_plan = (ref_build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n,
                                        BIN_N, align=ALIGN) if g.m else None)
        plan = build_push_plan(tg.coo_src, tg.coo_dst, tg.coo_w, tg.n,
                               BIN_N, align=ALIGN)
        out[name] = (g, tg, ref_plan, plan)
    return out


def test_plan_matches_reference(push_graphs):
    g, tg, ref, plan = push_graphs["union"]
    assert (plan.bin_n, plan.cap, plan.nb, plan.max_run) == \
        (ref.bin_n, ref.cap, ref.nb, ref.max_run)
    for f in ("src", "dst", "w", "ptr"):
        np.testing.assert_array_equal(getattr(plan, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    # every bin is the contiguous in_ptr slice of the dst-sorted edges
    in_ptr = tg.in_ptr.numpy()
    for b in range(plan.nb):
        lo = in_ptr[min(b * BIN_N, tg.n)]
        hi = in_ptr[min((b + 1) * BIN_N, tg.n)]
        np.testing.assert_array_equal(plan.src[b, :hi - lo].numpy(),
                                      tg.coo_src[lo:hi].numpy())


def test_default_bin_cap_matches_reference():
    for args in ((96, 400, 56, 8, 128), (1 << 16, 1_818_572, 9816, 256, 128),
                 (1_960_000, 8_030_000, 8, 256, 128), (10, 0, 8, 256, 1)):
        assert default_bin_cap(*args) == ref_default_bin_cap(*args)


def check_push_cell(push_graphs, combine, dtype, msg, batch):
    """One grid cell: the port's binned push against the reference's on
    every push graph."""
    active = np.random.default_rng(5).random(push_graphs["union"][0].n) < 0.5
    for g, tg, ref_plan, plan in push_graphs.values():
        x = payload(g.n, dtype, batch)
        want = coo_push_pallas(jnp.asarray(x), jnp.asarray(active),
                               g.coo_src, g.coo_dst, g.coo_w, g.n,
                               combine=combine, msg=msg, block_e=ALIGN,
                               block_n=BIN_N, interpret=True,
                               plan=ref_plan, strategy="scan")
        got = coo_push(torch.from_numpy(x), torch.from_numpy(active),
                       tg.coo_src, tg.coo_dst, tg.coo_w, tg.n,
                       combine=combine, msg=msg, plan=plan)
        assert_same(got, want, combine)


VEC_CELLS = [(cell, i) for cell, i in zip(GRID, GRID_IDS)
             if cell[3] is None]


@pytest.mark.parametrize("combine,dtype,msg,batch", [c for c, _ in VEC_CELLS],
                         ids=[i for _, i in VEC_CELLS])
def test_coo_push_matches_pallas(push_graphs, combine, dtype, msg, batch):
    check_push_cell(push_graphs, combine, dtype, msg, batch)

