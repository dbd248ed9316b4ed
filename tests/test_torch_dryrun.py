"""Slice 12 of the port against the JAX package: the dry run
(``launch.dryrun``), its roofline (``roofline.analysis``), the hillclimb
(``launch.hillclimb``), the service bench (``service.bench``) and the
legacy names (``bfs``, ``sssp_delta``, ``personalized_pagerank``,
``zero_cost``, ``Dense``, ``KVCacheSpec``).

  * roofline: ``model_flops`` equal; ``kernel_roofline``'s bytes and
    FLOPs equal over a grid of directions, sizes and batches, priced on
    the H100; ``roofline_report``'s terms on a made-up result;
  * the dry run on ``meta``: the reference's result keys; a kernel's
    counted work equals its formula and launches nothing; the peak
    tracker; an LM train cell's counted FLOPs against
    ``chip_smoke.lm_train_flops`` (a band: the remat forward and the
    plain attention backward count, exactly as the dry run predicts
    them); the explicit exchanges' wire bytes; ``fits_one_card`` false
    where the card ran out;
  * the hillclimb's variants equal the reference's and each builds;
  * the service bench's rows pass the reference's schema check and
    carry the reference's steps, push steps and counter totals;
  * the legacy wrappers equal the reference's, field by field.
"""

import dataclasses
import itertools
import json
import os

import numpy as np
import pytest
import torch

from benchmarks.validate import SCHEMA_PATH, _check
from repro.core import algorithms as ref_algs
from repro.core import cost_model as ref_cost_model
from repro.graphs import erdos_renyi as ref_erdos_renyi
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.roofline import analysis as ref_roofline
from repro.service import bench as ref_bench
from repro_torch.configs import build_cell, full_config, smoke_config
from repro_torch.configs import steps
from repro_torch.core import algorithms as algs
from repro_torch.core import cost_model
from repro_torch.dist import sharding
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.roofline import (BF16_OPS_PER_S, HBM_BYTES_PER_S,
                                          cin_bwd_work, cin_work,
                                          flash_bwd_work, flash_work)
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import MeshLayout, make_production_mesh
from repro_torch.models import attention, common
from repro_torch.models.common import param_count
from repro_torch.models.transformer import init_params
from repro_torch.roofline import analysis
from repro_torch.service import bench

import chip_smoke


def _import_ref_hillclimb():
    """``repro.launch.hillclimb``, whose import sets ``XLA_FLAGS`` for 512
    host devices: the variable is put back at once, before this process
    first asks JAX for a device."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import hillclimb as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


ref_hillclimb = _import_ref_hillclimb()

REF_KEYS = {
    "": {"cell", "mesh", "n_devices", "direction", "zero", "t_lower_s",
         "t_compile_s", "memory", "cost", "collectives", "roofline"},
    "memory": {"argument_bytes", "output_bytes", "temp_bytes",
               "generated_code_bytes", "alias_bytes"},
    "cost": {"flops", "bytes_accessed"},
    "collectives": {"by_kind", "total_bytes", "total_count"},
    "roofline": {"compute_s", "memory_s", "collective_s", "loop_factor",
                 "dominant", "bound_s", "compute_fraction_of_bound"},
}
# llama3.2-1b at smoke widths, with a head dim the flash kernel takes
LM_SMOKE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                vocab=256, head_dim=16, dtype="float32")


@pytest.fixture(autouse=True)
def no_activation_mesh():
    yield
    sharding.set_activation_mesh(None)


# ---------------------------------------------------------- roofline --
def test_hw_is_the_h100_from_one_source():
    assert analysis.HW["peak_flops"] == BF16_OPS_PER_S == 989e12
    assert analysis.HW["hbm_bw"] == HBM_BYTES_PER_S == 3.35e12
    assert analysis.HW["link_bw"] == 450e9


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "serve"])
def test_model_flops_matches_reference(kind):
    kw = dict(n_active_params=1_234_567_891, tokens=1 << 20)
    assert analysis.model_flops(kind, **kw) == ref_roofline.model_flops(
        kind, **kw)


KR_GRID = [dict(direction=d, n=n, d_ell=de, batch=b, itemsize=it, nb=nb,
                cap=cap, bin_n=bn, measured_us=us)
           for d, (n, de), b, it, (nb, cap, bn), us in itertools.product(
               ("pull", "pullf", "push"), ((1000, 7), (1 << 20, 33)),
               (1, 16), (4, 8), ((4, 1024, 256), (64, 8192, 4096)),
               (0.0, 3.5, 1e6))]


@pytest.mark.parametrize("kw", KR_GRID,
                         ids=[f"{k['direction']}-{k['n']}-{k['batch']}-"
                              f"{k['itemsize']}-{k['nb']}-{k['measured_us']}"
                              for k in KR_GRID])
def test_kernel_roofline_counts_match_reference(kw):
    got = analysis.kernel_roofline(**dict(kw, direction=kw["direction"]))
    want = ref_roofline.kernel_roofline(**kw)
    assert (got["bytes_moved"], got["flops"]) == (want["bytes_moved"],
                                                  want["flops"])
    bound = 1e6 * max(got["flops"] / 67e12, got["bytes_moved"] / 3.35e12)
    assert got["bound_us"] == pytest.approx(bound, rel=1e-12)
    assert got["pct_roofline"] == pytest.approx(
        min(bound / max(kw["measured_us"], 1e-9), 1.5), rel=1e-12)


def test_roofline_report_terms():
    result = {"cost": {"flops": 989e12, "bytes_accessed": 6.7e12},
              "collectives": {"total_bytes": 225e9}}
    r = analysis.roofline_report(result)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(2.0)
    assert r["collective_s"] == pytest.approx(0.5)
    assert r["dominant"] == "memory" and r["bound_s"] == pytest.approx(2.0)
    assert r["compute_fraction_of_bound"] == pytest.approx(0.5)
    assert r["loop_factor"] == 1
    assert set(r) == set(ref_roofline.roofline_report(
        {"cost": {"flops": 1.0, "bytes_accessed": 1.0},
         "collectives": {"total_bytes": 1}}))
    assert analysis.roofline_report(result, loop_factor=2)["memory_s"] == \
        pytest.approx(4.0)


# ----------------------------------------------------- meta kernels --
def test_flash_on_meta_counts_its_work_and_launches_nothing():
    B, T, H, Hk, d = 2, 300, 8, 2, 64
    q = torch.empty(B, T, H, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, T, Hk, d, dtype=torch.bfloat16, device="meta")
    launches = _build.launch_counts()
    _build.reset_kernel_work()
    out = kernel_ops.flash_attention(q, k, k, causal_window=17)
    assert out.shape == q.shape and out.device.type == "meta"
    assert out.dtype == torch.bfloat16
    nbytes, ops = flash_work(B, T, H, Hk, d, 17, 2)
    assert _build.kernel_work()["flash_attention"] == {"flops": ops,
                                                       "bytes": nbytes}
    assert _build.launch_counts() == launches
    with pytest.raises(ValueError, match="head dim"):
        kernel_ops.flash_attention(q[..., :8], k[..., :8], k[..., :8])


def test_cin_on_meta_counts_forward_and_backward_work():
    B, Hp, F, H, D = 37, 39, 39, 200, 10
    xk = torch.empty(B, Hp, D, device="meta", requires_grad=True)
    x0 = torch.empty(B, F, D, device="meta", requires_grad=True)
    w = torch.empty(H, Hp, F, device="meta", requires_grad=True)
    launches = _build.launch_counts()
    _build.reset_kernel_work()
    out = kernel_ops.cin_layer(xk, x0, w)
    assert out.shape == (B, H, D) and out.device.type == "meta"
    fwd = cin_work(B, H, Hp, F, D, 4)
    assert _build.kernel_work()["cin"] == {"flops": fwd[1], "bytes": fwd[0]}
    out.sum().backward()
    assert xk.grad.shape == xk.shape and x0.grad.shape == x0.shape
    assert w.grad.shape == w.shape
    # dxk a layer on the permuted weight; dx0 and dw their own kernels,
    # each 2·B·H·Hp·F·D FLOP (what the dw GEMM counted as an addmm)
    dxk = cin_work(B, Hp, H, F, D, 4)
    work = _build.kernel_work()
    assert work["cin"]["flops"] == fwd[1] + dxk[1]
    for name, which in (("cin_dx0", "dx0"), ("cin_dw", "dw")):
        nbytes, ops = cin_bwd_work(which, B, H, Hp, F, D, 4)
        assert ops == 2 * B * H * Hp * F * D
        assert work[name] == {"flops": ops, "bytes": nbytes}
    assert _build.launch_counts() == launches


def test_step_counter_tracks_the_peak_and_bytes():
    base = torch.empty(100, device="meta")
    with dryrun.StepCounter([base]) as c:
        a = torch.empty(1000, device="meta")       # 4000 -> 4096
        b = base + 1.0                              # 400 -> 512
        del a
        v = b.view(10, 10)                          # a view: no bytes
        d = torch.empty(2000, device="meta")       # 8000 -> 8192
        base.add_(1.0)                              # in place: no storage
    assert c.peak == 512 + 8192
    assert c.current == 512 + 8192
    assert c.bytes_accessed == 4000 + (400 + 400) + 8000 + (400 + 400)
    assert c.ops["view"] == 1
    del b, v, d
    assert c.current == 0


# ------------------------------------------------------------- cells --
def test_run_cell_keys_match_reference():
    for multi in (False, True):
        r = dryrun.run_cell("xdeepfm", "serve_p99", multi_pod=multi)
        assert set(r) >= REF_KEYS[""]
        for k in ("memory", "cost", "collectives", "roofline"):
            assert set(r[k]) >= REF_KEYS[k], k
        assert set(r["collectives"]["by_kind"]) == set(
            ref_roofline._COLL_KINDS)
        assert r["t_compile_s"] is None
        assert r["memory"]["generated_code_bytes"] is None
        assert r["n_devices"] == (512 if multi else 256)
        assert r["mesh"] == ("2x16x16" if multi else "16x16")
        assert r["roofline"]["loop_factor"] == 1
        assert r["collectives"]["total_bytes"] == 0
        assert r["fits_one_card"]
        # serve_p99's CIN: three layers of the kernel's work
        cfg = full_config("xdeepfm")
        want = sum(cin_work(512, h, hp, cfg.n_fields, cfg.embed_dim, 4)[1]
                   for h, hp in zip(cfg.cin_layers,
                                    (cfg.n_fields,) + cfg.cin_layers))
        assert r["cost"]["kernels"]["cin"]["flops"] == want
        assert r["cost"]["flops"] == r["cost"]["flops_aten"] + want
    for mod in (dryrun, hillclimb):
        src = open(mod.__file__).read()
        assert "XLA_FLAGS" not in src and "import jax" not in src


@pytest.mark.parametrize("arch,shape", [("graphcast", "minibatch_lg"),
                                        ("egnn", "ogb_products")])
def test_cells_that_ran_out_of_the_card_do_not_fit(arch, shape):
    r = dryrun.run_cell(arch, shape)
    m = r["memory"]
    assert not r["fits_one_card"]
    assert m["argument_bytes_total"] + m["temp_bytes"] > 80e9


def test_lm_train_flops_band():
    """Counted FLOPs of a train step against ``lm_train_flops``: at least
    the model FLOPs, at most twice. Exactly: the products of 6·N·tokens
    (norm scales aside), the layers' second forward (remat), the flash
    kernel's forward twice (remat) and its backward kernel's five
    products over the kept pairs, ``flash_bwd_work`` once a layer."""
    r = dryrun.run_cell("llama3.2-1b", "train_4k", overrides=LM_SMOKE)
    cfg = dataclasses.replace(full_config("llama3.2-1b"), **LM_SMOKE)
    p = init_params(cfg, device="meta")
    B, T = 256, 4096
    model = chip_smoke.lm_train_flops(cfg, p, B, T)
    counted = r["cost"]["flops"]
    assert model <= counted <= 2 * model
    attn = sum(flash_work(B, T, cfg.n_heads, cfg.n_kv_heads, cfg.hd, w,
                          4)[1] for w in cfg.window_array(T))
    layers = sum(param_count(lp) for lp in p["layers"])
    n = param_count(p) - p["embed"].numel()
    bwd = sum(flash_bwd_work(B, T, cfg.n_heads, cfg.n_kv_heads, cfg.hd, w,
                             4)[1] for w in cfg.window_array(T))
    # the recompute stops once every saved tensor is back: each layer's
    # last product (the FFN's down projection) and its norms are not in it
    remat = layers - cfg.n_layers * (cfg.d_ff * cfg.d_model
                                     + 2 * cfg.d_model)
    norms = cfg.n_layers * 2 * cfg.d_model + cfg.d_model
    want = 6 * (n - norms) * B * T + 2 * remat * B * T + 2 * attn + bwd
    assert counted == want
    assert r["cost"]["kernels"]["flash_attention"]["flops"] == 2 * attn
    assert r["cost"]["kernels"]["flash_attention_bwd"]["flops"] == bwd
    assert r["model_flops"] == pytest.approx(6 * n * B * T)


def test_collectives_count_the_explicit_exchanges(monkeypatch):
    monkeypatch.setattr(steps, "full_config", smoke_config)
    mesh = MeshLayout((("data", 2), ("model", 2)))
    # gin_apply_mp over 4 shards: one all_gather of h per layer
    cell = build_cell("gin-tu", "full_graph_sm", mesh,
                      overrides={"mp_exchange": True})
    c = dryrun.count_step(cell)
    Np, d = cell.args[2]["feats"].shape
    cfg = cell.meta["cfg"]
    widths = [d] + [cfg.d_hidden] * (cfg.n_layers - 1)
    assert c["collectives"]["by_kind"]["all-gather"] == {
        "count": cfg.n_layers, "bytes": sum(3 * Np * w * 4 for w in widths)}
    assert c["collectives"]["total_bytes"] == sum(3 * Np * w * 4
                                                  for w in widths)
    # the MoE LM's psum combine over the model axis: (tp - 1) partials
    # per layer, forward and the remat forward
    cell = build_cell("deepseek-moe-16b", "train_4k",
                      MeshLayout((("data", 1), ("model", 2))))
    c = dryrun.count_step(cell)
    mcfg = cell.meta["cfg"]
    B, T = cell.args[2]["tokens"].shape
    assert c["collectives"]["by_kind"]["all-reduce"] == {
        "count": 2 * mcfg.n_layers,
        "bytes": 2 * mcfg.n_layers * B * T * mcfg.d_model * 4}
    # no explicit exchange: nothing counted
    cell = build_cell("llama3.2-1b", "decode_32k", make_production_mesh())
    assert dryrun.count_step(cell)["collectives"]["total_bytes"] == 0


def test_dryrun_main(tmp_path, capsys):
    assert dryrun.main(["--list"]) == 0
    listed = capsys.readouterr().out.split()
    assert len(listed) == 40 and listed[0] == "llama3.2-1b@train_4k"
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "xdeepfm", "--shape", "retrieval_cand",
                        "--mesh", "both", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert text.count("OK   xdeepfm@retrieval_cand") == 2
    data = json.loads(out.read_text())
    assert len(data["results"]) == 2 and data["failures"] == []
    assert dryrun.main(["--arch", "nope"]) == 2


def test_want_text_lists_the_operators():
    r = dryrun.run_cell("xdeepfm", "serve_p99", want_text=True)
    assert "index" in r["ops_text"] and "mm" in r["ops_text"]


# --------------------------------------------------------- hillclimb --
def _plain(v):
    if dataclasses.is_dataclass(v):
        return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def test_hillclimb_variants_match_reference():
    assert list(hillclimb.VARIANTS) == list(ref_hillclimb.VARIANTS)
    for cell, table in hillclimb.VARIANTS.items():
        ref = ref_hillclimb.VARIANTS[cell]
        assert list(table) == list(ref)
        assert table["_cell"] == ref["_cell"]
        for name in table:
            if name != "_cell":
                assert table[name][0] == ref[name][0]
                assert _plain(table[name][1]) == _plain(ref[name][1])


@pytest.mark.parametrize("cell,variant", [
    (c, v) for c, t in hillclimb.VARIANTS.items() for v in t if v != "_cell"])
def test_every_hillclimb_variant_builds(cell, variant):
    arch, shape = hillclimb.VARIANTS[cell]["_cell"]
    kw = hillclimb.VARIANTS[cell][variant][1]
    built = build_cell(arch, shape, make_production_mesh(), **kw)
    assert built.name == f"{arch}@{shape}"
    over = dict(kw["overrides"])
    over.pop("shard_axes", None)
    over.pop("mp_exchange", None)
    for k, v in over.items():
        assert getattr(built.meta["cfg"], k) == v


def test_hillclimb_main_writes_where_it_is_told(tmp_path, capsys):
    out = tmp_path / "hc.json"
    args = ["--cell", "gin", "--variant", "v1_shard_all", "--out", str(out)]
    assert hillclimb.main(args) == 0
    runs = json.loads(out.read_text())["runs"]
    assert [(r["cell_key"], r["variant"]) for r in runs] == [
        ("gin", "v1_shard_all")]
    assert runs[0]["result"]["cell"] == "gin-tu@ogb_products"
    assert hillclimb.main(args) == 0
    assert "skip gin/v1_shard_all" in capsys.readouterr().out
    assert hillclimb.OUT == "hillclimb_results.json"


# ----------------------------------------------------- service bench --
def test_service_bench_rows_match_reference():
    with open(SCHEMA_PATH) as f:
        defs = json.load(f)["definitions"]
    got = list(itertools.islice(bench.sweep(smoke=True, widths=(2,),
                                            backend="dense", device="cpu"),
                                3))
    want = list(itertools.islice(ref_bench.sweep(smoke=True, widths=(2,)),
                                 3))
    assert bench.ALGORITHMS == ref_bench.ALGORITHMS
    assert bench.POLICIES == ref_bench.POLICIES
    for (gname, gus, gp), (wname, wus, wp) in zip(got, want):
        assert gname == wname and gus > 0
        _check(gp, defs["service_cell"], defs)
        assert set(gp) == set(wp)
        for k in ("algorithm", "graph", "n", "m", "policy", "backend",
                  "batch", "queries", "steps", "push_steps",
                  "weighted_total"):
            assert gp[k] == wp[k], k


def test_service_bench_main_writes_rows(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "ALGORITHMS", {"bfs": {}})
    monkeypatch.setattr(bench, "POLICIES", ("pull",))
    out = tmp_path / "svc.json"
    assert bench.main(["--smoke", "--backend", "dense", "--device", "cpu",
                       "--json", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert [r["name"] for r in rows] == ["service_bfs_rmat_pull_b2",
                                         "service_bfs_rmat_pull_b8"]
    assert rows[0]["derived"]["backend"] == "dense"


# ------------------------------------------------------ legacy names --
def carry(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in GRAPH_ARRAYS},
                             n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    g = ref_erdos_renyi(160, 4.0, seed=11, weighted=True)
    return g, carry(g)


def same(got, want, float_tol=False):
    if hasattr(want, "as_dict"):
        assert got.as_dict() == want.as_dict()
        return
    w = np.asarray(want)
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got)
    if float_tol:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("policy", ["push", "pull", "gs"])
def test_bfs_wrapper_matches_reference(graphs, policy):
    g_ref, g = graphs
    from repro.core.direction import Direction as RD, Fixed as RF
    from repro_torch.core.direction import Direction, Fixed
    if policy == "gs":
        got, want = algs.bfs(g, 3, policy="gs"), ref_algs.bfs(g_ref, 3,
                                                               policy="gs")
    else:
        got = algs.bfs(g, 3, policy=Fixed(Direction(policy)))
        want = ref_algs.bfs(g_ref, 3, policy=RF(RD(policy)))
    assert type(got).__name__ == "BFSResult"
    assert got._fields == want._fields
    for name in got._fields:
        same(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("direction", ["push", "pull"])
def test_sssp_and_ppr_wrappers_match_reference(graphs, direction):
    g_ref, g = graphs
    got = algs.sssp_delta(g, 5, delta=0.5, direction=direction)
    want = ref_algs.sssp_delta(g_ref, 5, delta=0.5, direction=direction)
    assert got._fields == want._fields
    for name in got._fields:
        same(getattr(got, name), getattr(want, name), float_tol=True)
    got = algs.personalized_pagerank(g, 7, iters=30, direction=direction)
    want = ref_algs.personalized_pagerank(g_ref, 7, iters=30,
                                          direction=direction)
    assert got._fields == want._fields
    for name in got._fields:
        same(getattr(got, name), getattr(want, name), float_tol=True)


def test_small_legacy_names():
    assert cost_model.zero_cost().as_dict() == \
        ref_cost_model.zero_cost().as_dict()
    from repro_torch.core import zero_cost
    assert zero_cost is cost_model.zero_cost
    assert common.Dense.init is common.dense_init
    assert common.Dense.apply is common.dense_apply
    assert hasattr(ref_common.Dense, "init")
    spec = attention.KVCacheSpec(length=4096)
    ref = ref_attention.KVCacheSpec(length=4096)
    assert (spec.length, spec.kind) == (ref.length, ref.kind) == (4096,
                                                                  "bf16")
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.kind = "int8"


# ------------------------------------------- what a backend keeps --
def test_a_shared_backend_keeps_nothing_of_a_dead_graph():
    """The CUDA backend caches push plans, row plans and the dual layout
    per graph; when the graph goes, so do they (a shared backend held a
    dead graph's layouts, and the graph with them, for good)."""
    import gc
    import weakref
    from repro_torch import api
    from repro_torch.core import CudaBackend
    from repro_torch.graphs import erdos_renyi
    b = CudaBackend(autotune=False, block_n=64, block_e=128, push_block_n=64,
                    push_strategy="scan")
    g = erdos_renyi(200, 4.0, seed=1, weighted=True, device="cpu")
    api.solve(g, "bfs", root=0, policy="gs", backend=b)
    api.solve(g, "pagerank", policy="push", backend=b, iters=3)
    assert b._plans and b._layouts
    alive = weakref.ref(g)
    del g
    gc.collect()
    assert alive() is None
    assert not b._plans and not b._layouts


def test_clearing_the_engine_cache_frees_a_sharded_backends_graph():
    """An engine cached for a sharded backend holds the backend, and the
    backend the shards' views of the graph's arrays: they outlive every
    other reference until the cache drops them."""
    import gc
    import weakref
    from repro_torch import api
    from repro_torch.graphs import erdos_renyi
    from repro_torch.shard import ShardedBackend
    g = erdos_renyi(128, 4.0, seed=3, weighted=True, device="cpu")
    sb = ShardedBackend.prepare(g, num_shards=2, inner="cuda",
                                devices=[torch.device("cpu")] * 2)
    api.solve(g, "pagerank", policy="pull", backend=sb, iters=3)
    ell = weakref.ref(g.ell_idx)
    del g, sb
    gc.collect()
    assert ell() is not None
    api.clear_engine_cache()
    gc.collect()
    assert ell() is None
