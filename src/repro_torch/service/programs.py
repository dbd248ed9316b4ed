"""Batched multi-query programs for the source-parameterized algorithms.
PyTorch port of ``repro.service.programs``.

One :class:`BatchSpec` per batchable algorithm. The batched program runs
on the same :class:`~repro_torch.core.engine.PushPullEngine` as the
single-query one, with three conventions:

  * state leaves carry a trailing query axis — ``[n, B]`` per-vertex
    fields, ``[B]`` per-query scalars;
  * the engine-level frontier is the **union** of the per-query
    frontiers (``bool[n]``) — what push scatters from, what the k-filter
    compacts, and what the cost model prices (``width=B`` payloads);
  * per-query activity is folded into the wire values: columns where a
    query is inactive carry the combine identity (BFS's ``>n`` parent
    sentinel under min, ``inf`` under the SSSP min-plus relaxation,
    ``0`` under PPR's sum), so a union-frontier exchange delivers
    exactly the messages each query's own frontier would have.

Each column sees the same combine over the same edges as its
single-source run, and converged queries are frozen, so per-query
results equal a loop of ``api.solve`` calls. Every spec also supplies
the hooks continuous batching needs (:mod:`~repro_torch.service.
scheduler`): a per-query ``done`` mask and ``admit`` to splice a fresh
query into a retired slot between engine chunks. ``admit`` and
``extract`` copy: a result handed out never shares storage with the
running batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.backend import DenseBackend, EllBackend, require_backend
from ..core.engine import Phase, PhaseProgram, VertexProgram
from ..graphs.structure import Graph
from ..kernels.ell_spmv import ppr_update
from ..shard.backend import ShardedBackend

__all__ = ["BatchSpec", "register_batch", "batchable", "get_batch_spec"]


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """How an algorithm's batched program plugs into the service layer.

    build(g, batch, *, policy, backend, **static_kw) -> (program,
        default_max_steps).
    init(g, sources, **kw) -> (state0, union_frontier0).
    done(g, state, frontier, **kw) -> bool[B]: per-query done mask.
    extract(g, state, i) -> the i-th query's public state, the keys and
        values ``api.solve`` returns for that single source.
    admit(g, state, frontier, slot, source, **kw) -> (state, frontier):
        splice a fresh query into column ``slot``.
    frontier_of(g, state) -> bool[n]: the union frontier to resume the
        engine from after a chunked run.
    runtime_keys: kwargs consumed only by ``init``/``admit``.
    bound_unit: which EngineResult field counts against the default
        step bound — "steps" for flat programs, "epochs" for phase
        programs.
    """
    name: str
    build: Callable
    init: Callable
    done: Callable
    extract: Callable
    admit: Callable
    frontier_of: Callable
    runtime_keys: tuple = ()
    bound_unit: str = "steps"


_BATCH_REGISTRY: dict[str, BatchSpec] = {}


def register_batch(spec: BatchSpec) -> BatchSpec:
    _BATCH_REGISTRY[spec.name] = spec
    return spec


def batchable() -> list[str]:
    """Algorithm names accepted by ``api.solve_batch``."""
    return sorted(_BATCH_REGISTRY)


def get_batch_spec(name: str) -> BatchSpec:
    try:
        return _BATCH_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"algorithm {name!r} has no batched program; batchable: "
            f"{batchable()}") from None


def _sources_array(sources, device=None) -> torch.Tensor:
    src = torch.as_tensor(sources).to(torch.int64)
    if src.ndim != 1 or src.shape[0] == 0:
        raise ValueError(
            f"sources must be a non-empty 1-D sequence of vertex ids, "
            f"got shape {tuple(src.shape)}")
    return src.to(device) if device is not None else src


def _cols(b: int, device) -> torch.Tensor:
    return torch.arange(b, device=device)


# ---------------------------------------------------------------------
# multi-source BFS
_UNREACHED = 2147483647


def bfs_batch_program(g: Graph, batch: int, policy=None, backend=None
                      ) -> tuple[VertexProgram, int]:
    """Multi-source BFS: one parent-id column per source. Frontier
    vertices of query b advertise their id in column b, everyone else
    the ``>n`` sentinel that min-combine ignores; the per-query level
    lives in the state, so a run resumed from a carried state keeps
    assigning correct distances."""
    # DistributedBackend charges width-blind counters, which would break
    # the batch-aware predictor's exactness: batching runs on the dense
    # and ELL layouts or the width-aware sharded backend
    require_backend("bfs (batched)", backend, DenseBackend, EllBackend,
                    ShardedBackend)
    n = g.n

    def values_fn(g_, state, frontier):
        ids = torch.arange(g_.n, dtype=torch.int32,
                           device=frontier.device)[:, None]
        return torch.where(state["qfront"], ids, g_.n + 7)

    def touched_fn(g_, state, frontier, visited):
        # pull inspects vertices unvisited by ANY query
        return (~state["visited"]).any(dim=1)

    def update(state, msgs, step):
        visited = state["visited"]
        nxt = (~visited) & (msgs < n)
        level = state["level"] + 1                       # [B]
        new = {"dist": torch.where(nxt, level[None, :], state["dist"]),
               "parent": torch.where(nxt, msgs.to(torch.int32),
                                     state["parent"]),
               "visited": visited | nxt, "qfront": nxt, "level": level}
        return new, nxt.any(dim=1), ~nxt.any()

    prog = VertexProgram(combine="min", update_fn=update,
                         values_fn=values_fn, touched_fn=touched_fn,
                         k_filter_push=True)
    return prog, n + 1


def bfs_batch_init(g: Graph, sources, **_):
    src = _sources_array(sources, g.device)
    b = src.shape[0]
    cols = _cols(b, g.device)
    qfront = torch.zeros((g.n, b), dtype=torch.bool, device=g.device)
    qfront[src, cols] = True
    dist = torch.full((g.n, b), _UNREACHED, dtype=torch.int32,
                      device=g.device)
    dist[src, cols] = 0
    parent = torch.full((g.n, b), g.n, dtype=torch.int32, device=g.device)
    parent[src, cols] = src.to(torch.int32)
    state = {"dist": dist, "parent": parent, "visited": qfront.clone(),
             "qfront": qfront,
             "level": torch.zeros((b,), dtype=torch.int32,
                                  device=g.device)}
    return state, qfront.any(dim=1)


def bfs_batch_done(g: Graph, state, frontier, **_):
    return ~state["qfront"].any(dim=0)


def bfs_batch_extract(g: Graph, state, i: int):
    return {"dist": state["dist"][:, i].clone(),
            "parent": state["parent"][:, i].clone(),
            "visited": state["visited"][:, i].clone()}


def bfs_batch_admit(g: Graph, state, frontier, slot: int, source, **_):
    source = int(source)
    dist, parent = state["dist"].clone(), state["parent"].clone()
    visited, qfront = state["visited"].clone(), state["qfront"].clone()
    level = state["level"].clone()
    dist[:, slot] = _UNREACHED
    dist[source, slot] = 0
    parent[:, slot] = g.n
    parent[source, slot] = source
    visited[:, slot] = False
    visited[source, slot] = True
    qfront[:, slot] = False
    qfront[source, slot] = True
    level[slot] = 0
    state = {"dist": dist, "parent": parent, "visited": visited,
             "qfront": qfront, "level": level}
    return state, qfront.any(dim=1)


register_batch(BatchSpec(
    name="bfs", build=bfs_batch_program, init=bfs_batch_init,
    done=bfs_batch_done, extract=bfs_batch_extract,
    admit=bfs_batch_admit,
    frontier_of=lambda g, state: state["qfront"].any(dim=1)))


# ---------------------------------------------------------------------
# personalized PageRank (multiple personalization vectors)
def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def ppr_batch_program(g: Graph, batch: int, iters: int = 100,
                      damp: float = 0.85, tol: float = 1e-6,
                      policy=None, backend=None
                      ) -> tuple[VertexProgram, int]:
    """B personalized power iterations sharing one graph scan per step.
    A column stops updating the moment its residual drops below
    ``tol``, exactly where its single-query run stops."""
    require_backend("ppr (batched)", backend, DenseBackend, EllBackend,
                    ShardedBackend)
    n = g.n
    damp, tol = float(damp), float(tol)

    def values_fn(g_, state, frontier):
        deg = g_.out_deg.clamp(min=1).to(torch.float32)[:, None]
        return state["rank"] / deg

    def update(state, msgs, step):
        rank, resid = ppr_update(state["base"], state["rank"],
                                 state["resid"], msgs, damp, tol)
        new = {"rank": rank, "base": state["base"], "resid": resid}
        ones = torch.ones((n,), dtype=torch.bool, device=msgs.device)
        return new, ones, (resid < tol).all()

    # a backend may run the full-scan pull and this update as one step
    # (ExchangeBackend.pull_update)
    prog = VertexProgram(combine="sum", update_fn=update,
                         values_fn=values_fn,
                         step_charges=(("reads", 2 * n * batch),),
                         pull_update=("ppr", damp, tol))
    return prog, iters


def ppr_batch_init(g: Graph, sources, damp: float = 0.85, **_):
    src = _sources_array(sources, g.device)
    b = src.shape[0]
    base = torch.zeros((g.n, b), dtype=torch.float32, device=g.device)
    base[src, _cols(b, g.device)] = _f32(1.0 - damp, g.device)
    state = {"rank": base, "base": base,
             "resid": torch.full((b,), float("inf"), dtype=torch.float32,
                                 device=g.device)}
    return state, torch.ones((g.n,), dtype=torch.bool, device=g.device)


def ppr_batch_done(g: Graph, state, frontier, tol: float = 1e-6, **_):
    # mirrors the program's per-column freeze threshold
    return state["resid"] < float(tol)


def ppr_batch_extract(g: Graph, state, i: int):
    return {"ranks": state["rank"][:, i].clone(),
            "residual": state["resid"][i].clone()}


def ppr_batch_admit(g: Graph, state, frontier, slot: int, source,
                    damp: float = 0.85, **_):
    base, rank = state["base"].clone(), state["rank"].clone()
    resid = state["resid"].clone()
    base[:, slot] = 0.0
    base[int(source), slot] = _f32(1.0 - damp, base.device)
    rank[:, slot] = base[:, slot]
    resid[slot] = float("inf")
    state = {"rank": rank, "base": base, "resid": resid}
    return state, torch.ones((g.n,), dtype=torch.bool, device=g.device)


register_batch(BatchSpec(
    name="ppr", build=ppr_batch_program, init=ppr_batch_init,
    done=ppr_batch_done, extract=ppr_batch_extract,
    admit=ppr_batch_admit,
    frontier_of=lambda g, state: torch.ones((g.n,), dtype=torch.bool,
                                            device=g.device)))


# ---------------------------------------------------------------------
# multi-source Δ-stepping SSSP
_INF = float("inf")


def _in_bucket(d: torch.Tensor, lo: torch.Tensor,
               delta_t: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(d) & (d >= lo) & (d < lo + delta_t)


def sssp_batch_program(g: Graph, batch: int, delta: float = 2.0,
                       max_inner: int = 64, max_epochs: int = 1 << 14,
                       policy=None, backend=None
                       ) -> tuple[PhaseProgram, int]:
    """Multi-source Δ-stepping: bucket epochs advance in lockstep across
    queries. The bucket cursor is state-derived: each epoch jumps to the
    bucket of the smallest distance at or beyond the per-column settled
    boundary ``hi``, skipping empty buckets, so a run resumed from a
    carried state continues where it stopped, and an admitted query
    (``hi`` = 0) re-walks only its own buckets."""
    require_backend("sssp_delta", backend, DenseBackend, EllBackend,
                    ShardedBackend)
    delta_t = _f32(delta, g.device)

    def _guard(state):
        # per-column unsettled threshold: at least the current bucket,
        # and never below the column's own settled boundary
        return torch.maximum(state["lo"], state["hi"])[None, :]

    def enter(g_, state, frontier, epoch):
        d, hi = state["dist"], state["hi"]
        cand = torch.where(torch.isfinite(d) & (d >= hi[None, :]), d, _INF)
        lo = delta_t * torch.floor(cand.min() / delta_t)
        qf = _in_bucket(d, lo, delta_t) & (d >= hi[None, :])
        state = {"dist": d, "lo": lo, "hi": hi, "qfront": qf}
        return state, qf.any(dim=1)

    def exit_fn(g_, state, frontier, cost):
        # this bucket is settled for every column at or behind it
        hi = torch.maximum(state["hi"], state["lo"] + delta_t)
        return dict(state, hi=hi), frontier, cost

    def values_fn(g_, state, frontier):
        return torch.where(state["qfront"], state["dist"], _INF)

    def touched_fn(g_, state, frontier, visited):
        return (state["dist"] >= _guard(state)).any(dim=1)

    def msg(x, w):
        if x.ndim > w.ndim:            # dense paths: w is [m], x [m, B]
            w = w[..., None]
        return x + w

    def update(state, msgs, step):
        d = state["dist"]
        # a column settled below this bucket never re-relaxes
        unsettled = d >= _guard(state)
        d_new = torch.where(unsettled, torch.minimum(d, msgs), d)
        changed = d_new < d
        qf = _in_bucket(d_new, state["lo"], delta_t) & unsettled
        return (dict(state, dist=d_new, qfront=qf), qf.any(dim=1),
                ~changed.any())

    def epoch_cond(g_, state, epoch):
        d = state["dist"]
        return (torch.isfinite(d) & (d >= state["hi"][None, :])).any()

    prog = VertexProgram(combine="min", msg_fn=msg, update_fn=update,
                         values_fn=values_fn, touched_fn=touched_fn,
                         k_filter_push=True,
                         k_filter_set_fn=lambda old, new, f:
                             (new["dist"] < old["dist"]).any(dim=1))
    pp = PhaseProgram(phases=(Phase(program=prog, max_steps=max_inner,
                                    name="relax", enter_fn=enter,
                                    exit_fn=exit_fn),),
                      epoch_cond=epoch_cond)
    return pp, max_epochs


def sssp_batch_init(g: Graph, sources, **_):
    src = _sources_array(sources, g.device)
    b = src.shape[0]
    d0 = torch.full((g.n, b), _INF, dtype=torch.float32, device=g.device)
    d0[src, _cols(b, g.device)] = 0.0
    state = {"dist": d0, "lo": _f32(0.0, g.device),
             "hi": torch.zeros((b,), dtype=torch.float32, device=g.device),
             "qfront": torch.zeros((g.n, b), dtype=torch.bool,
                                   device=g.device)}
    # the phase's enter_fn recomputes the bucket frontiers every epoch
    return state, torch.zeros((g.n,), dtype=torch.bool, device=g.device)


def sssp_batch_done(g: Graph, state, frontier, **_):
    # a query is done once nothing lies at or beyond its settled boundary
    d = state["dist"]
    return ~(torch.isfinite(d) & (d >= state["hi"][None, :])).any(dim=0)


def sssp_batch_extract(g: Graph, state, i: int):
    return {"dist": state["dist"][:, i].clone()}


def sssp_batch_admit(g: Graph, state, frontier, slot: int, source, **_):
    dist, hi = state["dist"].clone(), state["hi"].clone()
    qfront = state["qfront"].clone()
    dist[:, slot] = _INF
    dist[int(source), slot] = 0.0
    # only the newcomer's settled boundary drops back to bucket zero
    hi[slot] = 0.0
    qfront[:, slot] = False
    state = {"dist": dist, "lo": _f32(0.0, dist.device), "hi": hi,
             "qfront": qfront}
    return state, qfront.any(dim=1)


register_batch(BatchSpec(
    name="sssp_delta", build=sssp_batch_program, init=sssp_batch_init,
    done=sssp_batch_done, extract=sssp_batch_extract,
    admit=sssp_batch_admit,
    # the relax phase's enter_fn rebuilds bucket frontiers every epoch
    frontier_of=lambda g, state: torch.zeros((g.n,), dtype=torch.bool,
                                             device=g.device),
    bound_unit="epochs"))
