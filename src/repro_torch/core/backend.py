"""ExchangeBackend — pluggable k-relaxation execution (paper §4, §7).
PyTorch port of ``repro.core.backend``.

A backend answers one question — "given wire values and a frontier,
combine messages per destination" — and charges the §4 counters:

  * ``DenseBackend`` — the dense-frontier segment ops
    (``push_relax`` / ``pull_relax``).
  * ``EllBackend``   — pull in the ELL (padded-row) layout; push falls
    back to the CSC segment scatter.
  * ``CudaBackend``  — the ELL semantics executed by the hand-written
    CUDA kernels (port of the JAX package's ``PallasBackend``): full-scan
    ``ell_spmv``, frontier ``ell_pull_frontier`` and binned ``coo_push``
    ("scan" or the one-hot "mxu" reduce), with block sizes and the push
    strategy from the autotuner (``kernels/tune.py``).
  * ``DistributedBackend`` — the paper's §6 DM setting: a 1D partition
    and the PA edge split over a shard mesh; local edges are plain
    per-owner writes, remote edges go through ``dist.collectives``
    (combined-alltoall push or all_gather pull), with their bytes
    charged to the Cost. (``repro_torch.shard.ShardedBackend`` runs the
    whole step shard by shard.)

The engine's host loop decides the direction before it calls a backend,
so ``relax`` dispatches on a concrete :class:`Direction`.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Optional

import torch

from ..graphs.structure import Graph, pad_values
from ..kernels import tune
from ..kernels.coo_push import (DEFAULT_BIN_N, MXU_MAX_BIN, build_push_plan,
                                coo_push)
from ..kernels.ell_pull_frontier import (default_pull_cap,
                                         ell_pull_frontier_full,
                                         frontier_rows)
from ..kernels.ell_spmv import (PPR_STEP_MAX_WIDTH, _out_dtype, col_lanes,
                                ell_row_plan, ell_spmv, ell_spmv_ppr_step)
from ..kernels.layout import build_dual_ell
from ..obs.trace import region
from .cost_model import COUNTER, Cost, counter
from .direction import Direction
from .primitives import (combine_identity, frontier_in_edges,
                         frontier_out_edges, mask_untouched, pull_relax,
                         pull_relax_ell, push_relax)

__all__ = ["ExchangeBackend", "DenseBackend", "EllBackend", "CudaBackend",
           "DistributedBackend", "require_backend", "classify_msg_fn",
           "KERNEL_DTYPES"]


def require_backend(algorithm: str, backend, *allowed) -> None:
    """Raise when ``backend`` is not one of the ``allowed`` classes."""
    if backend is None or isinstance(backend, tuple(allowed)):
        return
    names = ", ".join(c.__name__ for c in allowed)
    raise NotImplementedError(
        f"{algorithm} supports only [{names}] backends, "
        f"not {type(backend).__name__}")


def _width(values: torch.Tensor) -> int:
    return 1 if values.ndim == 1 else int(values.shape[-1])


@dataclasses.dataclass(frozen=True)
class ExchangeBackend:
    """Protocol: how one k-relaxation step touches memory.

    ``push`` scatters from the frontier with combining writes; ``pull``
    gathers privately into touched destinations. Both return
    ``(combined_msgs, cost)``. ``pull_scans_all`` says whether this
    backend's pull reads every edge whatever the touched set.
    """

    pull_scans_all = False

    def push(self, g: Graph, values, frontier, combine: str,
             msg_fn: Optional[Callable], cost: Cost):
        raise NotImplementedError

    def pull(self, g: Graph, values, touched, combine: str,
             msg_fn: Optional[Callable], cost: Cost):
        raise NotImplementedError

    def relax(self, g: Graph, values, frontier, *, direction: Direction,
              combine: str = "sum", msg_fn: Optional[Callable] = None,
              touched=None, cost: Optional[Cost] = None):
        cost = Cost.zeros(values.device) if cost is None else cost
        if direction == Direction.PUSH:
            return self.push(g, values, frontier, combine, msg_fn, cost)
        return self.pull(g, values, touched, combine, msg_fn, cost)

    # -- cross-step exchange state (sharded, compressed backends) --------
    def init_exchange_state(self, g: Graph):
        """Initial exchange-carried state for a run on ``g``. Backends
        whose exchange is stateful *across steps* (the sharded push's
        error-feedback accumulator) return a tree of tensors; the engine
        carries it through the loop and hands it to every
        :meth:`relax_ex` call. Default: ``()``, stateless."""
        return ()

    def relax_ex(self, g: Graph, values, frontier, *, direction: Direction,
                 combine: str = "sum", msg_fn: Optional[Callable] = None,
                 touched=None, cost: Optional[Cost] = None, xstate=()):
        """``relax`` with the exchange state: returns ``(combined_msgs,
        cost, new_xstate)``. The default forwards to :meth:`relax` and
        passes ``xstate`` through; the engine always calls this
        surface."""
        out, cost = self.relax(g, values, frontier, direction=direction,
                               combine=combine, msg_fn=msg_fn,
                               touched=touched, cost=cost)
        return out, cost, xstate

    def pull_update(self, g: Graph, values_of, state, spec, cost: Cost,
                    private: bool = False):
        """A full-scan pull of the step's payload and the program's
        update fused into one step, for a program whose ``pull_update``
        is ``spec``: ``(state, frontier, converged, cost)``, exactly what
        the pull and ``update_fn`` give, or None where this backend does
        not fuse them (the default), and the engine runs the two.
        ``values_of(s)`` is the program's payload of a state ``s``: of
        ``state``, or of a state of some of its columns.

        ``state``'s tensors are left as they are, except where
        ``private`` is True: ``state`` is then the engine's own carry,
        made by an earlier step of the running loop and held by nothing
        outside it, and a backend may write the new state into those of
        its tensors that it made itself in an earlier step. A caller's
        state (the run's first step) is never written."""
        return None

    def predict_comm_bytes(self, g: Graph, values, frontier) -> tuple:
        """Predicted inter-device wire bytes of one (push, pull) step,
        exactly what ``push``/``pull`` then charge to
        ``Cost.collective_bytes``: none on one device."""
        return counter(0, g.device), counter(0, g.device)

    def predict_pull_scan(self, g: Graph, touched, values=None,
                          combine: str = "sum",
                          msg_fn: Optional[Callable] = None) -> tuple:
        """Predicted ``(edges_read, vertices_written)`` of one pull step,
        per payload column — exactly what ``pull`` then charges."""
        if touched is None or self.pull_scans_all:
            return counter(g.m, g.device), counter(g.n, g.device)
        return frontier_in_edges(g, touched), touched.to(COUNTER).sum()

    @property
    def name(self) -> str:
        return type(self).__name__

    def telemetry_counters(self) -> dict:
        """Totals this backend keeps, for ``repro_torch.obs`` to surface
        under ``backend.<name>.*``; stateless backends keep none."""
        return {}


@dataclasses.dataclass(frozen=True)
class DenseBackend(ExchangeBackend):
    """Dense-frontier segment ops."""

    def push(self, g, values, frontier, combine, msg_fn, cost):
        return push_relax(g, values, frontier, combine=combine,
                          msg_fn=msg_fn, cost=cost)

    def pull(self, g, values, touched, combine, msg_fn, cost):
        return pull_relax(g, values, touched=touched, combine=combine,
                          msg_fn=msg_fn, cost=cost)


@dataclasses.dataclass(frozen=True)
class EllBackend(ExchangeBackend):
    """Pull in the ELL layout; push falls back to the CSC segment
    scatter."""

    pull_scans_all = True

    def push(self, g, values, frontier, combine, msg_fn, cost):
        return push_relax(g, values, frontier, combine=combine,
                          msg_fn=msg_fn, cost=cost)

    def pull(self, g, values, touched, combine, msg_fn, cost):
        out, cost = pull_relax_ell(g, values, combine=combine,
                                   msg_fn=msg_fn, cost=cost)
        if touched is not None:
            out = mask_untouched(out, touched, combine)
        return out, cost


# msg_fn classification: the kernels implement the three wire-message
# shapes every algorithm uses. A msg_fn is probed on values that mix
# signs, zero and large magnitudes, so a function that only coincides
# with a mode on tame inputs is rejected rather than mis-dispatched.
_MSG_PROBE_X = (0.5, -1.25, 2.0, 0.0, 3e6, -7e5, 1e-4, 64.0)
_MSG_PROBE_W = (1.5, 0.25, -3.0, 2.0, -2e6, 4e5, 5e3, -0.125)
_MSG_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def classify_msg_fn(msg_fn: Optional[Callable]) -> Optional[str]:
    """Kernel message mode for ``msg_fn``: ``"copy"`` (None), ``"mul"``
    (value × weight), ``"add"`` (value + weight), or None when it
    matches none of them (the caller falls back to the primitives)."""
    if msg_fn is None:
        return "copy"
    try:
        return _MSG_CACHE[msg_fn]
    except (KeyError, TypeError):
        pass
    mode = None
    x = torch.tensor(_MSG_PROBE_X, dtype=torch.float32)
    w = torch.tensor(_MSG_PROBE_W, dtype=torch.float32)
    try:
        got = torch.as_tensor(msg_fn(x, w))
        for cand, want in (("copy", x), ("mul", x * w), ("add", x + w)):
            if got.shape == x.shape and torch.allclose(
                    got.to(torch.float64), want.to(torch.float64),
                    rtol=1e-6, atol=1e-6):
                mode = cand
                break
    except Exception:      # arbitrary callables may reject the probe
        mode = None
    try:
        _MSG_CACHE[msg_fn] = mode
    except TypeError:      # non-weakrefable callables skip the cache
        pass
    return mode


KERNEL_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class CudaBackend(EllBackend):
    """The ELL backend's semantics executed by the CUDA kernels.

    ``pull`` with no touched set runs the full-scan ``ell_spmv`` over the
    real slots of each row (``row_len=g.in_deg``, with a row plan built
    once per graph and column-lane count). Every kernel pull reads the
    graph's own pull layout (``Graph.pull_arrays``): the dense ELL, or on
    a row-layout graph the CSR through its row offsets, where no path
    here reads ``ell_idx`` or ``ell_w``. With a
    touched set it counts the set: an empty set returns the identity
    with no launch; a set that fits (at most ``pull_frontier_cap`` rows,
    ``default_pull_cap`` unless pinned, and fewer than ``m / d_ell``)
    runs ``ell_pull_frontier`` over the rows' real slots (``row_len =
    g.in_deg``) on the row list compacted to the next power of two ≥ 8,
    at most the cap; anything else runs the full scan and masks.
    ``push`` runs ``coo_push`` over a bin plan built once per (graph,
    bin width). Charges equal ``predict_pull_scan``
    (pull) and ``m`` reads + ``m`` writes of binning plus ``k·width``
    (push). A batched PPR step (``pull_update`` spec ``("ppr", damp,
    tol)``) on a float32 payload of at most ``PPR_STEP_MAX_WIDTH``
    columns runs its full-scan pull and update as one launch,
    ``ell_spmv_ppr_step``, with the full scan's charges, and counts it
    in ``stats["fused_pull_update"]`` as well as ``kernel_pull``. A wider
    batch does so on the steps where at most ``PPR_STEP_MAX_WIDTH`` of
    its columns are still active (residual at least ``tol``): those
    columns alone, with the full width's charges, the new ranks written
    into a copy of the rank on the loop's first such step and in place
    after it (``private``); so a batch that waits
    on a few slow queries (sources in small components of a Kronecker
    graph take 74 steps where the rest take 34) pays a narrow step for
    each of its last steps, not a [n, B] one.

    Block sizes and the push reduce strategy come from
    ``kernels/tune.py``, probed once per (graph shape, payload shape,
    device; the frontier pull also keys on the compacted row capacity)
    and cached on this instance and on disk, unless pinned through
    ``block_n`` (pull rows per CTA), ``block_e`` (push edge chunk),
    ``push_block_n`` (push bin width) and ``push_strategy`` ("scan" |
    "mxu"). A partial pin overrides only its own part (a pinned "mxu"
    over a tuned bin wider than 256 takes 256, the widest bin its kernel
    takes). With ``autotune=False`` each unpinned part takes its ladder's
    first rung.

    Cells outside the kernels' coverage — a msg_fn other than copy, mul
    or add, a combine outside sum/min/max, rank > 2, a dtype outside
    f32/f64/i32/i64 — run ``EllBackend``'s plain paths and are counted
    in ``stats["fallback_*"]``. There is no other fallback: a kernel that
    fails to build or launch raises.
    """
    pull_scans_all = False

    block_n: Optional[int] = None        # pull rows per CTA (None = tune)
    block_e: Optional[int] = None        # push edge chunk
    push_block_n: Optional[int] = None   # push destination-bin width
    push_strategy: Optional[str] = None  # push reduce ("scan" | "mxu")
    pull_frontier_cap: Optional[int] = None  # frontier-pull row capacity
    autotune: bool = True
    stats: dict = dataclasses.field(
        default_factory=lambda: {"kernel_pull": 0, "kernel_push": 0,
                                 "kernel_pull_frontier": 0,
                                 "skip_empty_pull": 0,
                                 "fallback_pull": 0, "fallback_push": 0,
                                 "pull_edges": 0, "fused_pull_update": 0,
                                 "row_layout_pulls": 0, "hub_slots": 0})
    _tuned: dict = dataclasses.field(default_factory=dict, repr=False)
    _plans: dict = dataclasses.field(default_factory=dict, repr=False)
    _layouts: dict = dataclasses.field(default_factory=dict, repr=False)
    # "rank": a weak reference to the rank the last narrow fused PPR
    # step wrote
    _narrow: dict = dataclasses.field(default_factory=dict, repr=False)

    # identity eq/hash: instances carry per-graph caches, and the engine
    # cache keys on the backend
    __hash__ = object.__hash__

    def __eq__(self, other):
        return self is other

    def telemetry_counters(self) -> dict:
        """``stats``: kernel launches by kind, empty pulls skipped,
        fallbacks to the plain paths, ``pull_edges``, the in-edge slots
        the kernel pulls read (``m`` a full scan, ``rows · d_ell`` a
        frontier pull, the host integers the Cost charge uses),
        ``fused_pull_update``, the full-scan pulls that ran with their
        program's update (counted in ``kernel_pull`` too),
        ``row_layout_pulls``, the kernel pulls (full scan and frontier,
        counted in ``kernel_pull`` and ``kernel_pull_frontier`` too) that
        read a row-layout graph's rows through its offsets, and
        ``hub_slots``, the in-edge slots the full-scan pulls read in hub
        pieces (the row plan's hub rows, on either layout)."""
        return dict(self.stats)

    def _mode(self, values, combine, msg_fn) -> Optional[str]:
        if combine not in ("sum", "max", "min"):
            return None
        if values.ndim not in (1, 2) or values.dtype not in KERNEL_DTYPES:
            return None
        return classify_msg_fn(msg_fn)

    def _cached(self, cache: dict, g: Graph, key, build: Callable):
        # keyed by (id(g), key) with a weakref guard against id reuse;
        # the entry goes when g does, so a shared backend keeps no plan
        # or layout of a graph nobody holds
        k = (id(g), key)
        hit = cache.get(k)
        if hit is not None and hit[0]() is g:
            return hit[1]
        with region("backend.build"):
            obj = build()
        cache[k] = (weakref.ref(g, lambda _, c=cache, k=k: c.pop(k, None)),
                    obj)
        return obj

    def push_plan(self, g: Graph, bin_n: int = DEFAULT_BIN_N):
        """The phase-1 bin layout of ``g`` for bins of ``bin_n``
        destinations, built once."""
        return self._cached(self._plans, g, bin_n, lambda: build_push_plan(
            g.coo_src, g.coo_dst, g.coo_w, g.n, bin_n))

    def pull_plan(self, g: Graph, width: int = 1):
        """The full-scan pull's row plan of ``g`` (rows sorted by
        in-degree class) for payloads of ``width`` columns, built once
        per column-lane count."""
        return self._cached(self._plans, g, ("rows", col_lanes(width)),
                            lambda: ell_row_plan(g.in_deg, g.n, g.d_ell,
                                                 width))

    def dual_layout(self, g: Graph):
        return self._cached(self._layouts, g, "dual",
                            lambda: build_dual_ell(g))

    def _tune(self, key: tuple, probe: Callable, default: Callable):
        if key not in self._tuned:
            self._tuned[key] = probe() if self.autotune else default()
        return self._tuned[key]

    @staticmethod
    def _probe_layout(g: Graph) -> tuple:
        """What the tuner probes: the graph's own pull layout."""
        idx, w, row_ptr = g.pull_arrays
        return (idx, w, g.in_deg, row_ptr)

    def _pull_block_n(self, g: Graph, values, combine, mode) -> int:
        if self.block_n is not None:
            return self.block_n
        width, dt = _width(values), values.dtype
        return self._tune(
            ("pull", g.n, g.d_ell, g.pull_layout, width, dt, combine, mode),
            lambda: tune.tune_pull(g.n, g.d_ell, width, dt, combine, mode,
                                   values.device,
                                   layout=self._probe_layout(g)),
            lambda: tune.pull_candidates(g.n)[0])

    def _pull_cap(self, g: Graph) -> int:
        if self.pull_frontier_cap is not None:
            return self.pull_frontier_cap
        return default_pull_cap(g.n, g.m, g.d_ell)

    def _pull_frontier_block(self, g: Graph, rows: int, values, combine,
                             mode) -> int:
        width, dt = _width(values), values.dtype
        return self._tune(
            ("pullf", g.n, g.d_ell, g.pull_layout, rows, width, dt, combine,
             mode),
            lambda: tune.tune_pull_frontier(
                g.n, g.d_ell, rows, width, dt, combine, mode, values.device,
                layout=self._probe_layout(g)),
            lambda: tune.pull_frontier_candidates(g.n, rows)[0])

    def push_blocks(self, g: Graph, values, combine,
                    mode) -> tuple[int, int, str]:
        """(block_e, bin width, strategy) of a push of ``values``: the
        pins, then the tuner's choice for the rest."""
        if (self.block_e is not None and self.push_block_n is not None
                and self.push_strategy is not None):
            return self.block_e, self.push_block_n, self.push_strategy
        width, dt = _width(values), values.dtype
        be, bn, strat = self._tune(
            ("push", g.n, g.m, width, dt, combine, mode),
            lambda: tune.tune_push(g.n, g.m, width, dt, combine, mode,
                                   values.device),
            lambda: tune.push_candidates(g.n, g.m)[0])
        # partial pins override only their own component; a pinned "mxu"
        # over a tuned bin takes at most the widest bin its kernel takes
        strat = self.push_strategy or strat
        if self.push_block_n is not None:
            bn = self.push_block_n
        elif strat == "mxu":
            bn = min(bn, MXU_MAX_BIN)
        return self.block_e or be, bn, strat

    def _pull_scan_stats(self, g: Graph, touched) -> tuple:
        """(edges_read, rows_written, count, fits) of a kernel pull with
        this touched set — the one formula behind both the prediction and
        the charge. The restriction pays only when the rows fit the cap
        and their gather (count × d_ell) undercuts the m-edge scan."""
        cnt = int(touched.sum())
        fits = 0 < cnt <= self._pull_cap(g) and cnt * g.d_ell < g.m
        if cnt == 0:
            edges, verts = 0, 0
        elif fits:
            edges, verts = cnt * g.d_ell, cnt
        else:
            edges, verts = g.m, g.n
        return edges, verts, cnt, fits

    def predict_pull_scan(self, g, touched, values=None, combine="sum",
                          msg_fn=None):
        if (touched is None or values is None
                or self._mode(values, combine, msg_fn) is None):
            return counter(g.m, g.device), counter(g.n, g.device)
        edges, verts, _, _ = self._pull_scan_stats(g, touched)
        return counter(edges, g.device), counter(verts, g.device)

    def _full_scan_plan(self, g: Graph, width: int):
        """The row plan of a full-scan kernel pull about to run, with the
        pull counted: ``kernel_pull``, ``hub_slots``, and on a row-layout
        graph ``row_layout_pulls``."""
        plan = self.pull_plan(g, width)
        self.stats["kernel_pull"] += 1
        self.stats["hub_slots"] += plan.hub_slots
        self.stats["row_layout_pulls"] += g.pull_layout == "rows"
        return plan

    def _full_scan(self, g: Graph, values, combine, mode):
        idx, w, row_ptr = g.pull_arrays
        with region("backend.pull"):
            return ell_spmv(pad_values(values), idx, w, combine=combine,
                            msg=mode,
                            block_n=self._pull_block_n(g, values, combine,
                                                       mode),
                            plan=self._full_scan_plan(g, _width(values)),
                            row_ptr=row_ptr)

    def pull(self, g, values, touched, combine, msg_fn, cost):
        mode = self._mode(values, combine, msg_fn)
        if mode is None:
            self.stats["fallback_pull"] += 1
            return super().pull(g, values, touched, combine, msg_fn, cost)
        width = _width(values)
        if touched is None:
            self.stats["pull_edges"] += g.m
            out = self._full_scan(g, values, combine, mode)
            return out, cost.charge(reads=counter(g.m, g.device) * width,
                                    writes=counter(g.n, g.device) * width)
        edges, verts, cnt, fits = self._pull_scan_stats(g, touched)
        self.stats["pull_edges"] += edges
        if cnt == 0:
            self.stats["skip_empty_pull"] += 1
            odt = _out_dtype(values.dtype, g.coo_w.dtype, mode, combine)
            out = torch.full((g.n,) + tuple(values.shape[1:]),
                             combine_identity(combine, odt), dtype=odt,
                             device=values.device)
        elif fits:
            self.stats["kernel_pull_frontier"] += 1
            self.stats["row_layout_pulls"] += g.pull_layout == "rows"
            with region("backend.pull_frontier"):
                layout = self.dual_layout(g)
                rows_n = min(max(8, 1 << (cnt - 1).bit_length()),
                             self._pull_cap(g))
                out = ell_pull_frontier_full(
                    pad_values(values), layout.in_idx, layout.in_w,
                    frontier_rows(touched, rows_n), combine=combine,
                    msg=mode,
                    block_r=self._pull_frontier_block(g, rows_n, values,
                                                      combine, mode),
                    row_len=g.in_deg, row_ptr=layout.in_ptr,
                    d_ell=g.d_ell)
        else:
            out = mask_untouched(self._full_scan(g, values, combine, mode),
                                 touched, combine)
        return out, cost.charge(reads=counter(edges * width, g.device),
                                writes=counter(verts * width, g.device))

    def pull_update(self, g, values_of, state, spec, cost, private=False):
        rank, base, resid = state["rank"], state["base"], state["resid"]
        if (spec[0] != "ppr" or rank.dtype != torch.float32
                or rank.ndim != 2):
            return None
        _, damp, tol = spec
        width = _width(rank)
        cols = None
        if width > PPR_STEP_MAX_WIDTH:
            # a wider batch fuses the steps whose still-active columns
            # fit the fused step: those columns alone (the others keep
            # their ranks and residuals, as the update leaves them)
            cols = torch.nonzero(resid >= tol).flatten()
            if not 0 < cols.numel() <= PPR_STEP_MAX_WIDTH:
                return None
        self.stats["pull_edges"] += g.m
        self.stats["fused_pull_update"] += 1
        idx, w, row_ptr = g.pull_arrays
        with region("backend.pull_update"):
            block_n = self._pull_block_n(g, rank, "sum", "copy")
            if cols is None:
                rank, resid = ell_spmv_ppr_step(
                    values_of(state), idx, w, base, rank, resid, damp=damp,
                    tol=tol, block_n=block_n,
                    plan=self._full_scan_plan(g, width), row_ptr=row_ptr)
            else:
                part = {"rank": rank.index_select(1, cols),
                        "base": base.index_select(1, cols),
                        "resid": resid.index_select(0, cols)}
                rank_c, resid_c = ell_spmv_ppr_step(
                    values_of(part), idx, w, part["base"], part["rank"],
                    part["resid"], damp=damp, tol=tol, block_n=block_n,
                    plan=self._full_scan_plan(g, cols.numel()),
                    row_ptr=row_ptr)
                # into the rank in place where this backend made it in
                # the loop's previous step, else into a copy, once
                mine = self._narrow.get("rank")
                if private and mine is not None and mine() is rank:
                    rank.index_copy_(1, cols, rank_c)
                else:
                    rank = rank.index_copy(1, cols, rank_c)
                    self._narrow["rank"] = weakref.ref(rank)
                resid = resid.index_copy(0, cols, resid_c)
        state = {"rank": rank, "base": base, "resid": resid}
        frontier = torch.ones((g.n,), dtype=torch.bool, device=rank.device)
        return state, frontier, (resid < tol).all(), cost.charge(
            reads=counter(g.m, g.device) * width,
            writes=counter(g.n, g.device) * width)

    def push(self, g, values, frontier, combine, msg_fn, cost):
        mode = self._mode(values, combine, msg_fn)
        if mode is None:
            self.stats["fallback_push"] += 1
            return super().push(g, values, frontier, combine, msg_fn, cost)
        self.stats["kernel_push"] += 1
        with region("backend.push"):
            if g.m:
                block_e, bin_n, strategy = self.push_blocks(
                    g, values, combine, mode)
                out = coo_push(values, frontier, g.coo_src, g.coo_dst,
                               g.coo_w, g.n, combine=combine, msg=mode,
                               plan=self.push_plan(g, bin_n),
                               strategy=strategy, block_e=block_e)
            else:
                out = coo_push(values, frontier, g.coo_src, g.coo_dst,
                               g.coo_w, g.n, combine=combine, msg=mode)
        k = frontier_out_edges(g, frontier)
        width = _width(values)
        # the binning pass reads and rewrites every edge once
        cost = cost.charge(reads=counter(g.m, g.device),
                           writes=counter(g.m, g.device))
        cost = cost.charge(reads=k * width).charge_combining_writes(
            k * width, float_data=values.dtype.is_floating_point)
        return out, cost


@dataclasses.dataclass(frozen=True, eq=False)
class DistributedBackend(ExchangeBackend):
    """DM k-relaxation over a 1D partition + PA split (paper §6).

    Local edges (both endpoints owned) are plain segment writes on the
    graph's device; only the cut crosses shards, by the combined-alltoall
    push or the all_gather pull over the mesh (``dist.collectives``).
    Build with :meth:`prepare`; the instance is graph-specific. ``n``
    need not divide by the shard count: the partition pads.

    Restriction: messages must be a function of the *wire value only*
    (``msg_fn(v, w)`` with masked sources carrying the combine identity),
    which holds for every algorithm in ``repro_torch.api``.
    """
    mesh: object = None
    part: object = None
    local: object = None          # edges grouped by owner (src==dst owner)
    remote_by_src: object = None  # cut edges grouped by src owner (push)
    remote_by_dst: object = None  # cut edges grouped by dst owner (pull)
    cut_edges: int = 0
    axis: str = "data"
    # the two cut groupings' rows on the shards' devices
    placed_src: tuple = ()
    placed_dst: tuple = ()

    # identity hash/eq: instances hold graph-sized tensors, and the
    # engine cache keys on the backend
    __hash__ = object.__hash__

    def __eq__(self, other):
        return self is other

    @classmethod
    def prepare(cls, g: Graph, mesh=None, num_parts: Optional[int] = None,
                axis: str = "data", devices=None) -> "DistributedBackend":
        """Partition ``g`` over ``mesh`` (default: ``make_shard_mesh(
        None, axis, devices)``, every CUDA device unless ``devices``
        lists others)."""
        from ..dist.collectives import place_edges
        from ..graphs.partition import (pa_regroup_by_dst, pa_split,
                                        partition_1d)
        from ..shard.mesh import make_shard_mesh
        if mesh is None:
            mesh = make_shard_mesh(None, axis=axis, devices=devices)
        if num_parts is None:
            num_parts = mesh.shape[axis]
        if num_parts != mesh.shape[axis]:
            raise ValueError(
                f"num_parts={num_parts} must equal the mesh '{axis}' axis "
                f"size ({mesh.shape[axis]}): the exchanges map partitions "
                "to mesh shards 1:1.")
        part = partition_1d(g.n, num_parts)
        local, remote_src, stats = pa_split(g, part)
        # only the cut needs the pull grouping; the local set and stats
        # are grouping-independent (local edges share one owner)
        remote_dst = pa_regroup_by_dst(part, remote_src, g.n)
        return cls(mesh=mesh, part=part, local=local,
                   remote_by_src=remote_src, remote_by_dst=remote_dst,
                   cut_edges=int(stats["cut_edges"]), axis=axis,
                   placed_src=place_edges(remote_src, mesh.devices),
                   placed_dst=place_edges(remote_dst, mesh.devices))

    # -- helpers -----------------------------------------------------------
    def _wire_msg_fn(self, msg_fn):
        # primitives treat msg_fn=None as "value, unweighted"; the
        # collectives default to value*weight — normalize
        return msg_fn if msg_fn is not None else (lambda v, w: v)

    # -- ExchangeBackend ---------------------------------------------------
    def push(self, g, values, frontier, combine, msg_fn, cost):
        from ..dist.collectives import pa_exchange, pad_rows
        ident = combine_identity(combine, values.dtype)
        fb = frontier.reshape((-1,) + (1,) * (values.ndim - 1))
        vpad = pad_rows(torch.where(fb, values, ident), self.part.n_padded,
                        ident)
        out, nbytes = pa_exchange(
            self.mesh, self.part, self.local, self.placed_src, vpad,
            direction="push", msg_fn=self._wire_msg_fn(msg_fn),
            combine=combine, axis=self.axis)
        k = frontier_out_edges(g, frontier)
        kc = torch.minimum(k, counter(self.cut_edges, g.device))
        cost = cost.charge(reads=k).charge_combining_writes(
            kc, float_data=values.dtype.is_floating_point)
        cost = cost.charge(messages=kc,
                           collective_bytes=nbytes * self.part.num_parts)
        return out[:g.n], cost

    def pull(self, g, values, touched, combine, msg_fn, cost):
        from ..dist.collectives import pa_exchange, pad_rows
        ident = combine_identity(combine, values.dtype)
        vpad = pad_rows(values, self.part.n_padded, ident)
        out, nbytes = pa_exchange(
            self.mesh, self.part, self.local, self.placed_dst, vpad,
            direction="pull", msg_fn=self._wire_msg_fn(msg_fn),
            combine=combine, axis=self.axis)
        out = out[:g.n]
        if touched is not None:
            out = mask_untouched(out, touched, combine)
            k = frontier_in_edges(g, touched)
            wr = touched.to(COUNTER).sum()
        else:
            k = counter(g.m, g.device)
            wr = counter(g.n, g.device)
        cost = cost.charge(reads=k, writes=wr,
                           collective_bytes=nbytes * self.part.num_parts)
        return out, cost

    def predict_comm_bytes(self, g, values, frontier):
        # exactly what push/pull charge: the combined alltoall moves
        # n_padded·itemsize per device, the all_gather
        # n_padded·itemsize·(P-1)/P, both times P devices
        Pn = self.part.num_parts
        npad = self.part.n_padded
        item = values.element_size()
        push_b = counter(npad * item, g.device) * Pn
        pull_b = counter(npad * item * (Pn - 1) // max(Pn, 1),
                         g.device) * Pn
        return push_b, pull_b
