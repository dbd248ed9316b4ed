"""repro_torch.service — batched multi-query graph serving. PyTorch port
of ``repro.service``.

Many concurrent queries of the source-parameterized algorithms (BFS,
Δ-stepping SSSP, personalized PageRank) ride as payload columns through
one shared engine run:

  * :mod:`~repro_torch.service.programs` — batched programs
    (:class:`BatchSpec` registry) over ``[n, B]`` state with a union
    frontier;
  * :mod:`~repro_torch.service.batch` — ``solve_batch`` (also
    ``api.solve_batch``);
  * :mod:`~repro_torch.service.scheduler` — :class:`QueryService`:
    submit/poll over fixed query slots refilled as queries finish,
    grouping, in-flight coalescing, deadlines, a bounded queue and an
    LRU :class:`ResultCache`;
  * :mod:`~repro_torch.service.bench` — the throughput harness
    (sequential solves against ``solve_batch``, ``service_*`` rows).
"""

from .batch import BatchResult, solve_batch
from .cache import ResultCache, graph_fingerprint
from .programs import (BatchSpec, batchable, get_batch_spec,
                       register_batch)
from .scheduler import QueryService

__all__ = ["solve_batch", "BatchResult", "BatchSpec", "register_batch",
           "batchable", "get_batch_spec", "QueryService", "ResultCache",
           "graph_fingerprint"]
