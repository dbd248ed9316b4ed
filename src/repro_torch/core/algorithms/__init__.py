from .pagerank import (pagerank, pagerank_pa, PageRankResult,
                       pagerank_program, pagerank_init)
from .triangle_count import (triangle_count, TriangleCountResult,
                             triangle_program, triangle_init,
                             triangle_finalize)
from .bfs import bfs, BFSResult, bfs_program, bfs_init
from .sssp_delta import (sssp_delta, SSSPResult, sssp_delta_program,
                         sssp_delta_init, sssp_delta_finalize)
from .betweenness import (betweenness_centrality, BCResult,
                          betweenness_program, betweenness_init,
                          betweenness_finalize)
from .coloring import (boman_coloring, fe_coloring, greedy_sequential,
                       conflict_removal_coloring, ColoringResult,
                       validate_coloring, coloring_program, coloring_init,
                       coloring_finalize)
from .mst_boruvka import (boruvka_mst, MSTResult, mst_program, mst_init,
                          mst_finalize)
from .ppr import (personalized_pagerank, PPRResult, ppr_program,
                  ppr_init, ppr_finalize)
from .wcc import wcc, WCCResult, wcc_program, wcc_init
from .pr_delta import (pagerank_delta, PRDeltaResult, pr_delta_program,
                       pr_delta_init, pr_delta_finalize)

__all__ = [
    "bfs", "BFSResult", "sssp_delta", "SSSPResult",
    "personalized_pagerank", "PPRResult",
    "wcc", "WCCResult", "pagerank_delta", "PRDeltaResult",
    "pagerank", "pagerank_pa", "PageRankResult",
    "triangle_count", "TriangleCountResult",
    "betweenness_centrality", "BCResult",
    "boman_coloring", "fe_coloring", "greedy_sequential",
    "conflict_removal_coloring", "ColoringResult", "validate_coloring",
    "boruvka_mst", "MSTResult",
    "bfs_program", "bfs_init", "pagerank_program", "pagerank_init",
    "wcc_program", "wcc_init", "pr_delta_program", "pr_delta_init",
    "pr_delta_finalize", "sssp_delta_program", "sssp_delta_init",
    "sssp_delta_finalize", "betweenness_program", "betweenness_init",
    "betweenness_finalize", "coloring_program", "coloring_init",
    "coloring_finalize", "mst_program", "mst_init", "mst_finalize",
    "triangle_program", "triangle_init", "triangle_finalize",
    "ppr_program", "ppr_init", "ppr_finalize",
]
