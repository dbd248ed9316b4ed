from .bfs import bfs_init, bfs_program
from .pagerank import pagerank_init, pagerank_program
from .ppr import ppr_finalize, ppr_init, ppr_program
from .sssp_delta import (sssp_delta_finalize, sssp_delta_init,
                         sssp_delta_program)

__all__ = ["bfs_program", "bfs_init", "pagerank_program", "pagerank_init",
           "ppr_program", "ppr_init", "ppr_finalize",
           "sssp_delta_program", "sssp_delta_init", "sssp_delta_finalize"]
