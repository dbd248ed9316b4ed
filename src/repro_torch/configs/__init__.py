"""Architecture configs, shape sets and the cell registry (port of
``repro.configs``)."""

from .archs import ALL_ARCHS, ARCH_FAMILY, full_config, smoke_config
from .shapes import LM_SHAPES, GNN_SHAPES, RECSYS_SHAPES, shape_table
from .registry import all_cells, build_cell

__all__ = [
    "ALL_ARCHS", "ARCH_FAMILY", "full_config", "smoke_config",
    "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "shape_table",
    "all_cells", "build_cell",
]
