from .embedding import embedding_bag, one_hot_matmul_lookup
from .segment import reduce_identity, segment_max, segment_min, segment_sum

__all__ = ["segment_sum", "segment_min", "segment_max", "reduce_identity",
           "embedding_bag", "one_hot_matmul_lookup"]
