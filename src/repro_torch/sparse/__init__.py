from .embedding import embedding_bag, one_hot_matmul_lookup
from .segment import (count_segments, reduce_identity, segment_logsumexp,
                      segment_max, segment_mean, segment_min,
                      segment_softmax, segment_sum)

__all__ = ["segment_sum", "segment_min", "segment_max", "segment_mean",
           "segment_softmax", "segment_logsumexp", "count_segments",
           "reduce_identity", "embedding_bag", "one_hot_matmul_lookup"]
