"""Geometry and reduction ops of the port (counterparts of the JAX
package's ``ops``).  Plain tensor code is PyTorch; the JAX package's
Pallas kernels become CUDA kernels under ``ops.cuda``."""

from .gather import knn_gather
from .pairwise import (TopKAssign, assign_topk, knn, one_hot, one_hot_f32,
                       pairwise_sqdist)
from .segment import segment_counts, segment_max
from .segment_fast import segment_max_fast
from .cuda.segment_max_window import (segment_max_windowed, windowed_vals,
                                      windowed_vals_plain)

__all__ = [
    "pairwise_sqdist", "knn", "assign_topk", "one_hot", "one_hot_f32",
    "TopKAssign", "knn_gather", "segment_counts", "segment_max",
    "segment_max_fast", "segment_max_windowed", "windowed_vals",
    "windowed_vals_plain",
]
