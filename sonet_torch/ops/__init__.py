"""Geometry and reduction ops of the port (counterparts of the JAX
package's ``ops``).  Plain tensor code is PyTorch; the JAX package's
Pallas kernels become CUDA kernels under ``ops.cuda``."""

from .chamfer import ChamferResult, chamfer, robust_norm
from .gather import gather_by_segment, knn_gather, permute_points
from .iou import PART_LABEL, PART_TABLE, compute_iou, iou_per_shape
from .pairwise import (TopKAssign, assign_topk, knn, one_hot, one_hot_f32,
                       pairwise_sqdist)
from .segment import route_max_grad, segment_counts, segment_max
from .segment_fast import segment_max_fast
from .cuda.segment_argmax import (segment_argmax, segment_argmax_plain,
                                  segment_max_argmax)
from .cuda.segment_max_window import (segment_max_windowed, windowed_vals,
                                      windowed_vals_plain)

__all__ = [
    "pairwise_sqdist", "knn", "assign_topk", "one_hot", "one_hot_f32",
    "TopKAssign", "knn_gather", "permute_points", "gather_by_segment",
    "compute_iou", "iou_per_shape", "PART_LABEL", "PART_TABLE",
    "segment_counts", "segment_max",
    "route_max_grad", "segment_max_fast", "segment_max_windowed",
    "windowed_vals", "windowed_vals_plain", "segment_argmax",
    "segment_argmax_plain", "segment_max_argmax", "chamfer", "robust_norm",
    "ChamferResult",
]
