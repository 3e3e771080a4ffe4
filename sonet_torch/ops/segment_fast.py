"""Production node pooling: the CUDA windowed segment-max kernel plus the
empty-node patch (port of the forward of the JAX package's
``ops/segment_fast.py``).

The encoder sorts the stacked points by node once per forward; the
kernel (``ops/cuda/segment_max_window.py``) reduces the sorted rows to
per-node maxima.  Empty-node parity: the reference forwards the feature
of ORIGINAL stacked point 0 to empty nodes; in sorted order that point
sits at ``point0_idx``.  The gradient (the routed equality mask as a
``torch.autograd.Function``) and the points-axis mesh path arrive with
later slices.
"""

from __future__ import annotations

import torch

from .cuda.segment_max_window import windowed_vals
from .segment import segment_counts


def segment_max_fast(data: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int, *,
                     counts: torch.Tensor | None = None,
                     point0_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Segment max (B, N, C) x (B, N) -> (B, M, C) in ``data.dtype``.

    Fastest when ``seg_ids`` are sorted ascending per batch; correct for
    any ids.  ``counts``: optional precomputed (B, M) occupancy.
    ``point0_idx``: optional (B,) position whose feature empty nodes
    take (default position 0).
    """
    if counts is None:
        counts = segment_counts(seg_ids, num_segments)
    vals = windowed_vals(data, seg_ids, num_segments)     # f32, empties -3e38
    empty = (counts == 0)[..., None]                      # (B, M, 1)
    if point0_idx is None:
        p0 = data[:, 0:1, :]
    else:
        batch = torch.arange(data.shape[0], device=data.device)
        p0 = data[batch, point0_idx.long()][:, None, :]
    return torch.where(empty, p0.float(), vals).to(data.dtype)
