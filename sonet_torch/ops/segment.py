"""Node pooling by scatter (port of the forward of the JAX package's
``ops/segment.py``).

Empty-node semantics: an empty node takes the feature of stacked point 0,
as the reference gathers with ``gather_index * mask_row_max``.  Only the
forward is ported so far: the gradient routing (``route_max_grad``)
comes with training.
"""

from __future__ import annotations

import torch


def segment_counts(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(B, N) int ids -> (B, M) int32 counts.  Ids outside ``[0, M)`` are
    not counted, as with the JAX package's one-hot reduce."""
    classes = torch.arange(num_segments, device=seg_ids.device,
                           dtype=seg_ids.dtype)
    return (seg_ids[..., None] == classes).sum(1, dtype=torch.int32)


def segment_max(data: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Segment max by scatter: data (B, N, C), seg_ids (B, N) -> (B, M, C)
    in ``data.dtype``; an empty node takes data[:, 0]."""
    B, N, C = data.shape
    idx = seg_ids.long()[..., None].expand(B, N, C)
    out = torch.zeros(B, num_segments, C, dtype=data.dtype, device=data.device)
    # include_self=False: empty nodes keep the 0 they were cleared to
    out = out.scatter_reduce(1, idx, data, reduce="amax", include_self=False)
    empty = (segment_counts(seg_ids, num_segments) == 0)[..., None]
    return torch.where(empty, data[:, 0:1, :], out)
