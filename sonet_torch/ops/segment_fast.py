"""Production node pooling: the CUDA windowed segment-max kernel plus the
empty-node patch, with the matmul-routed gradient (port of the JAX
package's ``ops/segment_fast.py``).

The encoder sorts the stacked points by node once per forward; the
kernel (``ops/cuda/segment_max_window.py``) reduces the sorted rows to
per-node maxima.  The kernel fills its output through a raw pointer, so
autograd cannot see through it: ``segment_max_fast`` is a
``torch.autograd.Function`` whose backward is ``route_max_grad``
(``ops/segment.py``), as the JAX package's ``custom_vjp`` is.  On the CPU
the same Function runs with the kernel's plain version in the forward, so
the CPU tests exercise the backward the card runs.

Empty-node parity: the reference forwards the feature of ORIGINAL stacked
point 0 to empty nodes; in sorted order that point sits at
``point0_idx``, and the empty nodes' cotangent goes there too.  The
points-axis mesh path arrives with a later slice.
"""

from __future__ import annotations

import torch

from .cuda.segment_max_window import windowed_vals
from .segment import route_max_grad, segment_counts


class _SegmentMaxFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg_ids, counts, point0_idx, num_segments):
        vals = windowed_vals(data, seg_ids, num_segments)  # f32, empties -3e38
        empty = (counts == 0)[..., None]                    # (B, M, 1)
        if point0_idx is None:
            p0 = data[:, 0:1, :]
        else:
            batch = torch.arange(data.shape[0], device=data.device)
            p0 = data[batch, point0_idx.long()][:, None, :]
        out = torch.where(empty, p0.float(), vals).to(data.dtype)
        ctx.save_for_backward(data, seg_ids, counts, point0_idx, out)
        return out

    @staticmethod
    def backward(ctx, g):
        data, seg_ids, counts, point0_idx, out = ctx.saved_tensors
        grad = route_max_grad(data, seg_ids, out, counts, g,
                              point0_idx=point0_idx)
        # ids, counts and point0_idx get no gradient
        return grad, None, None, None, None


def segment_max_fast(data: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int, *,
                     counts: torch.Tensor | None = None,
                     point0_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Segment max (B, N, C) x (B, N) -> (B, M, C) in ``data.dtype``.

    Fastest when ``seg_ids`` are sorted ascending per batch; correct for
    any ids.  ``counts``: optional precomputed (B, M) occupancy.
    ``point0_idx``: optional (B,) position whose feature empty nodes
    take (default position 0).  Differentiable in ``data``.
    """
    if counts is None:
        counts = segment_counts(seg_ids, num_segments)
    return _SegmentMaxFast.apply(data, seg_ids, counts, point0_idx,
                                 num_segments)
