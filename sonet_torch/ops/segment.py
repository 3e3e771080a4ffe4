"""Node pooling by scatter, with the matmul-routed gradient (port of the
JAX package's ``ops/segment.py``).

Empty-node semantics: an empty node takes the feature of stacked point 0,
as the reference gathers with ``gather_index * mask_row_max``, and the
gradient of that gather flows back to point 0.

``segment_max`` (also named ``segment_max_scatter``, as in the JAX
package) and ``segment_max_fast`` (``ops/segment_fast.py``) are one
``torch.autograd.Function``, ``_NodeMax``, given another reduction:
``scatter_max`` here, the kernel's ``windowed_vals`` there.  Its backward
is ``route_max_grad``, the operator ``sonet_torch::segment_max_grad``
(``ops/cuda/segment_max_grad.py``): each output cotangent goes back to
the winning point(s) through a winner-equality mask.  On exact ties the
cotangent is split equally among the winners (sum-preserving), as in the
JAX package.  Its plain version, ``route_max_grad_plain``, routes through
one-hot products as the JAX package does; it is what the CPU runs, and
the CUDA kernels of ``csrc/segment_max_grad.cu`` compute the same bits on
a card.

``segment_max_onehot``, ``segment_sum_onehot`` and ``segment_mean_onehot``
are the JAX package's one-hot formulations, kept as oracles (no path
calls them; the encoder's cluster mean is the product
``segment_sum_onehot`` writes out).
"""

from __future__ import annotations

import torch

from ..parallel import collectives
from .cuda.segment_max_grad import segment_max_grad as route_max_grad


def segment_counts(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(B, N) int ids -> (B, M) int32 counts.  Ids outside ``[0, M)`` are
    not counted, as with the JAX package's one-hot reduce."""
    classes = torch.arange(num_segments, device=seg_ids.device,
                           dtype=seg_ids.dtype)
    return (seg_ids[..., None] == classes).sum(1, dtype=torch.int32)


def point0_rows(data: torch.Tensor,
                point0_idx: torch.Tensor | None) -> torch.Tensor:
    """(B, 1, C): the row of ``data`` (B, N, C) each cloud's empty nodes
    take, at ``point0_idx`` (B,) (position 0 when None)."""
    if point0_idx is None:
        return data[:, 0:1]
    batch = torch.arange(data.shape[0], device=data.device)
    return data[batch, point0_idx.long()][:, None]


def fill_empty(vals: torch.Tensor, counts: torch.Tensor, p0: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The per-node maxima ``vals`` (B, M, C) with each empty node's row
    (``counts`` (B, M) zero) replaced by ``p0`` (B, 1, C), in ``dtype``."""
    empty = (counts == 0)[..., None]
    return torch.where(empty, p0.to(vals.dtype), vals).to(dtype)


def scatter_max(data: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-node maxima (B, M, C) by scatter in ``data.dtype``; an empty
    node reads 0, an all -inf node -inf, as in the JAX package's
    ``segment_max_scatter``."""
    B, N, C = data.shape
    idx = seg_ids.long()[..., None].expand(B, N, C)
    out = torch.zeros(B, num_segments, C, dtype=data.dtype, device=data.device)
    return out.scatter_reduce(1, idx, data, reduce="amax", include_self=False)


def scatter_vals(data: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """The scatter counterpart of ``windowed_vals``: f32 (B, M, C) per-node
    maxima, -3e38 for an empty node."""
    B, N, C = data.shape
    idx = seg_ids.long()[..., None].expand(B, N, C)
    out = torch.full((B, num_segments, C), -3.0e38, dtype=torch.float32,
                     device=data.device)
    return out.scatter_reduce(1, idx, data.float(), reduce="amax",
                              include_self=True)


class _NodeMax(torch.autograd.Function):
    """Node pooling on one process: ``vals(data, seg_ids, M)`` makes the
    per-node maxima (``scatter_max`` or the kernel's ``windowed_vals``),
    empty nodes take ``point0_rows`` (``counts`` made here when None),
    and the backward is ``route_max_grad``."""

    @staticmethod
    def forward(ctx, data, seg_ids, counts, point0_idx, num_segments, vals):
        if counts is None:
            counts = segment_counts(seg_ids, num_segments)
        out = fill_empty(vals(data, seg_ids, num_segments), counts,
                         point0_rows(data, point0_idx), data.dtype)
        ctx.save_for_backward(data, seg_ids, counts, point0_idx, out)
        return out

    @staticmethod
    def backward(ctx, g):
        data, seg_ids, counts, point0_idx, out = ctx.saved_tensors
        grad = route_max_grad(data, seg_ids, out, counts, g,
                              point0_idx=point0_idx)
        # ids, counts and point0_idx get no gradient
        return grad, None, None, None, None, None


def segment_max(data: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int, *, counts: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Segment max by scatter: data (B, N, C), seg_ids (B, N) -> (B, M, C)
    in ``data.dtype``; an empty node takes data[:, 0].  Differentiable in
    ``data`` through ``route_max_grad``.  Under a mesh in effect whose
    ``points`` axis is split, ``data`` is this rank's part of the points, ``counts``
    the global (B, M) occupancy, and the maxima are combined over the
    ranks as ``ops.segment_fast.segment_max_fast`` combines its kernel's
    (``scatter_vals`` in the kernel's place)."""
    if collectives.axis_size("points") > 1:
        from .segment_fast import segment_max_sharded
        return segment_max_sharded(data, seg_ids, num_segments, counts,
                                   None, scatter_vals)
    return _NodeMax.apply(data, seg_ids, counts, None, num_segments,
                          scatter_max)


segment_max_scatter = segment_max


def segment_max_onehot(data: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int,
                       counts: torch.Tensor | None = None,
                       block_m: int = 16) -> torch.Tensor:
    """Segment max as a masked broadcast, ``block_m`` nodes at a time: the
    reference's formulation, differentiable by autograd (ties share the
    cotangent equally).  data (B, N, C), seg_ids (B, N) -> (B, M, C) in
    ``data.dtype``; an empty node takes data[:, 0]."""
    M = num_segments
    if counts is None:
        counts = segment_counts(seg_ids, M)
    ids = seg_ids[:, :, None]
    blocks = []
    for m0 in range(0, M, block_m):
        nodes = torch.arange(m0, m0 + block_m, device=seg_ids.device,
                             dtype=seg_ids.dtype)
        masked = torch.where((ids == nodes)[..., None], data[:, :, None, :],
                             -1e10)
        blocks.append(masked.amax(1))
    return fill_empty(torch.cat(blocks, 1)[:, :M], counts, data[:, 0:1],
                      data.dtype)


def segment_sum_onehot(data: torch.Tensor, onehot: torch.Tensor
                       ) -> torch.Tensor:
    """Segment sum as a product with a one-hot mask: data (B, N, C),
    onehot (B, N, M) -> (B, M, C) float32."""
    return torch.einsum("...nm,...nc->...mc", onehot.float(), data.float())


def segment_mean_onehot(data: torch.Tensor, onehot: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """Per-node mean, sum / (count + eps), the reference's cluster mean."""
    cnt = onehot.float().sum(-2)[..., None]
    return segment_sum_onehot(data, onehot) / (cnt + eps)
