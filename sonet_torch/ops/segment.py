"""Node pooling by scatter, with the matmul-routed gradient (port of the
JAX package's ``ops/segment.py``).

Empty-node semantics: an empty node takes the feature of stacked point 0,
as the reference gathers with ``gather_index * mask_row_max``, and the
gradient of that gather flows back to point 0.

``segment_max`` (also named ``segment_max_scatter``, as in the JAX
package) is a ``torch.autograd.Function`` whose backward is
``route_max_grad``: each output cotangent goes back to the winning
point(s) through a winner-equality mask.  On exact ties the cotangent is
split equally among the winners (sum-preserving), as in the JAX package.
``segment_max_fast`` (``ops/segment_fast.py``) shares the backward.  Its
plain version, ``route_max_grad_plain``, routes through one-hot products
as the JAX package does; it is what the CPU runs, and the CUDA kernels of
``csrc/segment_max_grad.cu`` compute the same bits on a card.

``segment_max_onehot``, ``segment_sum_onehot`` and ``segment_mean_onehot``
are the JAX package's one-hot formulations, kept as oracles (no path
calls them; the encoder's cluster mean is the product
``segment_sum_onehot`` writes out).
"""

from __future__ import annotations

import torch

from .pairwise import one_hot


def segment_counts(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(B, N) int ids -> (B, M) int32 counts.  Ids outside ``[0, M)`` are
    not counted, as with the JAX package's one-hot reduce."""
    classes = torch.arange(num_segments, device=seg_ids.device,
                           dtype=seg_ids.dtype)
    return (seg_ids[..., None] == classes).sum(1, dtype=torch.int32)


def _take_rows(table: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    """table (B, M, C) rows by id -> (B, N, C); an id outside ``[0, M)``
    reads a zero row, as its zero one-hot row does in the JAX package."""
    M, C = table.shape[1], table.shape[2]
    inside = (seg_ids >= 0) & (seg_ids < M)
    idx = torch.where(inside, seg_ids, 0).long()[..., None].expand(-1, -1, C)
    rows = torch.gather(table, 1, idx)
    return rows * inside[..., None].to(rows.dtype)


def route_max_grad(data: torch.Tensor, seg_ids: torch.Tensor,
                   out: torch.Tensor, counts: torch.Tensor, g: torch.Tensor,
                   point0_idx: torch.Tensor | None = None,
                   tie_axes=()) -> torch.Tensor:
    """Gradient of a segment max with respect to ``data``: the operator
    ``sonet_torch::segment_max_grad`` (``ops/cuda/segment_max_grad.py``),
    which runs ``route_max_grad_plain`` on the CPU and the kernels of
    ``csrc/segment_max_grad.cu`` on a CUDA device.  ``tie_axes``: the mesh
    axes over which the tie counts are summed (``reduce_ties`` below)."""
    from .cuda.segment_max_grad import segment_max_grad
    return segment_max_grad(data, seg_ids, out, counts, g, point0_idx,
                            tie_axes)


def route_max_grad_plain(data: torch.Tensor, seg_ids: torch.Tensor,
                         out: torch.Tensor, counts: torch.Tensor,
                         g: torch.Tensor,
                         point0_idx: torch.Tensor | None = None,
                         reduce_ties=None) -> torch.Tensor:
    """Gradient of a segment max with respect to ``data`` (B, N, C), given
    the forward's output ``out`` (B, M, C) in ``data.dtype``, the node
    ``counts`` (B, M) and the output cotangent ``g`` (B, M, C).

    The winner mask is ``data == out`` at each point's node: exact, since
    ``out`` holds values taken from ``data``.  Ties split the cotangent
    equally (tie counts rounded before the division).  An empty node
    forwarded the feature at ``point0_idx`` (B,) (default position 0), so
    its cotangent goes there.  bf16 data routes through bf16 one-hot
    products (exact: one 1.0 per row), float32 data through gathers.

    Under a points mesh (``ops.segment_fast.windowed_vals_sharded``)
    ``data`` is this rank's part of the points and ``reduce_ties`` sums
    the (B, M, C) tie counts over the ``points`` ranks, since ties split
    the cotangent over the whole node, not over this rank's slice.
    """
    M = out.shape[1]
    bf16 = data.dtype == torch.bfloat16
    if bf16:
        onehot = one_hot(seg_ids, M, torch.bfloat16)          # (B, N, M)
        out_pp = torch.bmm(onehot, out.to(torch.bfloat16))
    else:
        onehot = one_hot(seg_ids, M, torch.float32)
        out_pp = _take_rows(out, seg_ids)
    # 0/1 entries are exact in bf16, halving the (B, N, C) mask traffic
    eq = (data == out_pp).to(data.dtype)
    # tie counts per (node, channel), summed in float32 and rounded so
    # that the division below is exact
    ties = torch.round(torch.bmm(onehot.float().transpose(1, 2), eq.float()))
    if reduce_ties is not None:
        ties = reduce_ties(ties)
    empty = (counts == 0)[..., None]                          # (B, M, 1)
    g = g.float()
    # divide per node before routing: one (B, N, C) product, not two
    ratio = torch.where(empty, 0.0, g) / torch.clamp_min(ties, 1.0)
    if bf16:
        ratio_pp = torch.bmm(onehot, ratio.to(torch.bfloat16))  # bf16 out
    else:
        ratio_pp = _take_rows(ratio, seg_ids)
    grad = eq * ratio_pp
    # empty nodes forwarded the point-0 feature: their cotangent goes there
    g_empty = torch.where(empty, g, 0.0).sum(1).to(grad.dtype)  # (B, C)
    batch = torch.arange(data.shape[0], device=data.device)
    p0 = (torch.zeros_like(batch) if point0_idx is None
          else point0_idx.long())
    grad[batch, p0] += g_empty
    return grad.to(data.dtype)


def _empty_patch(out: torch.Tensor, data: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """An empty node -> the feature of point 0."""
    return torch.where((counts == 0)[..., None], data[:, 0:1, :], out)


def _segment_max_forward(data, seg_ids, num_segments):
    """Scatter max (B, M, C) in ``data.dtype``, empty node -> data[:, 0],
    and the int32 counts."""
    B, N, C = data.shape
    idx = seg_ids.long()[..., None].expand(B, N, C)
    out = torch.zeros(B, num_segments, C, dtype=data.dtype, device=data.device)
    # include_self=False: empty nodes keep the 0 they were cleared to
    out = out.scatter_reduce(1, idx, data, reduce="amax", include_self=False)
    counts = segment_counts(seg_ids, num_segments)
    return _empty_patch(out, data, counts), counts


class _SegmentMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg_ids, num_segments):
        out, counts = _segment_max_forward(data, seg_ids, num_segments)
        ctx.save_for_backward(data, seg_ids, out, counts)
        return out

    @staticmethod
    def backward(ctx, g):
        data, seg_ids, out, counts = ctx.saved_tensors
        return route_max_grad(data, seg_ids, out, counts, g), None, None


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
    from ..parallel import collectives
    if collectives.axis_size("points") > 1:
        from .segment_fast import segment_max_sharded
        return segment_max_sharded(data, seg_ids, num_segments, counts,
                                   None, scatter_vals)
    return _SegmentMax.apply(data, seg_ids, num_segments)


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
    return _empty_patch(torch.cat(blocks, 1)[:, :M], data, counts)


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
