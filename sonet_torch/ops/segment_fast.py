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
``point0_idx``, and the empty nodes' cotangent goes there too.

Under a mesh whose ``points`` axis is split (``parallel/``), each rank
holds its (B/D, kN/P, C) block of the stacked points, sorted locally by
node: the kernel runs on that block and an all-reduce MAX over ``points``
combines the partial maxima (``windowed_vals_sharded``; the JAX package's
``shard_map`` + ``lax.pmax``).  The output is (B/D, M, C), the same on
every points rank.  ORIGINAL stacked point 0 lives on points rank 0, at
``point0_idx`` there; its feature reaches the other ranks by broadcast.
The backward is ``route_max_grad`` with the tie counts summed over
``points`` (ties split the cotangent over the whole node), and the empty
nodes' cotangent goes only to the rank holding point 0.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel import collectives
from .cuda.segment_max_window import windowed_vals
from .segment import route_max_grad, segment_counts


def windowed_vals_sharded(data: torch.Tensor, seg_ids: torch.Tensor,
                          num_segments: int,
                          local_vals=windowed_vals) -> torch.Tensor:
    """``windowed_vals`` under the mesh in effect: kernel 1 on this rank's
    block, then an all-reduce MAX over ``points``.  f32 (B/D, M, C),
    empties at -3e38, equal on every points rank.  ``local_vals`` is the
    per-rank reduction (the kernel, or ``ops.segment.scatter_vals`` for
    the scatter pooling)."""
    vals = local_vals(data, seg_ids, num_segments)
    return collectives.all_reduce(vals, ("points",), op=dist.ReduceOp.MAX)


class _PointsMax(torch.autograd.Function):
    """The per-node maxima over the whole mesh row, differentiable in
    ``data``; empty nodes read -3e38 and get no cotangent here (their
    patch is ``broadcast_points0``'s)."""

    @staticmethod
    def forward(ctx, data, seg_ids, counts, num_segments, local_vals):
        vals = windowed_vals_sharded(data, seg_ids, num_segments, local_vals)
        ctx.mesh = collectives.active()     # the backward's, as the forward's
        ctx.save_for_backward(data, seg_ids, counts, vals)
        return vals

    @staticmethod
    def backward(ctx, g):
        data, seg_ids, counts, vals = ctx.saved_tensors
        with collectives.use_mesh(ctx.mesh):
            grad = route_max_grad(data, seg_ids, vals.to(data.dtype),
                                  counts, g, tie_axes=("points",))
        return grad, None, None, None, None


def segment_max_sharded(data, seg_ids, num_segments, counts, point0_idx,
                        local_vals=windowed_vals):
    """Segment max of this rank's part of the points under the mesh in
    effect (see the module docstring); ``counts`` is the global (B/D, M)
    occupancy (summed over ``points`` here when None)."""
    if counts is None:
        counts = collectives.reduce_points(
            segment_counts(seg_ids, num_segments))
    vals = _PointsMax.apply(data, seg_ids, counts, num_segments, local_vals)
    batch = torch.arange(data.shape[0], device=data.device)
    p0 = (data[:, 0] if point0_idx is None
          else data[batch, point0_idx.long()])
    # point 0 is points rank 0's; the others' rows are replaced
    p0 = collectives.broadcast_points0(p0.float())[:, None, :]
    empty = (counts == 0)[..., None]
    return torch.where(empty, p0, vals).to(data.dtype)


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
                     point0_idx: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Segment max (B, N, C) x (B, N) -> (B, M, C) in ``data.dtype``.

    Fastest when ``seg_ids`` are sorted ascending per batch; correct for
    any ids.  ``counts``: optional precomputed (B, M) occupancy.
    ``point0_idx``: optional (B,) position whose feature empty nodes
    take (default position 0).  Differentiable in ``data``.  Under a mesh
    in effect whose ``points`` axis is split, the inputs are this rank's
    block, ``counts`` the global occupancy and ``point0_idx`` read on
    points rank 0 (module docstring).
    """
    if collectives.axis_size("points") > 1:
        return segment_max_sharded(data, seg_ids, num_segments, counts,
                                   point0_idx)
    if counts is None:
        counts = segment_counts(seg_ids, num_segments)
    return _SegmentMaxFast.apply(data, seg_ids, counts, point0_idx,
                                 num_segments)
