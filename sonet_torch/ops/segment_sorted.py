"""Sorted-segment max: node pooling without a scatter, for node-sorted ids
(port of the JAX package's ``ops/segment_sorted.py``; an oracle: no path
of either package calls it, and on the card ``chip_smoke.py`` holds
kernel 1 equal to it).

With the ids sorted along the points the segment max is

* forward: a segmented running max along the points (a doubling scan:
  log2(N) passes, each the max of a point and the point ``s`` before it
  when both are in one node), read at each node's last point, found by
  ``searchsorted``;
* backward: each node's cotangent routed back to its winners through an
  equality mask: two gathers, one compare and one one-hot product for the
  tie counts.

Against the reference's index_max and gather: values and the empty-node
rule (an empty node takes point 0's feature, and its cotangent goes
there) are the same; on exact ties the reference gives the whole
cotangent to the first winner, where this splits it equally among them
(the sum is kept; ties need bit-equal activations).
"""

from __future__ import annotations

import torch

from .pairwise import one_hot
from .segment import _take_rows


def _segmented_scan_max(ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Inclusive running max along axis 1 within each run of equal sorted
    ids: ids (B, N), vals (B, N, C) -> (B, N, C)."""
    out = vals
    s, n = 1, ids.shape[1]
    while s < n:
        same = (ids[:, s:] == ids[:, :-s])[..., None]
        tail = torch.where(same, torch.maximum(out[:, s:], out[:, :-s]),
                           out[:, s:])
        out = torch.cat([out[:, :s], tail], 1)
        s *= 2
    return out


def _bounds(ids: torch.Tensor, num_segments: int):
    """Per node of sorted ids (B, N): (index of its last point, clipped to
    0 for a node before any point; its count), each (B, M) int64."""
    nodes = torch.arange(num_segments, device=ids.device,
                         dtype=ids.dtype).expand(ids.shape[0], -1)
    ids = ids.contiguous()
    right = torch.searchsorted(ids, nodes.contiguous(), right=True)
    left = torch.searchsorted(ids, nodes.contiguous(), right=False)
    return torch.clamp_min(right - 1, 0), right - left


def _forward(data, seg_ids, num_segments):
    scanned = _segmented_scan_max(seg_ids, data)
    ends, counts = _bounds(seg_ids, num_segments)
    gathered = torch.gather(
        scanned, 1, ends[..., None].expand(-1, -1, data.shape[2]))
    empty = (counts == 0)[..., None]                      # (B, M, 1)
    return torch.where(empty, data[:, 0:1, :], gathered), empty


class _SegmentMaxSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, seg_ids, num_segments):
        out, empty = _forward(data, seg_ids, num_segments)
        ctx.save_for_backward(data, seg_ids, out, empty)
        return out

    @staticmethod
    def backward(ctx, g):
        data, seg_ids, out, empty = ctx.saved_tensors
        M = out.shape[1]
        out_pp = _take_rows(out, seg_ids)                 # (B, N, C)
        g_pp = _take_rows(torch.where(empty, 0.0, g), seg_ids)
        eq = (data == out_pp).to(data.dtype)              # the winners
        # tie counts per (node, channel): exact 0/1 products, f32 sums
        ties = torch.bmm(one_hot(seg_ids, M, torch.float32).transpose(1, 2),
                         eq.float())
        grad = g_pp.float() * eq.float() / torch.clamp_min(
            _take_rows(ties, seg_ids), 1.0)
        # an empty node forwarded point 0's feature: its cotangent goes there
        grad[:, 0, :] += torch.where(empty, g, 0.0).sum(1).float()
        return grad.to(data.dtype), None, None


def segment_max_sorted(data: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment max over ids sorted ascending along the points: data
    (B, N, C), seg_ids (B, N) int -> (B, M, C) in ``data.dtype``; an empty
    node takes data[:, 0].  Differentiable in ``data``."""
    return _SegmentMaxSorted.apply(data, seg_ids, num_segments)


def sort_by_segment(seg_ids: torch.Tensor, *arrays: torch.Tensor):
    """Stable sort of (B, N) ids -> (sorted ids, perm, inv_perm, each of
    ``arrays`` (B, N, ...) in the sorted order); perm and inv_perm are
    (B, N) int32 gather maps (sorted[j] = original[perm[j]],
    original[i] = sorted[inv_perm[i]])."""
    sorted_ids, perm = torch.sort(seg_ids, dim=1, stable=True)
    inv = torch.argsort(perm, dim=1, stable=True)
    out = []
    for a in arrays:
        idx = perm.view(*perm.shape, *([1] * (a.dim() - 2))).expand_as(a)
        out.append(torch.gather(a, 1, idx))
    return (sorted_ids, perm.to(torch.int32), inv.to(torch.int32), *out)
