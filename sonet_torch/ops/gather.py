"""Index gathers (port of the JAX package's ``ops/gather.py``).

Each gather whose gradient matters has its backward written out.  Plain
``torch.gather`` transposes into a ``scatter_add``: atomics, in the
tensor's own dtype, so a bf16 cotangent is rounded at every add and the
sum depends on the order the adds land in.  ``permute_points`` gathers
back through the inverse permutation instead, and ``gather_by_segment``
sums each node's rows in float32 and rounds once.
"""

from __future__ import annotations

import torch


def knn_gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features by index.

    data (B, M, C); idx (B, Q, K) int -> (B, Q, K, C).
    """
    B = data.shape[0]
    batch = torch.arange(B, device=data.device)[:, None, None]
    return data[batch, idx.long()]


def _take_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C) rows by idx (B, N') -> (B, N', C)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[2]))


class _PermutePoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return _take_points(x, perm)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _take_points(g, inv), None, None


def permute_points(x: torch.Tensor, perm: torch.Tensor,
                   inv: torch.Tensor) -> torch.Tensor:
    """Reorder the point axis by a known bijection: ``y[:, i] = x[:, perm[i]]``.

    ``inv`` must be the inverse permutation (``perm[inv[j]] == j``).  The
    backward is the gather by ``inv``: autograd cannot know that the
    indices form a permutation and would scatter-add instead.

    x (B, N, C); perm, inv (B, N) int -> (B, N, C).
    """
    return _PermutePoints.apply(x, perm, inv)


class _GatherBySegment(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, seg_ids, onehot):
        ctx.save_for_backward(seg_ids, onehot)
        ctx.num_segments = table.shape[1]
        return _take_points(table, seg_ids)

    @staticmethod
    def backward(ctx, g):
        seg_ids, onehot = ctx.saved_tensors
        B, N, C = g.shape
        M = ctx.num_segments
        if onehot is not None:
            # the transposed one-hot product, as in the JAX package
            grad = torch.bmm(onehot.float().transpose(1, 2), g.float())
        else:
            rows = (seg_ids.long()
                    + M * torch.arange(B, device=g.device)[:, None]).reshape(-1)
            grad = torch.zeros(B * M, C, dtype=torch.float32, device=g.device)
            grad.index_add_(0, rows, g.reshape(B * N, C).float())
            grad = grad.view(B, M, C)
        return grad.to(g.dtype), None, None


def gather_by_segment(node_feat: torch.Tensor, seg_ids: torch.Tensor,
                      onehot: torch.Tensor | None = None) -> torch.Tensor:
    """Broadcast per-node features back to points (the segmenter's skip
    gathers): node_feat (B, M, C); seg_ids (B, N) int in ``[0, M)`` ->
    (B, N, C).

    ``onehot`` is the (B, N, M) assignment one-hot, when the caller holds
    it (the encoder builds it anyway).  The JAX package then routes the
    gather as a one-hot matmul; here the forward is an index gather either
    way, which gives the same values (one 1.0 a row), and the arithmetic
    follows the one-hot's dtype as it does there: with a bf16 one-hot the
    table is cast to bf16 and the output is bf16, with a float32 one-hot
    the output is float32.

    Backward: each node's cotangent is the sum over its points,
    accumulated in float32 and rounded once to the output's dtype -- the
    transposed one-hot product when ``onehot`` is given (no atomics, the
    same sum every run), a float32 ``index_add_`` when it is not.
    """
    if onehot is None:
        table = node_feat
    elif onehot.dtype == torch.bfloat16:
        table = node_feat.to(torch.bfloat16)
    else:
        table = node_feat.float()
    return _GatherBySegment.apply(table, seg_ids, onehot)
