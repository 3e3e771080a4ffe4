"""Bidirectional Chamfer loss on the device (port of the JAX package's
``ops/chamfer.py``).

The (B, P, N) pairwise squared distances are one batched product and two
argmins.  The 1-NN selection carries no gradient (an integer argmin);
gradients flow through the selected pairs and ``robust_norm``,
sqrt(sum_sq + 1e-8): into ``predict_pc`` directly (forward term) and
through the gather (backward term), whose backward is a scatter-add.  On
a CUDA device that scatter-add uses atomics, so its float32 sums may
differ in their last bits from run to run.

``argmin`` returns the first minimum, on both packages.

Each call is the profiler range ``sonet:chamfer`` (``utils/spans.py``)
and counts once in ``chamfer.calls`` under its (P, N): in a CUDA graph
once, at its capture.

Under a mesh whose ``points`` axis is split (``parallel/``) the input
cloud ``gt_pc`` is this rank's block and the reconstruction is the same
on every points rank.  A predicted point's nearest input point is the
MIN over the ranks, its first occurrence in the global order on a tie
(the lowest points rank holding the minimum, then its first index), as
``argmin`` over the whole cloud picks; the gt -> predict means are this
rank's sums over its points, summed over ``points`` and divided by the
global count.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..parallel import collectives
from ..utils.spans import span
from .pairwise import pairwise_sqdist

SPAN = "sonet:chamfer"


def robust_norm(diff: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """sqrt(sum_c diff^2 + eps) over the channel axis."""
    return torch.sqrt((diff * diff).sum(-1) + eps)


class ChamferResult(NamedTuple):
    loss: torch.Tensor            # scalar: forward + backward mean
    forward_loss: torch.Tensor    # scalar: mean over predict -> gt matches
    backward_loss: torch.Tensor   # scalar: mean over gt -> predict matches
    loss_array: torch.Tensor      # (B,) per-item forward + backward means
    forward_array: torch.Tensor   # (B,) per-item forward means
    backward_array: torch.Tensor  # (B,) per-item backward means


def _take_points(pc: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pc (B, N, C), idx (B, P) -> (B, P, C)."""
    return torch.gather(pc, 1, idx[..., None].expand(-1, -1, pc.shape[-1]))


def _first_min_over_points(dmin: torch.Tensor,
                           sel: torch.Tensor) -> torch.Tensor:
    """Of each rank's local minimum ``dmin`` (B, P) and its point ``sel``
    (B, P, 3), the point of the global minimum, the lowest points rank's
    on a tie, on every points rank (no gradient: the input cloud has
    none)."""
    MIN, P = dist.ReduceOp.MIN, collectives.axis_size("points")
    here = collectives.axis_index("points")
    gmin = collectives.all_reduce(dmin, ("points",), op=MIN)
    cand = torch.where(dmin == gmin, here, P)
    winner = collectives.all_reduce(cand, ("points",), op=MIN)
    mine = (winner == here)[..., None]
    return collectives.all_reduce(torch.where(mine, sel.detach(), 0.0),
                                  ("points",))


def chamfer(predict_pc: torch.Tensor, gt_pc: torch.Tensor) -> ChamferResult:
    """Bidirectional 1-NN Chamfer distance; predict_pc (B, P, 3), gt_pc
    (B, N, 3), channel-last (under a split points axis, N is this rank's
    part: see the module docstring)."""
    chamfer.calls[(predict_pc.shape[1], gt_pc.shape[1])] += 1
    with span(SPAN):
        return _chamfer(predict_pc, gt_pc)


# calls by (predicted points P, input points N of this rank)
chamfer.calls = collections.Counter()


def _chamfer(predict_pc: torch.Tensor, gt_pc: torch.Tensor) -> ChamferResult:
    split = collectives.axis_size("points") > 1
    # the distances only feed the argmins: no graph is kept for them
    d = pairwise_sqdist(predict_pc.detach(), gt_pc.detach())    # (B, P, N)

    # predict -> gt: the nearest gt point of each predicted point
    if split:
        dmin, arg = d.min(-1)                                   # first min
        sel_gt = _first_min_over_points(dmin, _take_points(gt_pc, arg))
    else:
        sel_gt = _take_points(gt_pc, d.argmin(-1))              # (B, P, 3)
    fwd_elem = robust_norm(sel_gt - predict_pc)

    # gt -> predict: the nearest predicted point of each gt point
    sel_pred = _take_points(collectives.to_points(predict_pc),
                            d.argmin(-2))                       # (B, N, 3)
    bwd_elem = robust_norm(sel_pred - gt_pc)

    forward_loss = fwd_elem.mean()
    forward_array = fwd_elem.mean(-1)
    if split:
        n = gt_pc.shape[1] * collectives.axis_size("points")
        backward_array = collectives.reduce_points(bwd_elem.sum(-1)) / n
        backward_loss = backward_array.mean()
    else:
        backward_loss = bwd_elem.mean()
        backward_array = bwd_elem.mean(-1)
    return ChamferResult(loss=forward_loss + backward_loss,
                         forward_loss=forward_loss,
                         backward_loss=backward_loss,
                         loss_array=forward_array + backward_array,
                         forward_array=forward_array,
                         backward_array=backward_array)
