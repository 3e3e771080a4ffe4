"""ShapeNetPart mIoU, vectorised (port of the JAX package's ``ops/iou.py``).

The 16-category -> 50-part mapping is a padded (16, MAX_PARTS) table with
a validity mask, so a whole batch reduces in one shot on the inputs'
device.

Kept from the reference: a part with an empty union scores IoU 1.0, and
the denominator is ``union + 1e-4``.
"""

from __future__ import annotations

import numpy as np
import torch

# 16 ShapeNetPart categories -> their part label ids
PART_LABEL = [
    [0, 1, 2, 3], [4, 5], [6, 7], [8, 9, 10, 11], [12, 13, 14, 15],
    [16, 17, 18], [19, 20, 21], [22, 23], [24, 25, 26, 27], [28, 29],
    [30, 31, 32, 33, 34, 35], [36, 37], [38, 39, 40], [41, 42, 43],
    [44, 45, 46], [47, 48, 49],
]
MAX_PARTS = max(len(p) for p in PART_LABEL)  # 6
NUM_CATEGORIES = len(PART_LABEL)  # 16
NUM_PARTS = 50

# numpy at import; they become tensors on the inputs' device at call time
PART_TABLE = np.full((NUM_CATEGORIES, MAX_PARTS), -1, np.int64)
for ci, parts in enumerate(PART_LABEL):
    PART_TABLE[ci, : len(parts)] = parts
PART_VALID = PART_TABLE >= 0                 # (16, 6) bool


def iou_per_shape(seg_pred: torch.Tensor, seg_gt: torch.Tensor,
                  label: torch.Tensor) -> torch.Tensor:
    """Instance-average IoU per shape.

    seg_pred, seg_gt (B, N) int part labels; label (B,) int category.
    Returns (B,) float32: the mean IoU over the category's parts.
    """
    dev = seg_gt.device
    label = label.long()
    parts = torch.from_numpy(PART_TABLE).to(dev)[label]    # (B, MAX_PARTS)
    valid = torch.from_numpy(PART_VALID).to(dev)[label]    # (B, MAX_PARTS)

    gt = seg_gt[:, None, :] == parts[:, :, None]           # (B, MP, N)
    pr = seg_pred[:, None, :] == parts[:, :, None]
    inter = (gt & pr).sum(-1).float()
    union = (gt | pr).sum(-1).float()
    iou = torch.where(union == 0, 1.0, inter / (union + 1e-4))
    iou = torch.where(valid, iou, 0.0)
    return iou.sum(-1) / valid.sum(-1)


def compute_iou(score: torch.Tensor, seg_gt: torch.Tensor,
                label: torch.Tensor) -> torch.Tensor:
    """Batch-mean IoU from raw per-point scores: score (B, N, num_parts);
    seg_gt (B, N); label (B,)."""
    return iou_per_shape(score.argmax(-1), seg_gt, label).mean()
