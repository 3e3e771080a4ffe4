"""Index gathers (port of the JAX package's ``ops/gather.py``)."""

from __future__ import annotations

import torch


def knn_gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather neighbour features by index.

    data (B, M, C); idx (B, Q, K) int -> (B, Q, K, C).
    """
    B = data.shape[0]
    batch = torch.arange(B, device=data.device)[:, None, None]
    return data[batch, idx.long()]
