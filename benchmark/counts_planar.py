"""Operations of the 2-D classifier's train step (MNIST's: D=2, no
normals), counted from its configuration's shapes; ``counts.py`` counts
the 3-D classifier with normals, whose first layer reads 2 D channels
where this one reads D.

* first PointNet D -> 64 -> 128 -> 256, then (64 + 256) -> 384, over the
  B k N stacked points;
* the kNN layer (D + 384) -> 512 -> 512 over the B M K neighbour rows;
* the final PointNet (D + 512) -> 768 -> F over the B M nodes;
* the head F -> 512 -> 256 -> classes over the B clouds;
* geometry, which has no weight gradient: the point-to-node distances,
  the cluster sums and the node-to-node distances, at D.
"""

from __future__ import annotations

from typing import Dict

from benchmark import counts

_dense = counts._dense
D = 2


def forward_flops(cfg: dict, batch: int) -> Dict[str, float]:
    """The matrix products of one forward of ``batch`` 2-D clouds, by part:
    ``weights`` and ``geometry`` (as ``counts.forward_flops``)."""
    if cfg["som_k"] < 2 or cfg["surface_normal"] or cfg["task"] != "classify":
        raise NotImplementedError(
            "counted for the 2-D classifier without normals, with the kNN "
            "layer")
    B, N, M = batch, cfg["input_pc_num"], cfg["node_num"]
    k, K, F = cfg["k"], cfg["som_k"], cfg["feature_num"]
    kN = k * N
    w = (_dense(B * kN, D, 64) + _dense(B * kN, 64, 128)
         + _dense(B * kN, 128, 256) + _dense(B * kN, 64 + 256, 384)
         + _dense(B * M * K, D + 384, 512) + _dense(B * M * K, 512, 512)
         + _dense(B * M, D + 512, 768) + _dense(B * M, 768, F)
         + _dense(B, F, 512) + _dense(B, 512, 256)
         + _dense(B, 256, cfg["classes"]))
    geo = (_dense(B * N, D, M)          # point-to-node distances
           + _dense(B * M, kN, D)       # cluster sums
           + _dense(B * M, D, M))       # node-to-node distances
    return {"weights": w, "geometry": geo}


def train_step_flops(cfg: dict) -> float:
    """Model FLOPs of one train step: three times the products with
    learned weights (forward, and the backward's two products), once the
    geometry."""
    f = forward_flops(cfg, cfg["batch_size"])
    return 3.0 * f["weights"] + f["geometry"]
