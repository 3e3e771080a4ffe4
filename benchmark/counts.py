"""Operations and bytes, counted from a configuration's shapes, and the
card's published peaks: the yardstick of the benchmark's utilisation and
roofline metrics.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense
rates, no sparsity).  A run prints the card's power limit beside them.
"""

from __future__ import annotations

from typing import Dict

PEAKS: Dict[str, float] = {
    "bf16_flops_per_s": 989e12,      # dense bf16 tensor-core rate
    "hbm_bytes_per_s": 3.35e12,      # HBM3 bandwidth
}

_DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _dense(rows: int, cin: int, cout: int) -> float:
    return 2.0 * rows * cin * cout


def forward_flops(cfg: dict, batch: int) -> Dict[str, float]:
    """The matrix products of one forward of ``batch`` clouds, by part:
    ``weights`` (products with learned weights) and ``geometry`` (the
    point-to-node and node-to-node distances and the cluster sums, which
    have no weight gradient).

    The classifier and the part segmenter with the kNN layer (som_k >= 2)
    and normals: first PointNet D+D -> 64 -> 128 -> 256, then (64 + 256)
    -> 384 over the k N stacked points; the kNN layer (D + 384) -> 512 ->
    512 over the M K neighbour rows; the final PointNet (D + 512) -> 768
    -> F over the M nodes; then the head.  The segmenter's first layer
    reads per-point parts over the k N stacked points and two per-cloud
    parts (the category one-hot and the global feature), whose product is
    made once a cloud; its first three layers run over the k N points,
    the last two over the N points."""
    B, N, M = batch, cfg["input_pc_num"], cfg["node_num"]
    k, K, F = cfg["k"], cfg["som_k"], cfg["feature_num"]
    D = 3
    kN = k * N
    if cfg["som_k"] < 2 or not cfg["surface_normal"]:
        raise NotImplementedError("counted for the kNN layer with normals")
    w = 0.0
    w += _dense(B * kN, 2 * D, 64) + _dense(B * kN, 64, 128)
    w += _dense(B * kN, 128, 256) + _dense(B * kN, 64 + 256, 384)
    w += _dense(B * M * K, D + 384, 512) + _dense(B * M * K, 512, 512)
    w += _dense(B * M, D + 512, 768) + _dense(B * M, 768, F)
    if cfg["task"] == "classify":
        w += _dense(B, F, 512) + _dense(B, 512, 256)
        w += _dense(B, 256, cfg["classes"])
    elif cfg["task"] == "segment":
        per_point = 4 * D + 384 + 384 + 512 + F
        w += _dense(B * kN, per_point, 1024) + _dense(B, 16 + F, 1024)
        w += _dense(B * kN, 1024, 512) + _dense(B * kN, 512, 256)
        w += _dense(B * N, 256, 128) + _dense(B * N, 128, cfg["classes"])
    else:
        raise NotImplementedError(cfg["task"])
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


def pooling_bytes(cfg: dict) -> float:
    """Kernel 1's least traffic a call (the encoder's node pooling): each
    of the B k N rows of 384 channels read once in the compute dtype, each
    int32 node id read once, and each (B, M, 384) float32 output written
    once."""
    B, kN, M, C = (cfg["batch_size"], cfg["k"] * cfg["input_pc_num"],
                   cfg["node_num"], 384)
    dt = _DTYPE_BYTES[cfg["compute_dtype"]]
    return B * kN * C * dt + B * kN * 4 + B * M * C * 4


def pooling_bound_s(cfg: dict) -> float:
    """Kernel 1's least time a call: its bytes at the HBM rate (it does one
    comparison a byte or so, far below any compute bound)."""
    return pooling_bytes(cfg) / PEAKS["hbm_bytes_per_s"]
