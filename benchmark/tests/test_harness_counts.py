"""counts.py against counts made by hand."""

import pytest

from benchmark import counts


def tiny(task):
    return {"task": task, "batch_size": 2, "input_pc_num": 4, "node_num": 4,
            "k": 2, "som_k": 2, "feature_num": 8, "classes": 3,
            "surface_normal": True, "compute_dtype": "bfloat16"}


def test_classifier_by_hand():
    # B=2, N=4, k=2 (kN=8), M=4, K=2, F=8, 3 classes
    # first PointNet, 16 rows: 2 (6*64 + 64*128 + 128*256 + 320*384)
    first = 16 * 2 * (384 + 8192 + 32768 + 122880)
    # kNN layer, B M K = 16 rows: 2 (387*512 + 512*512)
    knn = 16 * 2 * (387 * 512 + 512 * 512)
    # final PointNet, B M = 8 rows: 2 (515*768 + 768*8)
    final = 8 * 2 * (515 * 768 + 768 * 8)
    # head, B = 2 rows: 2 (8*512 + 512*256 + 256*3)
    head = 2 * 2 * (8 * 512 + 512 * 256 + 256 * 3)
    # distances 2 B N 3 M, cluster sums 2 B M kN 3, node distances 2 B M 3 M
    geo = 2 * 2 * 4 * 3 * 4 + 2 * 2 * 4 * 8 * 3 + 2 * 2 * 4 * 3 * 4
    f = counts.forward_flops(tiny("classify"), 2)
    assert f == {"weights": first + knn + final + head, "geometry": geo}
    assert counts.train_step_flops(tiny("classify")) == \
        3 * (first + knn + final + head) + geo


def test_segmenter_head_by_hand():
    cfg = tiny("segment")
    enc = counts.forward_flops(tiny("classify"), 2)["weights"] - \
        2 * 2 * (8 * 512 + 512 * 256 + 256 * 3)
    # layer1: per point 12 + 384 + 384 + 512 + 8 = 1300 channels over the
    # 16 stacked points; the category one-hot (16) and the feature (8)
    # once a cloud; then 1024 -> 512 -> 256 over the stacked points and
    # 256 -> 128 -> 3 over the B N = 8 points
    head = (16 * 2 * 1300 * 1024 + 2 * 2 * 24 * 1024
            + 16 * 2 * (1024 * 512 + 512 * 256)
            + 8 * 2 * (256 * 128 + 128 * 3))
    assert counts.forward_flops(cfg, 2)["weights"] == enc + head


def test_full_width_classifier():
    cfg = {**tiny("classify"), "batch_size": 8, "input_pc_num": 5000,
           "node_num": 64, "k": 3, "som_k": 9, "feature_num": 1024,
           "classes": 40}
    w = counts.forward_flops(cfg, 8)["weights"]
    # 328,448 FLOP a stacked point over 120,000, 4.24 G kNN, 1.21 G final
    assert w == pytest.approx(44.873e9, rel=1e-3)


def test_pooling_bytes():
    cfg = {**tiny("classify"), "batch_size": 8, "input_pc_num": 5000,
           "node_num": 64, "k": 3}
    # bf16 rows, int32 ids, float32 (B, M, 384) out: 93.4 MB
    assert counts.pooling_bytes(cfg) == 92_160_000 + 480_000 + 786_432
    assert counts.pooling_bound_s(cfg) == pytest.approx(93_426_432 / 3.35e12)
    f32 = {**cfg, "compute_dtype": "float32"}
    assert counts.pooling_bytes(f32) == 2 * 92_160_000 + 480_000 + 786_432
