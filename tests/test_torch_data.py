"""The port's host data layer against the JAX package's, on the CPU: per-item
seeding, augmentation, the threaded ``BatchLoader``, the ModelNet, SHREC16
and ShapeNetPart loaders over fabricated trees, and the synthetic dataset.

Everything here but the SOM nodes is numpy on both sides, so items and
batches are held byte-equal.  The synthetic dataset's nodes are a whole
SOM fit in another framework: they are held by their quantization error
(the mean distance of a point to its nearest node), within 1% of the JAX
fit's, as ``tests/test_torch_som.py`` holds a fit.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from sonet_tpu import config as jcfg
from sonet_tpu.data import augmentation as jaug
from sonet_tpu.data import modelnet as jmodelnet
from sonet_tpu.data import pipeline as jpipeline
from sonet_tpu.data import seeding as jseeding
from sonet_tpu.data import shapenet as jshapenet
from sonet_tpu.data import synthetic as jsynthetic
from sonet_torch import config as tcfg
from sonet_torch.data import augmentation as taug
from sonet_torch.data import modelnet as tmodelnet
from sonet_torch.data import pipeline as tpipeline
from sonet_torch.data import seeding as tseeding
from sonet_torch.data import shapenet as tshapenet
from sonet_torch.data import synthetic as tsynthetic

QE_RTOL = 1e-2


def _equal_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# ---------------------------------------------------------------------------
# seeding and augmentation
# ---------------------------------------------------------------------------

class _Seeded:
    def __init__(self, seeding, seed, mode):
        self.s = type("S", (seeding.EpochSeeded,), {})()
        self.s._init_seeding(seed, mode)


@pytest.mark.parametrize("mode", ["train", "test", "val", "other"])
def test_epoch_seeded_draws_match_jax(mode):
    assert tseeding.mode_id(mode) == jseeding.mode_id(mode)
    j, t = _Seeded(jseeding, 7, mode).s, _Seeded(tseeding, 7, mode).s
    for epoch in (0, 3):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        for idx in (0, 5):
            np.testing.assert_array_equal(t.item_rng(idx).random(8),
                                          j.item_rng(idx).random(8))


@pytest.mark.parametrize("flags", [
    dict(),
    dict(rot_horizontal=True, rot_perturbation=True,
         translation_perturbation=True),
])
def test_augmentation_draws_match_jax(flags):
    rs = np.random.RandomState(0)
    pc, sn, node = (rs.randn(50, 3), rs.randn(50, 3), rs.randn(16, 3))
    got = taug.train_augment(pc, sn, node, np.random.default_rng(3), **flags)
    want = jaug.train_augment(pc, sn, node, np.random.default_rng(3), **flags)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.float32
    for name in ("rotate_point_cloud_90", "rotate_point_cloud",
                 "rotate_perturbation_point_cloud", "jitter_point_cloud"):
        np.testing.assert_array_equal(
            getattr(taug, name)(pc, np.random.default_rng(4)),
            getattr(jaug, name)(pc, np.random.default_rng(4)))


# ---------------------------------------------------------------------------
# BatchLoader
# ---------------------------------------------------------------------------

class _AugDataset:
    """An epoch-seeded dataset of 10 clouds whose items are augmented."""

    def __init__(self, seeding, aug):
        self.aug = aug
        self.s = type("S", (seeding.EpochSeeded,), {})()
        self.s._init_seeding(5, "train")
        rs = np.random.RandomState(1)
        self.pc = rs.randn(10, 20, 3).astype(np.float32)

    def __len__(self):
        return len(self.pc)

    def set_epoch(self, epoch):
        self.s.set_epoch(epoch)

    def __getitem__(self, i):
        pc, sn, node = self.aug.train_augment(
            self.pc[i], -self.pc[i], self.pc[i, :4], self.s.item_rng(i))
        return {"pc": pc, "sn": sn, "node": node, "label": np.int64(i)}


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, num_threads=3),
    dict(shuffle=True, num_threads=1, drop_last=False),
    dict(shuffle=False, drop_last=False, pad_last=True, num_threads=2),
])
def test_batch_loader_matches_jax_over_two_epochs(kw):
    j = jpipeline.BatchLoader(_AugDataset(jseeding, jaug), 4, seed=3, **kw)
    t = tpipeline.BatchLoader(_AugDataset(tseeding, taug), 4, seed=3, **kw)
    assert len(t) == len(j)
    for _ in range(2):
        jb, tb = list(j), list(t)
        assert len(tb) == len(jb) == len(t)
        for a, b in zip(tb, jb):
            _equal_items(a, b)
    if kw.get("pad_last"):
        assert int(tb[-1]["valid"]) == 2 and tb[-1]["pc"].shape[0] == 4
        np.testing.assert_array_equal(tb[-1]["label"], [8, 9, 0, 1])


def test_skip_epoch_matches_an_abandoned_pass():
    """What the JAX package's ``Trainer`` does with its example batch (one
    batch drawn, the pass abandoned), ``skip_epoch`` does loading nothing."""
    j = jpipeline.BatchLoader(_AugDataset(jseeding, jaug), 4, seed=3)
    t = tpipeline.BatchLoader(_AugDataset(tseeding, taug), 4, seed=3)
    it = iter(j)
    next(it)
    it.close()
    t.skip_epoch()
    for _ in range(2):
        for a, b in zip(list(t), list(j)):
            _equal_items(a, b)


def test_collate_skips_none():
    items = [{"pc": np.zeros(3), "sn": None}, {"pc": np.ones(3), "sn": None}]
    got = tpipeline.collate(items)
    assert list(got) == ["pc"] and got["pc"].shape == (2, 3)


class _Failing:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 6:
            raise KeyError("item 6 is broken")
        return {"x": np.full(2, i)}


def test_worker_exception_reaches_the_consumer():
    loader = tpipeline.BatchLoader(_Failing(), 2, shuffle=False,
                                   num_threads=2)
    with pytest.raises(KeyError, match="item 6"):
        list(loader)


def test_abandoned_iterator_shuts_down():
    loader = tpipeline.BatchLoader(_AugDataset(tseeding, taug), 2,
                                   num_threads=2, prefetch=1)
    before = threading.active_count()
    for _ in range(3):
        it = iter(loader)
        next(it)
        it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(list(loader)) == 5       # still usable


# ---------------------------------------------------------------------------
# dataset loaders over fabricated trees
# ---------------------------------------------------------------------------

def _fake_modelnet(root, cfg, n_shapes=6, pts=200):
    rows = cfg.rows
    classes = ["airplane", "bed"]
    rng = np.random.default_rng(0)
    names = []
    for i in range(n_shapes):
        cls = classes[i % 2]
        name = f"{cls}_{i:04d}"
        names.append(name)
        os.makedirs(root / cls, exist_ok=True)
        np.save(root / cls / f"{name}.npy",
                rng.standard_normal((pts, 6)).astype(np.float32))
        som_dir = root / f"{rows}x{rows}_som_nodes" / cls
        os.makedirs(som_dir, exist_ok=True)
        np.save(som_dir / f"{name}.npy",
                rng.standard_normal((cfg.node_num, 3)).astype(np.float32))
    (root / f"modelnet{cfg.classes}_shape_names.txt").write_text(
        "\n".join(classes) + "\n")
    (root / f"modelnet{cfg.classes}_train.txt").write_text(
        "\n".join(names[:4]) + "\n")
    (root / f"modelnet{cfg.classes}_test.txt").write_text(
        "\n".join(names[4:]) + "\n")


def _fake_shrec(root, cfg, counts=(("train", 6), ("val", 3), ("test", 3))):
    rows = cfg.rows
    rng = np.random.default_rng(1)
    cats = [f"cat{i}" for i in range(cfg.classes)]
    (root / "category.txt").write_text("\n".join(cats) + "\n")
    idx = 0
    for mode, n in counts:
        lines = []
        os.makedirs(root / f"{rows}x{rows}" / mode, exist_ok=True)
        for i in range(n):
            name = f"{idx:06d}"
            idx += 1
            np.savez(root / f"{rows}x{rows}" / mode / f"model_{name}.npz",
                     pc=rng.standard_normal((90, 3)).astype(np.float32),
                     sn=rng.standard_normal((90, 3)).astype(np.float32),
                     som_node=rng.standard_normal(
                         (cfg.node_num, 3)).astype(np.float32))
            lines.append(f"{name},{cats[i % len(cats)]}" if mode != "test"
                         else name)
        (root / f"{mode}.txt").write_text("\n".join(lines) + "\n")


def _fake_shapenet(root, cfg, n_shapes=5, pts=100):
    rows = cfg.rows
    rng = np.random.default_rng(0)
    entries = []
    for i in range(n_shapes):
        folder = jshapenet.FOLDERS[i % 3]
        name = f"shape{i:03d}"
        os.makedirs(root / folder, exist_ok=True)
        np.savez(root / folder / f"{name}_{rows}x{rows}.npz",
                 pc=rng.standard_normal((pts + 20 * i, 3)).astype(np.float32),
                 sn=rng.standard_normal((pts + 20 * i, 3)).astype(np.float32),
                 part_label=rng.integers(0, 4, pts + 20 * i).astype(np.int64),
                 som_node=rng.standard_normal(
                     (cfg.node_num, 3)).astype(np.float32))
        entries.append(f"shape_data/{folder}/{name}")
    os.makedirs(root / "train_test_split", exist_ok=True)
    for mode in ("train", "test"):
        with open(root / "train_test_split"
                  / f"shuffled_{mode}_file_list.json", "w") as f:
            json.dump(entries, f)


def _both(jcls, tcls, root, mode, over):
    jc = jcfg.tiny_test().replace(**over)
    tc = tcfg.tiny_test().replace(**over)
    return jcls(str(root), mode, jc), tcls(str(root), mode, tc)


def _hold_items(j, t, epochs=(0, 2)):
    assert len(t) == len(j) > 0
    for epoch in epochs:
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        for i in range(len(t)):
            _equal_items(t[i], j[i])


@pytest.mark.parametrize("mode", ["train", "test"])
def test_modelnet_items_match_jax(tmp_path, mode):
    over = dict(classes=10, input_pc_num=64, rot_horizontal=True)
    _fake_modelnet(tmp_path, tcfg.tiny_test().replace(**over))
    j, t = _both(jmodelnet.ModelNetDataset, tmodelnet.ModelNetDataset,
                 tmp_path, mode, over)
    assert t.items == j.items
    _hold_items(j, t)


@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_shrec_items_match_jax(tmp_path, mode):
    over = dict(task="retrieve", dataset="shrec", classes=3,
                input_pc_num=64, som_k=0)
    _fake_shrec(tmp_path, tcfg.tiny_test().replace(**over))
    j, t = _both(jmodelnet.ShrecDataset, tmodelnet.ShrecDataset, tmp_path,
                 mode, over)
    assert t.items == j.items
    _hold_items(j, t)
    # the retrieval id is the shape's name in the split
    assert [int(t[i]["id"]) for i in range(len(t))] == [
        int(name) for _, _, name in t.items]


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("n_points", [64, 128])  # below / above the file's
def test_shapenet_items_match_jax(tmp_path, mode, n_points):
    over = dict(task="segment", classes=50, input_pc_num=n_points,
                batch_size=4)
    _fake_shapenet(tmp_path, tcfg.tiny_test().replace(**over))
    j, t = _both(jshapenet.ShapeNetPartDataset,
                 tshapenet.ShapeNetPartDataset, tmp_path, mode, over)
    assert len(t) == 4                  # 5 % 4 == 1: one item dropped
    assert t.items == j.items
    _hold_items(j, t)


def test_shrec_loader_batches_match_jax(tmp_path):
    over = dict(task="retrieve", dataset="shrec", classes=3,
                input_pc_num=64, som_k=0)
    _fake_shrec(tmp_path, tcfg.tiny_test().replace(**over))
    j, t = _both(jmodelnet.ShrecDataset, tmodelnet.ShrecDataset, tmp_path,
                 "train", over)
    jl = jpipeline.BatchLoader(j, 4, seed=2, num_threads=2)
    tl = tpipeline.BatchLoader(t, 4, seed=2, num_threads=2)
    for _ in range(2):
        for a, b in zip(list(tl), list(jl)):
            _equal_items(a, b)


# ---------------------------------------------------------------------------
# the synthetic dataset
# ---------------------------------------------------------------------------

def _qe(pc, nodes):
    d = np.linalg.norm(pc[:, :, None, :] - nodes[:, None, :, :], axis=-1)
    return float(d.min(-1).mean())


@pytest.fixture(scope="module", params=["classify", "segment"])
def synthetic_pair(request):
    over = dict(task=request.param, input_pc_num=96)
    if request.param == "segment":
        over["classes"] = 50
    jc = jcfg.tiny_test().replace(**over)
    tc = tcfg.tiny_test().replace(**over)
    return (jsynthetic.SyntheticDataset(jc, size=12, mode="train", seed=3),
            tsynthetic.SyntheticDataset(tc, size=12, mode="train", seed=3,
                                        device="cpu"))


def test_synthetic_clouds_match_jax(synthetic_pair):
    j, t = synthetic_pair
    for name in ("pc", "sn", "label", "seg"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        assert getattr(t, name).dtype == getattr(j, name).dtype
    if t.cfg.task == "segment":
        assert 0 < t.label.max() < 16 and t.seg.max() < 50
    # augmented items: the same draws (pc and sn do not read the nodes)
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        for i in (0, 7):
            a, b = t[i], j[i]
            for k in ("pc", "sn", "label"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_synthetic_nodes_match_jax_fit(synthetic_pair):
    j, t = synthetic_pair
    assert t.som_node.shape == j.som_node.shape == (12, 16, 3)
    assert t.som_node.dtype == np.float32
    q_t, q_j = _qe(t.pc, t.som_node), _qe(j.pc, j.som_node)
    q_one = _qe(t.pc, np.broadcast_to(t.som_node.mean(1, keepdims=True),
                                       t.som_node.shape))
    assert abs(q_t - q_j) <= QE_RTOL * q_j, (q_t, q_j)
    assert q_t < 0.5 * q_one           # far better than one node a cloud
