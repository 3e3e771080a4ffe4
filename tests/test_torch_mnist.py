"""The port's classifier and MNIST loader on ``config.mnist()``'s shapes
against the JAX package's, on the CPU: 2-D clouds (D=2), 25 SOM nodes, no
surface normals, at narrow widths (F=64, 100 points), float32, both
poolings.  The loader's tests follow the model's, below.

The forward, in eval mode with random BatchNorm statistics and in train
mode with batch statistics, is held within 1e-4 of the largest logit (the
same float32 arithmetic summed in another order).  The cross-entropy's
gradients are held within 1e-3 of each tensor's largest entry plus 1e-6,
the tolerance of ``tests/test_torch_train.py``, from the forward with the
running statistics, as the segmenter's are: with batch statistics this
gradient is no continuous function of the weights on these 2-D clouds.
On this batch it differs from the JAX package's by 5.5 times the
tolerance in the first BatchNorm's bias, and the port's own gradient
moves by 4.7 times the tolerance when the port's weights are scaled by
1 + 2e-7 noise: two input channels put many points near the first ReLU's
kink and the pooled maxima near ties.  Weights are carried across by
``sonet_torch.convert``; the JAX side runs its Pallas kernel in interpret
mode for ``pooling="sorted_window"``.
"""

import gzip
import os
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import models as jmodels
from sonet_tpu.data import mnist as jmnist
from sonet_tpu.train import losses as jlosses
from sonet_torch import config as tcfg
from sonet_torch.convert import flatten, gradients_to_jax, load_jax_variables
from sonet_torch.data import mnist as tmnist
from sonet_torch.models import build_model
from sonet_torch.nn.encoder import spatial_dim
from sonet_torch.train import losses as tlosses
from sonet_torch.train.trainer import Trainer, build_dataset

torch.set_num_threads(2)

OVER = dict(input_pc_num=100, feature_num=64, batch_size=4, dropout=0.0,
            compute_dtype="float32")
LOGIT_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6


def _inputs(cfg, seed=7):
    """2-D clouds, nodes near picked points and one far node that no point
    is assigned to (the empty-node patch)."""
    rs = np.random.RandomState(seed)
    B, N, M = cfg.batch_size, cfg.input_pc_num, cfg.node_num
    pc = rs.randn(B, N, 2).astype(np.float32)
    node = (pc[:, rs.choice(N, M - 1, replace=False)]
            + 0.05 * rs.randn(B, M - 1, 2)).astype(np.float32)
    node = np.concatenate([node, np.full((B, 1, 2), 50.0, np.float32)], 1)
    label = rs.randint(0, cfg.classes, B).astype(np.int32)
    return pc, node, label


@pytest.fixture(scope="module", params=["scatter", "sorted_window"])
def pair(request):
    jc = jcfg.mnist().replace(pooling=request.param, **OVER)
    tc = tcfg.mnist().replace(pooling=request.param, **OVER)
    assert (spatial_dim(tc), tc.node_num, tc.surface_normal) == (2, 25, False)
    pc, node, label = _inputs(jc)
    jm = jmodels.build_model(jc)
    variables = jm.init(jax.random.PRNGKey(0), pc, None, node)
    rs = np.random.RandomState(8)
    flat = flatten(variables)
    for k, v in flat.items():
        if k.endswith("/mean"):
            flat[k] = (0.2 * rs.randn(*v.shape)).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
    model = build_model(tc, device="cpu")
    load_jax_variables(model, flat)
    return jm, flat, model, (pc, node, label)


def _nested(flat, collection):
    out = {}
    for k, v in flat.items():
        coll, *path, leaf = k.split("/")
        if coll != collection:
            continue
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(v)
    return out


@pytest.mark.parametrize("train", [False, True])
def test_mnist_forward_matches_jax(pair, train):
    jm, flat, model, (pc, node, _) = pair
    variables = {"params": _nested(flat, "params"),
                 "batch_stats": _nested(flat, "batch_stats")}
    if train:
        (want, _), _ = jm.apply(variables, pc, None, node, None, train=True,
                                epoch=jnp.float32(0), mutable=["batch_stats"])
    else:
        want, _ = jm.apply(variables, pc, None, node, train=False)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train(train)
    with torch.no_grad():
        got, _ = model(torch.from_numpy(pc), None, torch.from_numpy(node),
                       epoch=0)
    model.eval().load_state_dict(before)      # undo the statistics' update
    want = np.asarray(want)
    assert got.shape == want.shape == (4, 10)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= LOGIT_RTOL * scale


def test_mnist_gradients_match_jax(pair):
    jm, flat, model, (pc, node, label) = pair
    stats = _nested(flat, "batch_stats")

    def loss_fn(params):
        score, _ = jm.apply({"params": params, "batch_stats": stats}, pc,
                            None, node, train=False)
        return jlosses.cross_entropy(score, label)

    want = {k: np.asarray(v) for k, v in flatten(
        {"params": jax.grad(loss_fn)(_nested(flat, "params"))}).items()}
    model.zero_grad(set_to_none=True)
    score, _ = model(torch.from_numpy(pc), None, torch.from_numpy(node))
    tlosses.cross_entropy(score, torch.from_numpy(label)).backward()
    got = gradients_to_jax(model)
    assert set(got) == set(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        tol = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        assert err <= tol, (k, err, tol)
    k = "params/encoder/first_pointnet/PointLayer_0/Dense_0/kernel"
    assert got[k].shape[0] == 2 and np.abs(got[k]).max() > 1e-4


# ---------------------------------------------------------------------------
# the MNIST loader: ``sonet_torch.data.mnist`` against ``sonet_tpu``'s
# ---------------------------------------------------------------------------
#
# Everything but the SOM nodes is numpy on both sides, so points, labels,
# items and the train augmentation are held byte for byte; the nodes are a
# SOM fit in another framework, held by their quantization error within
# 1% of the JAX fit's (as ``tests/test_torch_data.py`` holds a fit).

QE_RTOL = 1e-2
DATA_OVER = dict(input_pc_num=64, feature_num=64, batch_size=4)


def _digits(n, seed):
    """``n`` 28x28 uint8 images: a stroke of bright pixels each, a blank
    one among them (the loader's safeguard), and their labels."""
    rs = np.random.RandomState(seed)
    x = np.zeros((n, 28, 28), np.uint8)
    for i in range(1, n):
        r, c = rs.randint(4, 20, 2)
        x[i, r:r + rs.randint(3, 8), c:c + rs.randint(1, 6)] = rs.randint(
            128, 256)
        x[i] = np.maximum(x[i], rs.randint(0, 140, (28, 28)).astype(np.uint8)
                          * (rs.rand(28, 28) < 0.05))
    return x, rs.randint(0, 10, n).astype(np.uint8)


def _mnist_npz(root, n_train=12, n_test=6):
    root.mkdir(parents=True, exist_ok=True)
    xtr, ytr = _digits(n_train, 1)
    xte, yte = _digits(n_test, 2)
    np.savez(root / "mnist.npz", x_train=xtr, y_train=ytr, x_test=xte,
             y_test=yte)
    return (xtr, ytr), (xte, yte)


def _write_idx(path, arr):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(head + arr.tobytes())


def _cfgs(**over):
    over = dict(DATA_OVER, **over)
    return jcfg.mnist().replace(**over), tcfg.mnist().replace(**over)


def _qe(pc, nodes):
    d = np.linalg.norm(pc[:, :, None, :] - nodes[:, None, :, :], axis=-1)
    return float(d.min(-1).mean())


@pytest.mark.parametrize("fmt", ["npz", "idx.gz"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_load_mnist_split_matches_jax(tmp_path, fmt, mode):
    (xtr, ytr), (xte, yte) = _mnist_npz(tmp_path / "npz")
    root = tmp_path / fmt
    if fmt == "idx.gz":
        root.mkdir()
        for prefix, x, y in (("train", xtr, ytr), ("t10k", xte, yte)):
            _write_idx(root / f"{prefix}-images-idx3-ubyte.gz", x)
            _write_idx(root / f"{prefix}-labels-idx1-ubyte.gz", y)
    got = tmnist.load_mnist_split(str(root), mode)
    want = jmnist.load_mnist_split(str(root), mode)
    np.testing.assert_array_equal(got[0], (xtr if mode == "train" else xte))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(FileNotFoundError):
        tmnist.load_mnist_split(str(tmp_path / "nothing"), mode)


def test_image_to_points_matches_jax():
    x, _ = _digits(4, 3)
    for img in x:
        got = tmnist.image_to_points(img, 50, np.random.default_rng(9))
        want = jmnist.image_to_points(img, 50, np.random.default_rng(9))
        assert got.dtype == np.float32 and got.shape == (50, 2)
        assert got.tobytes() == want.tobytes()
        assert np.abs(got).max() <= 1.0 + 1.0 / 27


@pytest.fixture(scope="module")
def mnist_pair(tmp_path_factory):
    """The port's and the JAX package's datasets, each fitting its own
    nodes (no cache: each in a root of its own)."""
    roots = [tmp_path_factory.mktemp(s) for s in ("t", "j")]
    for r in roots:
        _mnist_npz(r)
    jc, tc = _cfgs()
    return (tmnist.MNISTPointCloudDataset(str(roots[0]), "train", tc,
                                          device="cpu"),
            jmnist.MNISTPointCloudDataset(str(roots[1]), "train", jc), roots)


def test_mnist_points_match_jax(mnist_pair):
    t, j, _ = mnist_pair
    assert t.points.shape == (12, 64, 2)
    for name in ("points", "labels"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_mnist_nodes_match_jax_fit(mnist_pair):
    t, j, _ = mnist_pair
    assert t.som_node.shape == j.som_node.shape == (12, 25, 2)
    assert t.som_node.dtype == np.float32
    q_t, q_j = _qe(t.points, t.som_node), _qe(j.points, j.som_node)
    assert abs(q_t - q_j) <= QE_RTOL * q_j, (q_t, q_j)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mnist_cache_reads_across_packages(mnist_pair, tmp_path, writer):
    """A cache written by one package gives byte-equal items, train
    augmentation included, in the other (same name, same keys)."""
    t, j, roots = mnist_pair
    src = roots[1] if writer == "jax" else roots[0]
    jc, tc = _cfgs()
    name = os.path.basename(tmnist.cache_path(str(src), "train", 12, tc))
    assert os.path.exists(src / name)
    shutil.copy(src / "mnist.npz", tmp_path / "mnist.npz")
    shutil.copy(src / name, tmp_path / name)
    with np.load(tmp_path / name) as z:
        assert sorted(z.files) == ["points", "som_node"]
    if writer == "jax":
        # the port reads it; poisoned images would show a refit
        np.savez(tmp_path / "mnist.npz", **{
            k: np.zeros_like(v) for k, v in np.load(src / "mnist.npz").items()
            if k.startswith("x")}, **{k: v for k, v in np.load(
                src / "mnist.npz").items() if k.startswith("y")})
    reader = (tmnist.MNISTPointCloudDataset(str(tmp_path), "train", tc,
                                            device="cpu")
              if writer == "jax" else
              jmnist.MNISTPointCloudDataset(str(tmp_path), "train", jc))
    original = j if writer == "jax" else t
    for epoch in (0, 3):
        reader.set_epoch(epoch)
        original.set_epoch(epoch)
        for i in range(len(original)):
            a, b = reader[i], original[i]
            assert a.keys() == b.keys() == {"pc", "node", "label"}
            for k in a:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
                assert np.asarray(a[k]).tobytes() == np.asarray(
                    b[k]).tobytes(), k


def test_mnist_train_augmentation_matches_jax_given_the_nodes(mnist_pair):
    t, j, _ = mnist_pair
    saved = t.som_node
    t.som_node = j.som_node.copy()
    try:
        for epoch in (0, 1):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            for i in (0, 5, 11):
                a, b = t[i], j[i]
                for k in ("pc", "node", "label"):
                    assert a[k].tobytes() == np.asarray(b[k]).tobytes(), k
    finally:
        t.som_node = saved


def test_build_dataset_mnist_and_one_trainer_epoch(tmp_path):
    root = tmp_path / "data"
    _mnist_npz(root, n_train=12, n_test=6)
    _, tc = _cfgs(dataroot=str(root), checkpoints_dir=str(tmp_path / "runs"),
                  name="mnist", compute_dtype="float32", epochs=1)
    ds = build_dataset(tc, "test", "cpu")
    assert isinstance(ds, tmnist.MNISTPointCloudDataset) and len(ds) == 6
    item = ds[0]
    assert item["pc"].shape == (64, 2) and item["node"].shape == (25, 2)
    assert "sn" not in item
    trainer = Trainer(tc, quiet=True, resume=False, device="cpu")
    metrics = trainer.fit(epochs=1)
    assert trainer.state.step == 3
    assert set(metrics) == {"loss", "accuracy"}
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["accuracy"] <= 1
