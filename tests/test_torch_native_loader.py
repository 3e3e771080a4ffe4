"""The port's native C++ batch loader (``sonet_torch/native``,
``sonet_torch/data/native_loader.py``) against the JAX package's, on the
CPU.

Both packages build the same C++ code (the port keeps its own copy), so
the same items, seeds and epochs give the same bytes: held on fabricated
ModelNet, SHREC and ShapeNetPart trees, batch by batch and through the
``BatchLoader`` over two epochs.  Also: the C++ segment argmax against the
port's plain ``segment_argmax``, a ``Trainer`` epoch and ``sonet-torch
infer`` with ``--input_pipeline native``, and a failed build raising.

The JAX package builds its library beside its sources, with no lock, and
``tests/test_native_loader.py`` builds it there when it is collected, in
every worker.  To stay out of that race this file builds the JAX library
once, under its own name in a temporary directory of its own (module
fixture), and loads it from there.
"""

import csv
import os

import numpy as np
import pytest
import torch

import test_torch_data as data_cases
from sonet_tpu import config as jcfg
from sonet_tpu import native as jnative
from sonet_tpu.data import native_loader as jnl
from sonet_tpu.data.pipeline import BatchLoader as JBatchLoader
from sonet_torch import config as tcfg
from sonet_torch import native as tnative
from sonet_torch.data import native_loader as tnl
from sonet_torch.data.pipeline import BatchLoader
from sonet_torch.ops.cuda.segment_argmax import segment_argmax
from sonet_torch.train.trainer import Trainer, build_dataset

torch.set_num_threads(2)

OVER = dict(input_pc_num=50, rot_horizontal=True, rot_perturbation=True,
            translation_perturbation=True)


@pytest.fixture(scope="module", autouse=True)
def jax_library(tmp_path_factory):
    """The JAX package's native library, built into a directory of this
    module's own, for as long as this module runs."""
    lib = tmp_path_factory.mktemp("jax_native") / "libsonet_native.so"
    saved = jnative._LIB, jnative._lib
    jnative._LIB, jnative._lib = str(lib), None
    jnative.build()
    yield lib
    jnative._LIB, jnative._lib = saved


def _fake_modelnet(root, over):
    data_cases._fake_modelnet(root, tcfg.tiny_test().replace(**over),
                              n_shapes=8, pts=120)


def _fake_shrec(root, over):
    data_cases._fake_shrec(root, tcfg.tiny_test().replace(**over))


def _fake_shapenet(root, over):
    data_cases._fake_shapenet(root, tcfg.tiny_test().replace(**over))


LAYOUTS = {
    "modelnet": (_fake_modelnet, jnl.NativeModelNetDataset,
                 tnl.NativeModelNetDataset, {}),
    "shrec": (_fake_shrec, jnl.NativeShrecDataset, tnl.NativeShrecDataset,
              dict(classes=4)),
    "shapenet": (_fake_shapenet, jnl.NativeShapeNetPartDataset,
                 tnl.NativeShapeNetPartDataset, dict(input_pc_num=110)),
}


def _pair(tmp_path, layout, mode):
    fake, jcls, tcls, over = LAYOUTS[layout]
    over = dict(OVER, **over)
    fake(tmp_path, over)
    jc = jcfg.tiny_test().replace(**over, input_pipeline="native")
    tc = tcfg.tiny_test().replace(**over, input_pipeline="native")
    return (jcls(str(tmp_path), mode, jc, num_threads=3),
            tcls(str(tmp_path), mode, tc, num_threads=3))


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_native_batches_match_jax(tmp_path, layout, mode):
    if layout == "shrec" and mode == "test":
        mode = "val"
    j, t = _pair(tmp_path, layout, mode)
    assert len(t) == len(j) > 0
    idx = list(range(len(t)))[::-1]
    for epoch in (0, 2):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        _equal(t.make_batch(idx, len(idx)), j.make_batch(idx, len(idx)))
    got = [b for _ in range(2) for b in BatchLoader(t, 2, seed=4)]
    want = [b for _ in range(2) for b in JBatchLoader(j, 2, seed=4)]
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _equal(a, b)


def test_loader_calls_make_batch():
    class Batcher:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            raise AssertionError("the loader read an item")

        def make_batch(self, indices, valid):
            return {"i": np.asarray(indices), "valid": np.int32(valid)}

    batches = list(BatchLoader(Batcher(), 4, shuffle=False, drop_last=False,
                               pad_last=True, num_threads=1))
    assert [b["i"].tolist() for b in batches] == [[0, 1, 2, 3], [4, 5, 0, 1]]
    assert [int(b["valid"]) for b in batches] == [4, 2]


@pytest.mark.parametrize("threads", [1, 3])
def test_segment_argmax_native_equals_plain(threads):
    rs = np.random.RandomState(0)
    B, N, C, M = 2, 70, 5, 9
    data = rs.randn(B, N, C).astype(np.float32)
    data[0, 10:14] = data[0, 3]                       # exact ties
    seg = rs.randint(0, M - 1, (B, N)).astype(np.int32)   # node M-1 empty
    vals, idx = tnative.segment_argmax_native(data, seg, M, threads)
    jv, ji = jnative.segment_argmax_native(data, seg, M, threads)
    want = segment_argmax(torch.from_numpy(data), torch.from_numpy(seg), M)
    np.testing.assert_array_equal(idx, want.numpy())
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(vals, jv)
    taken = np.take_along_axis(data, idx, 1)       # empty: point 0's
    np.testing.assert_array_equal(vals, taken)


def test_native_build_lands_in_the_build_dir():
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert tnative.available()
    assert not list(tnative.BUILD_DIR.glob("libsonet_native*.tmp"))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    _fake_modelnet(tmp_path, OVER)
    monkeypatch.setattr(tnative, "GXX_FLAGS",
                        tnative.GXX_FLAGS + ("--no-such-flag",))
    monkeypatch.setattr(tnative, "_lib", None)
    cfg = tcfg.tiny_test().replace(**OVER, input_pipeline="native",
                                   dataset="modelnet",
                                   dataroot=str(tmp_path),
                                   checkpoints_dir=str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="g.. failed"):
        build_dataset(cfg, "train", "cpu")
    with pytest.raises(RuntimeError, match="g.. failed"):
        Trainer(cfg, quiet=True, resume=False, device="cpu")
    assert not tnative.available()


def test_other_datasets_warn_and_use_python(tmp_path):
    cfg = tcfg.tiny_test().replace(input_pipeline="native")
    with pytest.warns(UserWarning, match="falls back"):
        ds = build_dataset(cfg, "train", "cpu")
    assert not hasattr(ds, "make_batch")


def test_native_trainer_epoch_and_infer(tmp_path):
    """A native-pipeline run trains an epoch; ``infer`` streams its test
    split through the native loader, and through the host one for
    ``--input_pipeline host``: the test items draw no augmentation but
    their subsample, whose stream differs between the two loaders, so
    both give one row per item with the labels of the split."""
    from sonet_torch.tasks import infer
    _fake_modelnet(tmp_path, OVER)
    cfg = tcfg.tiny_test().replace(
        **OVER, input_pipeline="native", dataset="modelnet",
        dataroot=str(tmp_path), batch_size=2, checkpoints_dir=str(tmp_path),
        name="nat")
    t = Trainer(cfg, quiet=True, resume=False, device="cpu")
    assert isinstance(t.train_set, tnl.NativeModelNetDataset)
    m = t.fit(epochs=1)
    assert t.state.step == 2 and np.isfinite(m["loss"])
    run = os.path.join(str(tmp_path), "nat")
    rows = {}
    for pipe in ("native", "host"):
        out = tmp_path / pipe
        s = infer.main(["--run", run, "--out", str(out), "--device", "cpu",
                        "--input_pipeline", pipe])
        with open(out / "predictions.csv") as f:
            rows[pipe] = list(csv.reader(f))[1:]
        assert s["items"] == len(t.test_set) == 4
    assert [r[1] for r in rows["native"]] == [r[1] for r in rows["host"]]
    assert len(rows["native"]) == 4
