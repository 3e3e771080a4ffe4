"""The port's device-resident input pipeline (``data/device_pipeline.py``)
and the ``Trainer``'s device pipeline against the JAX package's, on the
CPU, at ``tiny_test`` widths.

* ``raw_item`` of the synthetic, ModelNet, SHREC, ShapeNetPart and MNIST
  datasets over fabricated trees, the stacked split and its byte counts,
  and the epoch index tables are byte-equal to the JAX package's.  The
  synthetic and MNIST nodes are a SOM fit in another framework, so the
  port's datasets are given the JAX datasets' nodes (MNIST through the
  cache file both packages read).
* ``apply_sample`` fed the JAX package's own draws (regenerated with
  ``jax.random`` from the key splits of its ``sample_batch``) equals the
  JAX ``sample_batch`` within 1e-6 in float32: only the float32 products
  of the rotations are summed in another order.  Torch cannot reproduce
  JAX's random streams, so the port's own draws are held by what they
  must give: a distinct subset, part labels that follow it, augmentation
  in its ranges.
* A resident and a chunked epoch end in the same weights, bit for bit;
  a device-pipeline ``Trainer`` evaluates twice to the same metrics; on
  the synthetic dataset (no subsample, so eval draws nothing) its eval
  from the JAX package's weights, carried across by ``convert``, equals
  the JAX device pipeline's within 1e-5 (float32 sums in another order).

The captured CUDA graphs of these steps are held on the card
(``tests/test_torch_cuda.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_data as data_cases
import test_torch_mnist as mnist_cases
from sonet_tpu import config as jcfg
from sonet_tpu.data import device_pipeline as jdp
from sonet_tpu.data import mnist as jmnist
from sonet_tpu.data import modelnet as jmodelnet
from sonet_tpu.data import shapenet as jshapenet
from sonet_tpu.data import synthetic as jsynthetic
from sonet_tpu.train import trainer as jtrainer
from sonet_torch import config as tcfg
from sonet_torch.convert import flatten, load_jax_variables
from sonet_torch.data import device_pipeline as tdp
from sonet_torch.data import mnist as tmnist
from sonet_torch.data import modelnet as tmodelnet
from sonet_torch.data import shapenet as tshapenet
from sonet_torch.data import synthetic as tsynthetic
from sonet_torch.train.trainer import Trainer

torch.set_num_threads(2)

SAMPLE_ATOL = 1e-6
EVAL_RTOL = 1e-5


def _equal_host(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# raw items and the stacked split
# ---------------------------------------------------------------------------

def _modelnet_pair(root, mode, over):
    data_cases._fake_modelnet(root, tcfg.tiny_test().replace(**over))
    return data_cases._both(jmodelnet.ModelNetDataset,
                            tmodelnet.ModelNetDataset, root, mode, over)


def _shrec_pair(root, mode, over):
    data_cases._fake_shrec(root, tcfg.tiny_test().replace(**over))
    return data_cases._both(jmodelnet.ShrecDataset, tmodelnet.ShrecDataset,
                            root, mode, over)


def _shapenet_pair(root, mode, over):
    data_cases._fake_shapenet(root, tcfg.tiny_test().replace(**over))
    return data_cases._both(jshapenet.ShapeNetPartDataset,
                            tshapenet.ShapeNetPartDataset, root, mode, over)


def _synthetic_pair(root, mode, over):
    jc = jcfg.tiny_test().replace(**over)
    tc = tcfg.tiny_test().replace(**over)
    j = jsynthetic.SyntheticDataset(jc, size=12, mode=mode, seed=3)
    t = tsynthetic.SyntheticDataset(tc, size=12, mode=mode, seed=3,
                                    device="cpu")
    t.som_node = j.som_node.copy()
    return j, t


def _mnist_pair(root, mode, over):
    """The JAX dataset fits its nodes and writes its cache; the port's
    reads that cache."""
    mnist_cases._mnist_npz(root)
    jc, tc = mnist_cases._cfgs(**over)
    j = jmnist.MNISTPointCloudDataset(str(root), mode, jc)
    t = tmnist.MNISTPointCloudDataset(str(root), mode, tc, device="cpu")
    return j, t


@pytest.mark.parametrize("make,mode,over", [
    (_synthetic_pair, "train", {}),
    (_synthetic_pair, "test", dict(task="segment", classes=50)),
    (_modelnet_pair, "train", {}),
    (_modelnet_pair, "test", {}),
    (_shrec_pair, "train", dict(classes=4)),
    (_shrec_pair, "val", dict(classes=4)),
    (_shapenet_pair, "train", dict(input_pc_num=60)),    # resampled down
    (_shapenet_pair, "test", dict(input_pc_num=100)),    # and up
    (_mnist_pair, "train", {}),
], ids=["synthetic", "synthetic-seg", "modelnet-train", "modelnet-test",
        "shrec-train", "shrec-val", "shapenet-down", "shapenet-up", "mnist"])
def test_raw_items_and_split_match_jax(tmp_path, make, mode, over):
    j, t = make(tmp_path, mode, over)
    assert len(t) == len(j) > 0
    for i in range(len(t)):
        a, b = t.raw_item(i), j.raw_item(i)
        assert a.keys() == b.keys()
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    host = tdp.stack_host_split(t)
    _equal_host(host, jdp.stack_host_split(j))
    assert tdp.split_nbytes(host) == jdp.split_nbytes(host)
    assert (tdp.estimate_split_nbytes(t) == jdp.estimate_split_nbytes(j)
            == tdp.split_nbytes(host))
    data = tdp.load_device_data(t, "cpu")
    assert data.size == len(t) and data.label.dtype == torch.int64
    np.testing.assert_array_equal(data.pc.numpy(), host["pc"])


def test_a_dataset_without_raw_item_is_refused():
    class Plain:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return {"pc": np.zeros((4, 3), np.float32)}

    for fn in (tdp.stack_host_split, tdp.estimate_split_nbytes):
        with pytest.raises(TypeError, match="raw_item"):
            fn(Plain())


# ---------------------------------------------------------------------------
# sample_batch: the apply part against the JAX package, the draws alone
# ---------------------------------------------------------------------------

def _raw(cfg, T=10, n_raw=96, seg=False, sn=True, seed=0):
    rs = np.random.RandomState(seed)
    host = {"pc": rs.randn(T, n_raw, 3).astype(np.float32),
            "node": rs.randn(T, cfg.node_num, 3).astype(np.float32),
            "label": rs.randint(0, cfg.classes, T).astype(np.int64)}
    if sn:
        host["sn"] = rs.randn(T, n_raw, 3).astype(np.float32)
    if seg:
        host["seg"] = rs.randint(0, 50, (T, n_raw)).astype(np.int64)
    return host


def _jax_draws(rng, cfg, B, n_raw, train, sn):
    """The JAX ``sample_batch``'s draws, from its own key splits."""
    r_sub, r_roty, r_rotp, r_jpc, r_jsn, r_jnode, r_scale, r_shift = \
        jax.random.split(rng, 8)
    N = min(cfg.input_pc_num, n_raw)
    d = {}
    if cfg.input_pc_num < n_raw:
        d["keys"] = jax.random.uniform(r_sub, (B, n_raw))
    if train:
        if cfg.rot_horizontal:
            d["roty"] = jax.random.uniform(r_roty, (B,))
        if cfg.rot_perturbation:
            d["rotp"] = jax.random.normal(r_rotp, (B, 3))
        d["jpc"] = jax.random.normal(r_jpc, (B, N, 3))
        if sn:
            d["jsn"] = jax.random.normal(r_jsn, (B, N, 3))
        d["jnode"] = jax.random.normal(r_jnode, (B, cfg.node_num, 3))
        d["scale"] = jax.random.uniform(r_scale, (B, 1, 1), minval=0.8,
                                        maxval=1.2)
        if cfg.translation_perturbation:
            d["shift"] = jax.random.uniform(r_shift, (B, 1, 3), minval=-0.1,
                                            maxval=0.1)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


AUGMENT = dict(rot_horizontal=True, rot_perturbation=True,
               translation_perturbation=True)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("case", [
    dict(over=dict(input_pc_num=48, **AUGMENT)),
    dict(over=dict(input_pc_num=96, **AUGMENT)),              # no subsample
    dict(over=dict(input_pc_num=48), sn=False),
    dict(over=dict(input_pc_num=48, task="segment", classes=50), seg=True),
    dict(over=dict(input_pc_num=96, rot_horizontal=True), seg=True,
         sn=False),
], ids=["subsample", "full", "no-sn", "seg", "seg-full-no-sn"])
def test_apply_sample_with_jax_draws_matches_jax(train, case):
    over, sn, seg = case["over"], case.get("sn", True), case.get("seg", False)
    jc, tc = jcfg.tiny_test().replace(**over), tcfg.tiny_test().replace(**over)
    host = _raw(tc, seg=seg, sn=sn)
    jdata = jdp.device_data_from_host(host)
    tdata = tdp.device_data_from_host(host, "cpu")
    idx = np.array([3, 7, 0, 5], np.int32)
    for seed in (0, 1):
        rng = jax.random.PRNGKey(seed)
        want = jdp.sample_batch(jdata, jnp.asarray(idx), rng, jc,
                                train=train)
        raw = tdp.gather(tdata, torch.from_numpy(idx.astype(np.int64)))
        draws = _jax_draws(rng, tc, 4, 96, train, sn)
        got = tdp.apply_sample(raw, draws, tc, train=train)
        assert got.keys() == want.keys()
        for k in got:
            w = np.asarray(want[k])
            g = got[k].numpy()
            assert g.shape == w.shape, k
            if k in ("label", "seg"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                assert g.dtype == np.float32
                np.testing.assert_allclose(g, w, rtol=0, atol=SAMPLE_ATOL,
                                           err_msg=k)


def _sample(cfg, host, idx, seed, train):
    data = tdp.device_data_from_host(host, "cpu")
    gen = torch.Generator().manual_seed(seed)
    return data, tdp.sample_batch(data, torch.as_tensor(idx), gen, cfg,
                                  train=train)


def test_eval_subsample_is_a_distinct_subset():
    cfg = tcfg.tiny_test().replace(input_pc_num=64)
    host = _raw(cfg)
    idx = [3, 7, 0, 5]
    data, b = _sample(cfg, host, idx, 0, False)
    assert b["pc"].shape == b["sn"].shape == (4, 64, 3)
    np.testing.assert_array_equal(b["label"].numpy(), host["label"][idx])
    for j, item in enumerate(idx):
        src, got = host["pc"][item], b["pc"][j].numpy()
        match = (np.abs(src[None] - got[:, None]).sum(-1) == 0)
        rows = match.argmax(1)
        assert match[np.arange(64), rows].all()
        assert len(set(rows.tolist())) == 64
        np.testing.assert_array_equal(b["sn"][j].numpy(),
                                      host["sn"][item][rows])
    np.testing.assert_array_equal(b["node"].numpy(), host["node"][idx])


def test_segment_labels_follow_the_subsample():
    cfg = tcfg.tiny_test().replace(task="segment", input_pc_num=48)
    T, n_raw = 6, 96
    host = _raw(cfg, T=T, n_raw=n_raw, seg=True)
    host["pc"] = np.tile(np.arange(n_raw, dtype=np.float32)[None, :, None],
                         (T, 1, 3))
    host["seg"] = np.tile(np.arange(n_raw, dtype=np.int64)[None], (T, 1))
    _, b = _sample(cfg, host, [0, 1, 2, 3], 2, False)
    np.testing.assert_array_equal(b["seg"].numpy(),
                                  b["pc"][..., 0].numpy().astype(np.int64))


def test_train_augmentation_ranges():
    """Jitter within its clips, one scale in U(0.8, 1.2) an item shared by
    points, normals and nodes; the rotations and the shift on top keep
    norms within their bounds."""
    cfg = tcfg.tiny_test().replace(input_pc_num=96)
    host = _raw(cfg, T=8)
    _, b = _sample(cfg, host, list(range(8)), 1, True)
    raw, got = host["pc"], b["pc"].numpy()
    scale = np.median((got / (raw + 1e-9)).reshape(8, -1), axis=1)
    assert ((scale > 0.79) & (scale < 1.21)).all()
    assert np.abs(got / scale[:, None, None] - raw).max() <= 0.0501
    node = np.median((b["node"].numpy() / (host["node"] + 1e-9)).reshape(
        8, -1), axis=1)
    np.testing.assert_allclose(node, scale, atol=0.05)
    cfg = cfg.replace(**AUGMENT)
    _, b = _sample(cfg, host, list(range(8)), 1, True)
    # |R x| = |x|: a rotated, jittered, scaled and shifted cloud keeps its
    # norms within the jitter, the scale and the shift
    n_raw = np.linalg.norm(raw, axis=-1)
    n_got = np.linalg.norm(b["pc"].numpy(), axis=-1)
    assert (n_got <= 1.2 * (n_raw + 0.05 * 3 ** 0.5) + 0.1 * 3 ** 0.5).all()
    assert (n_got >= 0.8 * np.maximum(n_raw - 0.05 * 3 ** 0.5, 0)
            - 0.1 * 3 ** 0.5).all()


def test_draws_differ_by_generator_state_and_repeat_by_seed():
    cfg = tcfg.tiny_test().replace(input_pc_num=48, **AUGMENT)
    host = _raw(cfg)
    data = tdp.device_data_from_host(host, "cpu")
    idx = torch.tensor([0, 1, 2, 3])
    gen = torch.Generator().manual_seed(4)
    a = tdp.sample_batch(data, idx, gen, cfg, train=True)
    b = tdp.sample_batch(data, idx, gen, cfg, train=True)
    c = tdp.sample_batch(data, idx, torch.Generator().manual_seed(4), cfg,
                         train=True)
    for k in ("pc", "sn", "node"):
        assert not torch.equal(a[k], b[k])
        assert torch.equal(a[k], c[k])


# ---------------------------------------------------------------------------
# epoch tables, chunks, and the Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,B", [(20, 4), (19, 4), (3, 4), (10, 8)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_index_tables_match_jax(T, B, shuffle):
    data = types.SimpleNamespace(size=T)
    for epoch in (0, 3):
        jself = types.SimpleNamespace(
            cfg=jcfg.tiny_test().replace(batch_size=B, seed=2), mesh=None)
        tself = types.SimpleNamespace(
            cfg=tcfg.tiny_test().replace(batch_size=B, seed=2))
        jt, jv = jtrainer.Trainer._device_epoch_index(jself, data, shuffle,
                                                      epoch)
        tt, tv = Trainer._device_epoch_index(tself, data, shuffle, epoch)
        assert tv == jv
        if jt is None:
            assert tt is None
        else:
            np.testing.assert_array_equal(tt, np.asarray(jt))
            assert tt.dtype == np.int64


def _id_host(T, N=16, M=4):
    rs = np.random.RandomState(0)
    return {"pc": rs.randn(T, N, 3).astype(np.float32),
            "sn": rs.randn(T, N, 3).astype(np.float32),
            "node": rs.randn(T, M, 3).astype(np.float32),
            "label": np.arange(T, dtype=np.int64)}      # label = item id


def test_chunks_cover_the_global_shuffle_like_jax():
    host = _id_host(20)
    bpi = tdp.split_nbytes(host) // 20
    cd = tdp.ChunkedDeviceData(host, budget_bytes=2 * 8 * bpi,
                               batch_size=4, device="cpu", seed=5)
    jd = jdp.ChunkedDeviceData(host, budget_bytes=2 * 8 * bpi,
                               batch_size=4, seed=5)
    assert (cd.chunk_items, cd.num_chunks) == (jd.chunk_items,
                                               jd.num_chunks) == (8, 3)

    def items(chunks):
        seen, sizes = [], []
        for dd, table, valids in chunks:
            labels = np.asarray(dd.label)
            sizes.append(len(table) * 4)
            for r, valid in zip(np.asarray(table), valids):
                seen.extend(labels[r[:valid]].tolist())
        return seen, sizes

    for shuffle, epoch, drop in ((True, 0, True), (True, 1, True),
                                 (False, 0, False)):
        got, sizes = items(cd.epoch_chunks(shuffle, epoch, 4, drop))
        want, _ = items(jd.epoch_chunks(shuffle, epoch, 4, drop))
        assert got == want and sorted(got) == list(range(20))
        assert sizes == [8, 8, 4]
    cd19 = tdp.ChunkedDeviceData(_id_host(19), 1, 4, "cpu", seed=0)
    assert cd19.chunk_items == 4
    seen = [int(dd.label[i]) for dd, table, valids in
            cd19.epoch_chunks(True, 0, 4, True) for i in table[0]]
    assert len(seen) == len(set(seen)) == 16


def test_an_abandoned_chunked_epoch_stops_its_thread():
    import threading
    cd = tdp.ChunkedDeviceData(_id_host(20), 1, 4, "cpu", seed=0)
    before = threading.active_count()
    for _ in cd.epoch_chunks(True, 0, 4, True):
        break
    assert threading.active_count() <= before


def _tcfg(tmp_path, name, **over):
    return tcfg.tiny_test().replace(checkpoints_dir=str(tmp_path), name=name,
                                    input_pipeline="device", **over)


def test_chunked_epochs_equal_resident_bit_for_bit(tmp_path):
    res = Trainer(_tcfg(tmp_path, "res", random_pc_dropout_lower_limit=0.8),
                  quiet=True, resume=False, device="cpu")
    chk = Trainer(_tcfg(tmp_path, "chk", random_pc_dropout_lower_limit=0.8,
                        device_budget_gb=4e-6),
                  quiet=True, resume=False, device="cpu")
    assert isinstance(res.device_train, tdp.DeviceData)
    assert isinstance(chk.device_train, tdp.ChunkedDeviceData)
    assert chk.device_train.num_chunks >= 3
    m_res, m_chk = res.fit(epochs=2), chk.fit(epochs=2)
    assert res.state.step == chk.state.step == 32
    assert m_res == m_chk
    a, b = res.model.state_dict(), chk.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_device_trainer_runs_and_evaluates_reproducibly(tmp_path):
    """On a ModelNet tree of 200-point clouds at 64 points, so eval draws
    its subsample: twice the same bits; a stop is honoured at the epoch's
    end; a synthetic segment run too."""
    cfg = _tcfg(tmp_path, "dev", dataset="modelnet", dataroot=str(tmp_path),
                input_pc_num=64, batch_size=2)
    data_cases._fake_modelnet(tmp_path, cfg)
    t = Trainer(cfg, quiet=True, resume=False, device="cpu")
    assert t.device_train.pc.shape == (4, 200, 3)
    t.request_stop()
    m = t.fit(epochs=3)
    assert t.state.step == 2 and np.isfinite(m["loss"])
    assert t.evaluate() == t.evaluate() == m
    s = Trainer(_tcfg(tmp_path, "seg", task="segment", classes=50),
                quiet=True, resume=False, device="cpu")
    m = s.fit(epochs=1)
    assert np.isfinite(m["loss"]) and 0.0 <= m["iou"] <= 1.0


@pytest.mark.parametrize("placement", ["sharded", "nowhere"])
def test_dataset_placement(tmp_path, capsys, placement):
    cfg = _tcfg(tmp_path, "pl", dataset_placement=placement)
    if placement == "nowhere":
        with pytest.raises(ValueError, match="dataset_placement"):
            Trainer(cfg, quiet=True, resume=False, device="cpu")
        return
    t = Trainer(cfg, quiet=True, resume=False, device="cpu")
    assert "using replicated" in capsys.readouterr().out
    assert isinstance(t.device_train, tdp.DeviceData)


def test_device_eval_matches_jax_device_eval(tmp_path):
    """The JAX package's device-pipeline Trainer and the port's, from the
    same weights and nodes, evaluate the synthetic test split alike."""
    over = dict(input_pipeline="device", compute_dtype="float32",
                checkpoints_dir=str(tmp_path), name="ev")
    j = jtrainer.Trainer(jcfg.tiny_test().replace(**over), quiet=True,
                         resume=False)
    t = Trainer(tcfg.tiny_test().replace(**dict(over, name="ev_t")),
                quiet=True, resume=False, device="cpu")
    t.device_eval.node.copy_(torch.from_numpy(np.array(j.device_eval.node)))
    t.device_eval.pc.copy_(torch.from_numpy(np.array(j.device_eval.pc)))
    load_jax_variables(t.model, flatten({"params": j.state.params,
                                         "batch_stats": j.state.batch_stats}))
    want, got = j.evaluate(), t.evaluate()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=EVAL_RTOL, abs=1e-6), k
