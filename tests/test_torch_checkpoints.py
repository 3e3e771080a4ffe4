"""The port's checkpoints, run restore and segment serving, on the CPU:
``train/checkpoints.py`` (round trip, retention, ordering, atomic save,
encoder-only transfer between tasks) and ``ServingEngine.from_run``.

Restores are held bit for bit (``torch.equal``): a checkpoint stores the
tensors themselves.  Served scores against a direct call of the same
float32 model: 1e-5, since the matmuls may see another number of rows (a
padded chunk against the whole request) and sum in another order.
"""

import os

import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import serving as jserving
from sonet_torch import config as tcfg
from sonet_torch import serving as tserving
from sonet_torch import train as ttrain
from sonet_torch.models import build_model
from sonet_torch.serving import ServingEngine
from sonet_torch.train import checkpoints as ckpts

torch.set_num_threads(2)

SERVE_TOL = dict(rtol=1e-5, atol=1e-5)
SEG = dict(task="segment", classes=50, dropout=0.6)


def _batch(cfg, n, seed=0):
    rs = np.random.RandomState(seed)
    N, M = cfg.input_pc_num, cfg.node_num
    pc = rs.randn(n, N, 3).astype(np.float32)
    b = {"pc": pc, "sn": rs.randn(n, N, 3).astype(np.float32),
         "node": pc[:, :M] + 0.1 * rs.randn(n, M, 3).astype(np.float32)}
    if cfg.task == "segment":
        b["label"] = rs.randint(0, 16, n).astype(np.int32)
        b["seg"] = rs.randint(0, cfg.classes, (n, N)).astype(np.int64)
    else:
        b["label"] = rs.randint(0, cfg.classes, n).astype(np.int64)
    return b


def _trained(cfg, steps=2, seed=0):
    """A state after ``steps`` train steps (so that Adam holds moments and
    the BatchNorms running statistics)."""
    state = ttrain.init_state(cfg, device="cpu", seed=seed,
                              steps_per_epoch=10)
    step, _ = ttrain.make_steps(cfg, 10)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg, cfg.batch_size, seed).items()}
    for _ in range(steps):
        state, _ = step(state, batch, torch.Generator().manual_seed(seed))
    return state, batch


def _assert_same_tensors(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
        assert got[k].dtype == w.dtype and got[k].device == w.device, k


def _assert_same_optimizer(got, want):
    g, w = got.state_dict(), want.state_dict()
    assert g["param_groups"] == w["param_groups"]
    assert list(g["state"]) == list(w["state"])
    for i, entry in w["state"].items():
        assert set(g["state"][i]) == set(entry) == {"step", "exp_avg",
                                                    "exp_avg_sq"}
        for name, t in entry.items():
            r = g["state"][i][name]
            assert torch.equal(r, t), (i, name)
            assert r.dtype == t.dtype and r.device == t.device, (i, name)


@pytest.fixture(scope="module")
def seg_cfg():
    return tcfg.tiny_test().replace(**SEG)


@pytest.fixture(scope="module")
def seg_run(seg_cfg, tmp_path_factory):
    """A finished segment run: config.json and one checkpoint."""
    run = tmp_path_factory.mktemp("run")
    state, batch = _trained(seg_cfg, steps=3)
    seg_cfg.save(str(run / "config.json"))
    path = ttrain.save_checkpoint(str(run / "ckpt"), state, state.step)
    return str(run), path, state, batch


class TestCheckpointRoundTrip:
    def test_restore_is_bit_identical(self, seg_cfg, seg_run):
        _, path, state, batch = seg_run
        assert os.path.basename(path) == "step_00000003.pt"
        fresh = ttrain.init_state(seg_cfg, device="cpu", seed=99,
                                  steps_per_epoch=10)
        assert not torch.equal(
            fresh.model.segmenter.layer1.Dense_0.weight,
            state.model.segmenter.layer1.Dense_0.weight)
        out = ttrain.restore_checkpoint(path, fresh)
        assert out is fresh and fresh.step == state.step == 3
        _assert_same_tensors(fresh.model.state_dict(),
                             state.model.state_dict())
        _assert_same_optimizer(fresh.optimizer, state.optimizer)
        # running statistics came along, not only parameters
        bn = fresh.model.segmenter.layer4.BatchNorm_0
        assert float(bn.running_mean.abs().max()) > 0

    def test_resumed_run_continues_as_the_original(self, seg_cfg, seg_run):
        _, path, state, batch = seg_run
        step, _ = ttrain.make_steps(seg_cfg, 10)
        resumed = ttrain.restore_checkpoint(path, ttrain.init_state(
            seg_cfg, device="cpu", seed=5, steps_per_epoch=10))
        twin = ttrain.restore_checkpoint(path, ttrain.init_state(
            seg_cfg, device="cpu", seed=6, steps_per_epoch=10))
        outs = []
        for s in (resumed, twin):
            s, m = step(s, batch, torch.Generator().manual_seed(3))
            outs.append((float(m["loss"]), s))
        assert outs[0][0] == outs[1][0]
        _assert_same_tensors(outs[0][1].model.state_dict(),
                             outs[1][1].model.state_dict())
        _assert_same_optimizer(outs[0][1].optimizer, outs[1][1].optimizer)
        assert outs[0][1].step == 4

    def test_payload_loads_with_weights_only(self, seg_run):
        _, path, state, _ = seg_run
        payload = torch.load(path, weights_only=True)
        assert set(payload) == {"model", "optimizer", "step"}
        assert payload["step"] == 3
        assert set(payload["model"]) == set(state.model.state_dict())
        assert [g["name"] for g in payload["optimizer"]["param_groups"]] == [
            "encoder", "head"]

    def test_another_models_checkpoint_is_refused(self, seg_run):
        _, path, _, _ = seg_run
        other = ttrain.init_state(tcfg.tiny_test(), device="cpu")
        with pytest.raises(RuntimeError, match="state_dict"):
            ttrain.restore_checkpoint(path, other)


class TestRetentionAndOrder:
    @pytest.fixture(scope="class")
    def small(self):
        # a few hundred KB a file: som_k=0 and a narrow feature
        cfg = tcfg.tiny_test().replace(som_k=0, feature_num=16)
        return ttrain.init_state(cfg, device="cpu")

    def test_keep_newest_and_numeric_order_past_8_digits(self, small,
                                                         tmp_path):
        d = str(tmp_path / "ckpt")
        assert ttrain.latest_checkpoint(d) is None       # no directory yet
        steps = [5, 99999999, 100000000, 7, 1234567890]
        for s in steps:
            ttrain.save_checkpoint(d, small, s, keep=3)
        # lexicographic order would put step_100000000 before step_99999999
        assert sorted(os.listdir(d)) == [
            "step_100000000.pt", "step_1234567890.pt", "step_99999999.pt"]
        assert ckpts._finalized_steps(d) == [
            "step_99999999.pt", "step_100000000.pt", "step_1234567890.pt"]
        assert os.path.basename(ttrain.latest_checkpoint(d)) == (
            "step_1234567890.pt")
        ttrain.save_checkpoint(d, small, 8, keep=1)
        assert os.listdir(d) == ["step_1234567890.pt"]

    def test_keep_counts(self, small, tmp_path):
        d = str(tmp_path / "ckpt")
        for s in range(1, 6):
            path = ttrain.save_checkpoint(d, small, s)       # keep=3
            assert path == os.path.join(d, f"step_{s:08d}.pt")
        assert sorted(os.listdir(d)) == [f"step_{s:08d}.pt" for s in (3, 4, 5)]

    def test_leftover_temporary_is_ignored_and_swept(self, small, tmp_path):
        d = tmp_path / "ckpt"
        ttrain.save_checkpoint(str(d), small, 10)
        # what a crashed save leaves: a later step's half-written file
        stale = d / "step_00000020.pt.tmp-12345"
        stale.write_bytes(b"half a checkpoint")
        (d / "notes.txt").write_text("not a checkpoint")
        assert os.path.basename(ttrain.latest_checkpoint(str(d))) == (
            "step_00000010.pt")
        assert ckpts._finalized_steps(str(d)) == ["step_00000010.pt"]
        ttrain.save_checkpoint(str(d), small, 11)
        assert sorted(os.listdir(d)) == ["notes.txt", "step_00000010.pt",
                                         "step_00000011.pt"]

    def test_save_is_atomic(self, small, tmp_path, monkeypatch):
        """A save that dies while writing leaves no file under a
        checkpoint's name: the latest stays the last whole one."""
        d = str(tmp_path / "ckpt")
        ttrain.save_checkpoint(d, small, 1)

        def dies(obj, f, *a, **kw):
            with open(f, "wb") as fh:
                fh.write(b"half")
            raise OSError("disk full")

        monkeypatch.setattr(ckpts.torch, "save", dies)
        with pytest.raises(OSError):
            ttrain.save_checkpoint(d, small, 2)
        monkeypatch.undo()
        assert os.path.basename(ttrain.latest_checkpoint(d)) == (
            "step_00000001.pt")
        left = [n for n in os.listdir(d) if n != "step_00000001.pt"]
        assert len(left) == 1 and ".tmp-" in left[0]
        ttrain.restore_checkpoint(ttrain.latest_checkpoint(d), small)


class TestRestoreEncoder:
    def test_classifier_encoder_into_a_segmenter(self, seg_cfg, tmp_path):
        cls_cfg = tcfg.tiny_test()
        cls_state, _ = _trained(cls_cfg, steps=2, seed=1)
        path = ttrain.save_checkpoint(str(tmp_path / "ckpt"), cls_state, 2)
        seg_state, _ = _trained(seg_cfg, steps=1, seed=2)
        before = {k: v.clone() for k, v in
                  seg_state.model.state_dict().items()}
        opt_before = seg_state.optimizer.state_dict()["state"][0][
            "exp_avg"].clone()
        out = ttrain.restore_encoder(path, seg_state)
        assert out is seg_state and seg_state.step == 1
        after = seg_state.model.state_dict()
        saved = cls_state.model.state_dict()
        enc = [k for k in after if k.startswith("encoder.")]
        assert len(enc) == len([k for k in saved if k.startswith("encoder.")])
        assert any(k.endswith("running_var") for k in enc)
        for k, v in after.items():
            if k.startswith("encoder."):
                assert torch.equal(v, saved[k]), k
            else:
                assert k.startswith("segmenter.")
                assert torch.equal(v, before[k]), k
        w = "encoder.first_pointnet.PointLayer_0.Dense_0.weight"
        assert not torch.equal(after[w], before[w])
        assert torch.equal(
            seg_state.optimizer.state_dict()["state"][0]["exp_avg"],
            opt_before)

    def test_shape_mismatch_raises_and_changes_nothing(self, seg_cfg,
                                                       tmp_path):
        wide = ttrain.init_state(tcfg.tiny_test().replace(feature_num=32),
                                 device="cpu")
        path = ttrain.save_checkpoint(str(tmp_path / "ckpt"), wide, 0)
        seg_state = ttrain.init_state(seg_cfg, device="cpu", seed=4)
        before = {k: v.clone() for k, v in
                  seg_state.model.state_dict().items()}
        with pytest.raises(ValueError, match="final_pointnet"):
            ttrain.restore_encoder(path, seg_state)
        _assert_same_tensors(seg_state.model.state_dict(), before)

    def test_other_encoder_layout_raises(self, seg_cfg, tmp_path):
        no_knn = ttrain.init_state(tcfg.tiny_test().replace(som_k=0),
                                   device="cpu")
        path = ttrain.save_checkpoint(str(tmp_path / "ckpt"), no_knn, 0)
        with pytest.raises(KeyError, match="knnlayer"):
            ttrain.restore_encoder(path, ttrain.init_state(seg_cfg,
                                                           device="cpu"))


class TestFromRun:
    def test_from_run_equals_from_model(self, seg_cfg, seg_run):
        run, path, state, _ = seg_run
        from_run = ServingEngine.from_run(run, device="cpu")
        from_model = ServingEngine.from_model(state.model, seg_cfg,
                                              device="cpu")
        req = _batch(seg_cfg, 6, seed=9)
        req.pop("seg")
        a, b = from_run.predict(req), from_model.predict(req)
        assert a.shape == (6, seg_cfg.input_pc_num, 50)
        np.testing.assert_array_equal(a, b)
        m = from_run.manifest
        assert m["source"] == "run" and m["checkpoint"] == path
        assert m["task"] == "segment" and m["classes"] == 50
        assert m["output"] == "per-point score (B, N, classes)"
        assert from_model.manifest["source"] == "model"
        assert "checkpoint" not in from_model.manifest
        assert from_run.batch_size == seg_cfg.batch_size == 4

    def test_batch_size_and_checkpoint_arguments(self, seg_cfg, seg_run,
                                                 tmp_path):
        run, path, state, _ = seg_run
        engine = ServingEngine.from_run(run, batch_size=3, checkpoint=path,
                                        device="cpu")
        assert engine.batch_size == 3
        assert engine.manifest["inputs"][3] == {
            "name": "label", "shape": [3], "dtype": "int32"}
        req = _batch(seg_cfg, 2, seed=10)
        req.pop("seg")
        with torch.no_grad():
            want, _ = state.model.eval()(*(torch.from_numpy(req[k]) for k in
                                           ("pc", "sn", "node", "label")))
        np.testing.assert_allclose(engine.predict(req), want.numpy(),
                                   **SERVE_TOL)

    def test_run_without_a_checkpoint_raises(self, seg_cfg, tmp_path):
        seg_cfg.save(str(tmp_path / "config.json"))
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            ServingEngine.from_run(str(tmp_path), device="cpu")

    def test_from_run_on_cuda_without_a_card_raises(self, seg_run,
                                                    monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine.from_run(seg_run[0])           # the default is cuda

    def test_a_classifier_run_serves_too(self, tmp_path):
        cfg = tcfg.tiny_test()
        state, _ = _trained(cfg, steps=1)
        cfg.save(str(tmp_path / "config.json"))
        ttrain.save_checkpoint(str(tmp_path / "ckpt"), state, state.step)
        engine = ServingEngine.from_run(str(tmp_path), device="cpu")
        req = {k: v for k, v in _batch(cfg, 5, seed=3).items()
               if k != "label"}
        want = ServingEngine.from_model(state.model, cfg,
                                        device="cpu").predict(req)
        np.testing.assert_array_equal(engine.predict(req), want)


class TestSegmentServing:
    @pytest.fixture(scope="class", params=["auto", "sorted_window"])
    def served(self, request):
        cfg = tcfg.tiny_test().replace(**SEG, pooling=request.param)
        model = build_model(cfg, device="cpu", seed=0)
        return cfg, model, ServingEngine.from_model(model, cfg, device="cpu",
                                                    batch_size=4)

    @pytest.mark.parametrize("n", [1, 4, 7])
    def test_predict_equals_direct_call(self, served, n):
        cfg, model, engine = served
        req = _batch(cfg, n, seed=n)
        req.pop("seg")
        got = engine.predict(req)
        with torch.no_grad():
            want, _ = model(*(torch.from_numpy(req[k])
                              for k in ("pc", "sn", "node", "label")))
        assert got.shape == (n, cfg.input_pc_num, 50)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want.numpy(), **SERVE_TOL)

    def test_padding_repeats_the_last_item_for_every_input(self, served):
        """A request of 5 at batch size 4 dispatches 4 + (1 padded with 3
        copies of itself): the int label is padded like the arrays."""
        cfg, _, engine = served
        req = _batch(cfg, 5, seed=20)
        req.pop("seg")
        seen = []
        inner = engine._fn
        engine._fn = lambda *arrays: (seen.append(arrays), inner(*arrays))[1]
        try:
            out = engine.predict(req)
        finally:
            engine._fn = inner
        assert out.shape[0] == 5 and len(seen) == 2
        names = engine.input_names
        assert names == ["pc", "sn", "node", "label"]
        for name, a in zip(names, seen[1]):
            assert a.shape[0] == 4
            for i in range(4):
                np.testing.assert_array_equal(a[i], req[name][4])
        assert seen[1][3].dtype == np.int32
        # the label matters: another category gives other scores
        other = dict(req, label=(req["label"] + 1) % 16)
        assert np.abs(engine.predict(other) - out).max() > 1e-3

    def test_label_is_required_and_checked(self, served):
        cfg, _, engine = served
        req = _batch(cfg, 2)
        req.pop("seg")
        with pytest.raises(ValueError, match="missing inputs \\['label'\\]"):
            engine.predict({k: v for k, v in req.items() if k != "label"})
        with pytest.raises(ValueError, match="inconsistent"):
            engine.predict(dict(req, label=req["label"][:1]))
        with pytest.raises(ValueError, match="expected shape"):
            engine.predict(dict(req, label=req["label"][:, None]))

    def test_signature_matches_jax(self):
        for preset in ("shapenetpart", "modelnet40"):
            assert (tserving.input_signature(getattr(tcfg, preset)(), 5)
                    == jserving.input_signature(getattr(jcfg, preset)(), 5))
        assert tserving.input_signature(tcfg.shapenetpart())[-1] == (
            "label", (8,), "int32")
        assert tserving._OUTPUT_DOC["segment"] == jserving._OUTPUT_DOC[
            "segment"]

    def test_warmup_serves_a_segmenter(self, served):
        _, _, engine = served
        before = engine.stats()
        engine.warmup()
        assert engine.stats() == before
