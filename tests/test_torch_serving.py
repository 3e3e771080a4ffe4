"""The PyTorch port's serving engine, config, device rule and import
boundary, on the CPU."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import serving as jserving
from sonet_torch import config as tcfg
from sonet_torch import serving as tserving
from sonet_torch.device import resolve_device
from sonet_torch.models import build_model
from sonet_torch.nn.encoder import resolve_pooling
from sonet_torch.parallel.mesh import mesh_shape_of, setup_mesh
from sonet_torch.serving import ServingEngine

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# served vs direct: the same float32 forward, but the matmuls see another
# number of rows (a padded chunk of 4 against the whole request), which
# may change the blocking and so the order of the sums
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)


def _request(cfg, n, seed=0):
    rs = np.random.RandomState(seed)
    N, M = cfg.input_pc_num, cfg.node_num
    pc = rs.randn(n, N, 3).astype(np.float32)
    return {"pc": pc, "sn": rs.randn(n, N, 3).astype(np.float32),
            "node": pc[:, :M] + 0.1 * rs.randn(n, M, 3).astype(np.float32)}


@pytest.fixture(scope="module", params=["auto", "sorted_window"])
def served(request):
    cfg = tcfg.tiny_test().replace(pooling=request.param)
    model = build_model(cfg, device="cpu", seed=0)
    engine = ServingEngine.from_model(model, cfg, device="cpu", batch_size=4)
    return cfg, model, engine


class TestServingEngine:
    @pytest.mark.parametrize("n", [1, 4, 7])
    def test_predict_equals_direct_call(self, served, n):
        cfg, model, engine = served
        req = _request(cfg, n, seed=n)
        got = engine.predict(req)
        with torch.no_grad():
            want, _ = model(*(torch.from_numpy(req[k])
                              for k in ("pc", "sn", "node")))
        assert got.shape == (n, cfg.classes) and got.dtype == np.float32
        np.testing.assert_allclose(got, want.numpy(), **SERVE_TOL)

    def test_stats_and_warmup(self):
        cfg = tcfg.tiny_test()
        engine = ServingEngine.from_model(build_model(cfg, device="cpu"),
                                          cfg, device="cpu", batch_size=4)
        engine.warmup()
        assert engine.stats()["requests"] == 0
        assert engine.stats()["dispatches"] == 0
        for n in (1, 4, 7):
            engine.predict(_request(cfg, n))
        s = engine.stats()
        assert (s["requests"], s["items"], s["dispatches"]) == (3, 12, 4)
        assert s["batch_size"] == 4 and s["task"] == "classify"
        assert engine.manifest["pooling"] == "scatter"
        assert engine.manifest["platforms"] == ["cpu"]

    def test_engine_serves_a_snapshot_of_the_weights(self):
        """An engine built from a train state's live module answers as the
        eval forward did when it was built, after a train step has switched
        that module to train mode and moved its weights; per-item answers
        do not depend on the batch, and serving moves none of the module's
        running statistics."""
        from sonet_torch import train as ttrain
        cfg = tcfg.tiny_test()
        state = ttrain.init_state(cfg, device="cpu", seed=0,
                                  steps_per_epoch=4)
        engine = ServingEngine.from_model(state.model, cfg, device="cpu",
                                          batch_size=4)
        req = _request(cfg, 4, seed=3)
        inputs = [torch.from_numpy(req[k]) for k in ("pc", "sn", "node")]
        state.model.eval()
        with torch.no_grad():
            want, _ = state.model(*inputs)
        train_step, _ = ttrain.make_steps(cfg, 4)
        batch = dict(zip(("pc", "sn", "node"), inputs),
                     label=torch.tensor([0, 1, 2, 3]))
        train_step(state, batch, torch.Generator().manual_seed(0))
        assert state.model.training
        key = "encoder.first_pointnet.PointLayer_0.BatchNorm_0.running_mean"
        stats = state.model.state_dict()[key].clone()
        got = engine.predict(req)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(engine.predict({k: v[:1] for k, v in
                                                   req.items()}),
                                   got[:1], **SERVE_TOL)
        assert torch.equal(state.model.state_dict()[key], stats)
        assert state.model.training

    def test_bad_inputs_rejected(self, served):
        cfg, _, engine = served
        req = _request(cfg, 2)
        with pytest.raises(ValueError, match="missing"):
            engine.predict({"pc": req["pc"]})
        with pytest.raises(ValueError, match="expected shape"):
            engine.predict(dict(req, pc=req["pc"][:, :5]))
        with pytest.raises(ValueError, match="inconsistent"):
            engine.predict(dict(req, sn=req["sn"][:1]))
        with pytest.raises(ValueError, match="empty"):
            engine.predict({k: v[:0] for k, v in req.items()})

    def test_signature_and_buckets_match_jax(self):
        for preset in ("modelnet40", "mnist", "tiny_test", "shapenetpart",
                       "autoencoder"):
            assert (tserving.input_signature(getattr(tcfg, preset)(), 3)
                    == jserving.input_signature(getattr(jcfg, preset)(), 3))
        for b in (1, 6, 8, 13):
            assert tserving.batch_buckets(b) == jserving.batch_buckets(b)
        with pytest.raises(ValueError):
            tserving.batch_buckets(0)


class TestDevice:
    def test_cuda_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = tcfg.tiny_test()
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)                     # the default is cuda
        model = build_model(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine.from_model(model, cfg)

    @staticmethod
    def served_mesh(mesh):
        """The mesh ``ServingEngine.from_run(mesh_shape=mesh)`` serves
        over: ``setup_mesh``'s rule, as every entry point's."""
        return setup_mesh(tcfg.Config(mesh_shape=mesh_shape_of(mesh)),
                          "cpu")[1]

    @pytest.mark.parametrize("mesh", [None, "", 0, 1, "1", "1,1", (1, 1)])
    def test_one_device_mesh_passes(self, mesh):
        # one device in a world of one: no mesh, no collectives
        assert self.served_mesh(mesh) is None

    @pytest.mark.parametrize("mesh", [2, "2", "4x2", (2, 1), [1, 4]])
    def test_a_mesh_of_devices_is_refused(self, mesh):
        # a mesh of several devices needs as many processes (--distributed)
        with pytest.raises(ValueError, match="one process per device"
                           ".*--distributed"):
            self.served_mesh(mesh)

    def test_a_mesh_that_is_no_shape_exits(self):
        with pytest.raises(SystemExit, match="--mesh_shape"):
            self.served_mesh("2,x,y")

    def test_auto_pooling_follows_the_device(self):
        cfg = tcfg.modelnet40()
        assert resolve_pooling(cfg, "cpu") == "scatter"
        assert resolve_pooling(cfg, torch.device("cuda")) == "sorted_window"
        pinned = cfg.replace(pooling="sorted_window")
        assert resolve_pooling(pinned, "cpu") == "sorted_window"
        with pytest.raises(ValueError):
            resolve_pooling(cfg.replace(pooling="bogus"), "cpu")

    def test_unported_task_raises(self):
        """Every task of the JAX package is ported; a task neither package
        knows is refused by name at each entry point."""
        from sonet_torch import train as ttrain
        bogus = tcfg.tiny_test().replace(task="detect")
        with pytest.raises(NotImplementedError, match="detect"):
            build_model(bogus, device="cpu")
        model = build_model(tcfg.tiny_test(), device="cpu")
        with pytest.raises(NotImplementedError, match="detect"):
            tserving.build_serve_fn(model, bogus)
        with pytest.raises(NotImplementedError, match="detect"):
            ttrain.make_steps(bogus, 10)
        for preset in ("autoencoder", "shapenetpart", "shrec16", "mnist"):
            ttrain.make_steps(getattr(tcfg, preset)(), 10)


class TestConfig:
    def test_fields_and_presets_match_jax(self):
        tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.Config)]
        jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.Config)]
        assert tf == jf
        assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)
        for name in tcfg.PRESETS:
            assert (tcfg.PRESETS[name]().to_dict()
                    == jcfg.PRESETS[name]().to_dict())

    def test_load_config_reads_a_jax_config_json(self, tmp_path):
        path = str(tmp_path / "config.json")
        jcfg.modelnet10().replace(normalization=None, seed=4).save(path)
        got = tcfg.load_config(path)
        assert got.to_dict() == jcfg.load_config(path).to_dict()
        assert got.normalization is None and got.mesh_shape == (1, 1)

    def test_node_num_must_be_square(self):
        with pytest.raises(ValueError, match="perfect square"):
            tcfg.tiny_test().replace(node_num=15).rows


class TestImportBoundary:
    def _sources(self):
        return (sorted((REPO / "sonet_torch").rglob("*.py"))
                + [REPO / "chip_smoke.py"]
                + sorted((REPO / "tools").glob("torch_*.py")))

    def test_sources_import_no_jax(self):
        pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|sonet_tpu)\b",
                         re.M)
        hits = [str(p) for p in self._sources() if pat.search(p.read_text())]
        assert not hits
        # the C++ sources the port builds are its own copies, under its
        # own tree, and include nothing of the JAX package
        native = sorted((REPO / "sonet_torch" / "native").glob("*.cpp"))
        assert [p.name for p in native] == ["loader.cpp", "segment_max.cpp"]
        inc = re.compile(r'^\s*#\s*include\s*[<"]([^>"]+)', re.M)
        for p in native:
            assert all("sonet" not in h for h in inc.findall(p.read_text()))
        from sonet_torch import native as tnative
        assert all(s.parent == REPO / "sonet_torch" / "native"
                   for s in tnative.SOURCES)

    def test_package_import_loads_no_jax(self):
        code = ("import sys, sonet_torch, sonet_torch.serving, "
                "sonet_torch.convert, sonet_torch.ops.cuda, "
                "sonet_torch.ops.iou, sonet_torch.nn.heads, "
                "sonet_torch.train.checkpoints, sonet_torch.nn.decoder, "
                "sonet_torch.ops.chamfer, sonet_torch.som, "
                "sonet_torch.data, sonet_torch.retrieval, "
                "sonet_torch.train.trainer, sonet_torch.cli, "
                "sonet_torch.tasks.classify, sonet_torch.tasks.partseg, "
                "sonet_torch.tasks.autoencode, sonet_torch.tasks.retrieve, "
                "sonet_torch.utils.logging, sonet_torch.utils.visualize, "
                "sonet_torch.data.sampler, sonet_torch.data.h5, "
                "sonet_torch.data.mnist, sonet_torch.data.prep, "
                "sonet_torch.tasks.infer, sonet_torch.tasks.reproduce, "
                "sonet_torch.tasks.serve, sonet_torch.data.device_pipeline, "
                "sonet_torch.data.native_loader, sonet_torch.native, "
                "sonet_torch.train.graphs, sonet_torch.tasks.export, "
                "sonet_torch.compat, sonet_torch.tasks.import_ckpt, "
                "sonet_torch.tasks.monitor, sonet_torch.utils.dashboard, "
                "sonet_torch.utils.profiling, sonet_torch.utils.tprof, "
                "sonet_torch.utils.hlocat, sonet_torch.ops.segment_sorted\n"
                "bad = [m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'flax', 'optax', 'sonet_tpu', 'h5py')]\n"
                "print(bad); sys.exit(1 if bad else 0)")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(REPO), os.environ.get("PYTHONPATH", "")]))
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr

    def test_sources_name_h5py_only_inside_data_h5s_functions(self):
        # h5py is optional and absent on the card's machine: the one
        # module that reads HDF5 imports it inside its functions
        hits = {}
        for p in self._sources():
            for ln in p.read_text().splitlines():
                if re.match(r"\s*(import|from)\s+h5py\b", ln):
                    hits.setdefault(p.relative_to(REPO).as_posix(),
                                    []).append(ln)
        assert hits == {"sonet_torch/data/h5.py": ["    import h5py"] * 2}

    def test_data_imports_with_h5py_hidden(self):
        code = ("import sys; sys.modules['h5py'] = None\n"
                "import sonet_torch.data, sonet_torch.data.h5 as h5, "
                "sonet_torch.data.prep, sonet_torch.tasks.infer\n"
                "try:\n    h5.load_h5('x.h5')\nexcept ImportError:\n"
                "    sys.exit(0)\nsys.exit(1)")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(REPO), os.environ.get("PYTHONPATH", "")]))
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr

    def test_chip_smoke_fails_without_a_card_or_the_package(self, tmp_path):
        # beside nothing of the repo, and (on a host without a card) in the
        # repo: a non-zero exit and no result line
        alone = tmp_path / "alone"
        alone.mkdir()
        shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
        dirs = [alone] if torch.cuda.is_available() else [alone, REPO]
        for cwd in dirs:
            r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                               capture_output=True, text=True, timeout=120)
            assert r.returncode != 0
            assert '"ok"' not in r.stdout
