"""The repairs of ``sonet-torch retrieve`` and of the mesh check, on the CPU.

* ``retrieve`` against ``sonet retrieve`` on one checkpoint (the JAX
  package's initial weights with random BatchNorm statistics, carried by
  ``sonet_torch.convert``), over SHREC shapes of 60 points drawn down to
  ``input_pc_num`` 32: the scores within 1e-5 (float32 summed in another
  order), the same rank files (the same ids in the same order, the
  squared distances within 1e-5: a distance is the root of
  |a|^2 + |b|^2 - 2 a.b in float32, so a shape's distance to itself is
  the root of a rounding, 0 on one side and 7e-4 on the other).
  ``sonet_tpu`` draws an example batch first, which moves its loader to
  the next epoch and so every shape's point draw; the port skips that
  epoch.
* ``extract_scores`` receives ``sonet_tpu``'s ``scan_chunk``.
* ``infer``, ``retrieve``, the ``Trainer``, ``ServingEngine.from_run``
  and ``prep som`` with a batch that the mesh does not divide exit with
  "--mesh_shape: ..." before a dataset is built or a run read.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import models as jmodels
from sonet_tpu import retrieval as jretrieval
from sonet_tpu.tasks import retrieve as jretrieve
from sonet_tpu.train import checkpoints as jckpt
from sonet_tpu.train import state as jstate
from sonet_torch import config as tcfg
from sonet_torch import retrieval as tretrieval
from sonet_torch import train as ttrain
from sonet_torch.convert import flatten, load_jax_variables
from sonet_torch.models import build_model
from sonet_torch.tasks import infer as tinfer
from sonet_torch.tasks import retrieve as tretrieve
from sonet_torch.train import trainer as ttrainer

torch.set_num_threads(2)

FLAGS = dict(classes=3, batch_size=4, input_pc_num=32, node_num=9, k=2,
             som_k=0, feature_num=32, dropout=0.0, compute_dtype="float32")


def _shrec_tree(root, cfg, n_test=10, pts=60):
    """A SHREC16 tree whose shapes have more points than input_pc_num."""
    rows = cfg.rows
    rng = np.random.default_rng(5)
    cats = [f"cat{i}" for i in range(cfg.classes)]
    os.makedirs(root)
    with open(os.path.join(root, "category.txt"), "w") as f:
        f.write("\n".join(cats) + "\n")
    idx = 0
    for mode, n in (("train", 4), ("val", 3), ("test", n_test)):
        lines = []
        d = os.path.join(root, f"{rows}x{rows}", mode)
        os.makedirs(d)
        for i in range(n):
            name = f"{idx + 11:06d}"
            idx += 1
            c = i % cfg.classes
            np.savez(os.path.join(d, f"model_{name}.npz"),
                     pc=(c + 0.5 * rng.standard_normal((pts, 3))).astype(
                         np.float32),
                     sn=rng.standard_normal((pts, 3)).astype(np.float32),
                     som_node=(c + 0.5 * rng.standard_normal(
                         (cfg.node_num, 3))).astype(np.float32))
            lines.append(name if mode == "test" else f"{name},{cats[c]}")
        with open(os.path.join(root, f"{mode}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(argv of the Config flags, JAX checkpoint, port checkpoint) of the
    same weights."""
    base = tmp_path_factory.mktemp("retrieve")
    root = str(base / "shrec")
    jc = jcfg.shrec16().replace(dataroot=root, **FLAGS)
    tc = tcfg.shrec16().replace(dataroot=root, **FLAGS)
    _shrec_tree(root, tc)
    rs = np.random.RandomState(2)
    B, N, M = 4, tc.input_pc_num, tc.node_num
    example = (rs.randn(B, N, 3).astype(np.float32),
               rs.randn(B, N, 3).astype(np.float32),
               rs.randn(B, M, 3).astype(np.float32))
    jm = jmodels.build_model(jc)
    js = jstate.init_state(jm, jc, jax.random.PRNGKey(0), example)
    flat = {k: np.array(v) for k, v in flatten(
        {"params": js.params, "batch_stats": js.batch_stats}).items()}
    for k, v in flat.items():              # statistics off 0 and 1
        if k.endswith("/mean"):
            flat[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
    stats = {}
    for k, v in flat.items():
        coll, *path, leaf = k.split("/")
        if coll == "batch_stats":
            d = stats
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = jax.numpy.asarray(v)
    js = js.replace(batch_stats=stats)
    jpath = jckpt.save_checkpoint(str(base / "jax_ckpt"), js, 5)
    model = build_model(tc, device="cpu")
    load_jax_variables(model, flat)
    state = ttrain.init_state(tc, device="cpu", model=model)
    tpath = ttrain.save_checkpoint(str(base / "port_ckpt"), state, 5)
    argv = ["--dataroot", root]
    for k, v in FLAGS.items():
        argv += [f"--{k}", str(v)]
    return argv, jpath, tpath


def _scores_of(module, monkeypatch, store):
    """Record what the driver ranks and the chunk it extracts by."""
    extract, rank_all = module.extract_scores, module.rank_all

    def extract_scores(*args, **kwargs):
        store["scan_chunk"] = kwargs.get("scan_chunk", 1)
        return extract(*args, **kwargs)

    def ranked(scores, *a, **k):
        store["scores"] = np.asarray(scores.cpu() if torch.is_tensor(scores)
                                     else scores)
        return rank_all(scores, *a, **k)
    monkeypatch.setattr(module, "extract_scores", extract_scores)
    monkeypatch.setattr(module, "rank_all", ranked)


def test_retrieve_ranks_sonet_tpus_point_draws(checkpoints, tmp_path,
                                               monkeypatch):
    argv, jpath, tpath = checkpoints
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jgot, tgot = {}, {}
    _scores_of(jretrieval, monkeypatch, jgot)
    _scores_of(tretrieval, monkeypatch, tgot)
    jm = jretrieve.main(["--preset", "shrec16", "--checkpoint", jpath,
                         "--output_dir", str(jout)] + argv)
    tm = tretrieve.main(["--device", "cpu", "--preset", "shrec16",
                         "--checkpoint", tpath, "--output_dir", str(tout)]
                        + argv)
    assert tgot["scores"].shape == jgot["scores"].shape == (10, 3)
    np.testing.assert_allclose(tgot["scores"], jgot["scores"], rtol=1e-5,
                               atol=1e-5)
    # F2: the same chunk of batches between two fetches
    assert tgot["scan_chunk"] == jgot["scan_chunk"] == 2
    for k, v in jm.items():
        np.testing.assert_allclose(tm[k], v, rtol=1e-6)
    names = sorted(f for f in os.listdir(jout) if f != "gallery")
    assert names == sorted(f for f in os.listdir(tout) if f != "gallery")
    assert len(names) == 10
    for n in names:
        a = np.loadtxt(jout / n, ndmin=2)
        b = np.loadtxt(tout / n, ndmin=2)
        np.testing.assert_array_equal(b[:, 0], a[:, 0], err_msg=n)
        # squared: a distance is the root of |a|^2 + |b|^2 - 2 a.b, whose
        # rounding a shape's distance to itself reads (up to 7e-4 here)
        np.testing.assert_allclose(b[:, 1] ** 2, a[:, 1] ** 2, rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_without_the_skipped_epoch_the_draws_differ(checkpoints, tmp_path,
                                                     monkeypatch):
    """What the skipped epoch repairs: the port's loader streaming epoch 0
    scores other points than sonet_tpu does (so the test above can fail)."""
    argv, jpath, tpath = checkpoints
    jgot, tgot = {}, {}
    _scores_of(jretrieval, monkeypatch, jgot)
    _scores_of(tretrieval, monkeypatch, tgot)
    jretrieve.main(["--preset", "shrec16", "--checkpoint", jpath,
                    "--output_dir", str(tmp_path / "jax")] + argv)
    from sonet_torch.data.pipeline import BatchLoader
    monkeypatch.setattr(BatchLoader, "skip_epoch", lambda self: None)
    tretrieve.main(["--device", "cpu", "--preset", "shrec16",
                    "--checkpoint", tpath, "--output_dir",
                    str(tmp_path / "port")] + argv)
    assert np.abs(tgot["scores"] - jgot["scores"]).max() > 1e-3


# ---------------------------------------------------------------------------
# F3: the mesh's divisibility, checked before anything is loaded
# ---------------------------------------------------------------------------

WANT = "--mesh_shape: batch_size 3 must divide over the data axis (2)"


@pytest.fixture
def no_dataset(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a dataset was built")
    monkeypatch.setattr(ttrainer, "build_dataset", refuse)
    monkeypatch.setattr(tretrieve, "build_dataset", refuse)


def test_infer_exits_before_the_dataset(tmp_path, no_dataset):
    run = tmp_path / "run"
    run.mkdir()
    tcfg.tiny_test().save(str(run / "config.json"))     # and no checkpoint
    with pytest.raises(SystemExit, match="^--mesh_shape: batch_size 3"):
        tinfer.main(["--run", str(run), "--device", "cpu", "--mesh_shape",
                     "2", "--batch_size", "3"])
    with pytest.raises(SystemExit) as e:
        tinfer.main(["--run", str(run), "--device", "cpu", "--mesh_shape",
                     "1,3"])
    assert str(e.value) == ("--mesh_shape: input_pc_num 64 must divide "
                            "over the points axis (3)")


def test_retrieve_exits_before_the_dataset(no_dataset):
    with pytest.raises(SystemExit) as e:
        tretrieve.main(["--device", "cpu", "--preset", "tiny_test",
                        "--batch_size", "3", "--mesh_shape", "2"])
    assert str(e.value) == WANT


def test_trainer_from_run_and_prep_exit_alike(tmp_path, no_dataset):
    cfg = tcfg.tiny_test().replace(batch_size=3, mesh_shape=(2, 1),
                                   checkpoints_dir=str(tmp_path))
    with pytest.raises(SystemExit) as e:
        ttrainer.Trainer(cfg, quiet=True, device="cpu")
    assert str(e.value) == WANT
    assert not os.listdir(tmp_path)                     # nothing written
    run = tmp_path / "run"
    run.mkdir()
    tcfg.tiny_test().save(str(run / "config.json"))
    from sonet_torch.serving import ServingEngine
    with pytest.raises(SystemExit) as e:
        ServingEngine.from_run(str(run), device="cpu", batch_size=3,
                               mesh_shape=2)
    assert str(e.value) == WANT
    from sonet_torch.data import prep
    with pytest.raises(SystemExit) as e:
        prep.main(["som", "--root", str(tmp_path), "--device", "cpu",
                   "--batch", "3", "--mesh_shape", "2"])
    assert str(e.value) == WANT
