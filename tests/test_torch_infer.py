"""``sonet-torch infer`` against ``sonet infer``, on the CPU.

A JAX run and a port run are written from the same weights (the JAX
package's initial variables with random BatchNorm statistics, carried
across by ``sonet_torch.convert``) and both are inferred over the same
fabricated test split: 10 ModelNet shapes (batches of 4, the last padded
with two copies), 6 ShapeNetPart shapes for segment and autoencode (the
autoencoder's cases are in ``tests/test_torch_infer_autoencode.py``: the
JAX package's eager init of its decoder takes 20 s of the CPU).  The
JAX side runs the scatter pooling path, as its own CPU tests do.  Rows of
``predictions.csv`` and the ``summary.json`` metrics agree: ``pred`` where
the port's top two logits are more than 1e-4 apart, the per-item metrics
and the summary within 1e-5 (float32 arithmetic summed in another order),
the Chamfer columns within 1e-5 relative.
"""

import csv
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu import models as jmodels
from sonet_tpu.tasks import infer as jinfer
from sonet_tpu.train import checkpoints as jckpt
from sonet_tpu.train import state as jstate
from sonet_torch import config as tcfg
from sonet_torch import train as ttrain
from sonet_torch.convert import flatten, load_jax_variables
from sonet_torch.data.pipeline import BatchLoader
from sonet_torch.models import build_model
from sonet_torch.tasks import infer as tinfer
from sonet_torch.train.trainer import build_dataset

torch.set_num_threads(2)

TOL = 1e-5
MARGIN = 1e-4


def _modelnet_tree(root, cfg, per_class=(3, 5), pts=100):
    """Two classes; 6 train and 10 test shapes with SOM nodes."""
    rng = np.random.default_rng(0)
    names = ["cone", "desk"]
    (root / f"modelnet{cfg.classes}_shape_names.txt").write_text(
        "\n".join(names) + "\n")
    for mode, n, base in (("train", per_class[0], 0),
                          ("test", per_class[1], 100)):
        entries = []
        for c, nm in enumerate(names):
            for j in range(n):
                ident = f"{nm}_{base + j + 1:04d}"
                for d, arr in ((root / nm, np.concatenate([
                        (c + 0.4 * rng.standard_normal((pts, 3))),
                        rng.standard_normal((pts, 3))], 1)),
                        (root / f"{cfg.rows}x{cfg.rows}_som_nodes" / nm,
                         c + 0.4 * rng.standard_normal((cfg.node_num, 3)))):
                    os.makedirs(d, exist_ok=True)
                    np.save(d / f"{ident}.npy", arr.astype(np.float32))
                entries.append(ident)
        (root / f"modelnet{cfg.classes}_{mode}.txt").write_text(
            "\n".join(entries) + "\n")


def _shapenet_tree(root, cfg, pts=100):
    from sonet_torch.data.shapenet import FOLDERS
    rng = np.random.default_rng(1)
    rows = cfg.rows
    splits = {"train": [], "test": []}
    for i in range(10):
        folder = FOLDERS[i % 2]
        mode = "train" if i < 4 else "test"
        os.makedirs(root / folder, exist_ok=True)
        pc = rng.standard_normal((pts, 3)).astype(np.float32)
        np.savez(root / folder / f"s{i:03d}_{rows}x{rows}.npz", pc=pc,
                 sn=rng.standard_normal((pts, 3)).astype(np.float32),
                 part_label=np.where(pc[:, 1] > 0, 4 * (i % 2),
                                     4 * (i % 2) + 1).astype(np.int64),
                 som_node=pc[:cfg.node_num] + 0.05)
        splits[mode].append(f"shape_data/{folder}/s{i:03d}")
    os.makedirs(root / "train_test_split")
    for mode, entries in splits.items():
        (root / "train_test_split" / f"shuffled_{mode}_file_list.json"
         ).write_text(json.dumps(entries))


TASKS = {
    "classify": (dict(dataset="modelnet", classes=2), _modelnet_tree),
    "segment": (dict(task="segment", dataset="shapenet", classes=50),
                _shapenet_tree),
    "autoencode": (dict(task="autoencode", dataset="shapenet"),
                   _shapenet_tree),
}


@pytest.fixture(scope="module", params=["classify", "segment"])
def runs(request, tmp_path_factory):
    return make_runs(request.param, tmp_path_factory)


def make_runs(task, tmp_path_factory):
    """(task, JAX run, port run, port config) from the same weights."""
    over, tree = TASKS[task]
    base = tmp_path_factory.mktemp(task)
    data = base / "data"
    data.mkdir()
    over = dict(over, dataroot=str(data), compute_dtype="float32",
                batch_size=4, checkpoints_dir=str(base), seed=3)
    jc = jcfg.tiny_test().replace(**over)
    tc = tcfg.tiny_test().replace(**over)
    tree(data, tc)
    rs = np.random.RandomState(2)
    B, N, M = 4, tc.input_pc_num, tc.node_num
    example = [rs.randn(B, N, 3).astype(np.float32),
               rs.randn(B, N, 3).astype(np.float32),
               rs.randn(B, M, 3).astype(np.float32)]
    if tc.task == "segment":
        example.append(np.zeros(B, np.int32))
    jm = jmodels.build_model(jc)
    # jstate.init_state's steps with the init jitted: the autoencoder's
    # eager init alone takes 20 s on the CPU
    variables = jax.jit(lambda r: jm.init(
        {"params": r, "dropout": jax.random.fold_in(r, 1)}, *example,
        train=False))(jax.random.PRNGKey(0))
    js = jstate.TrainState.create(
        apply_fn=jm.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jstate.make_optimizer(jc, 100))
    flat = flatten(variables)
    for k, v in flat.items():          # BatchNorm statistics off 0 and 1
        if k.endswith("/mean"):
            flat[k] = (0.1 * rs.randn(*v.shape)).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rs.uniform(0.5, 2.0, v.shape).astype(np.float32)
    js = js.replace(batch_stats=_nested(flat, "batch_stats"))
    jrun, trun = base / "jax_run", base / "port_run"
    jrun.mkdir()
    trun.mkdir()
    jc.replace(name="jax_run").save(str(jrun / "config.json"))
    jckpt.save_checkpoint(str(jrun / "ckpt"), js, 5)
    model = build_model(tc, device="cpu")
    load_jax_variables(model, flat)
    state = ttrain.init_state(tc, device="cpu", model=model)
    tc.replace(name="port_run").save(str(trun / "config.json"))
    ttrain.save_checkpoint(str(trun / "ckpt"), state, 5)
    return task, jrun, trun, tc


def _nested(flat, collection):
    import jax.numpy as jnp
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


def _rows(out_dir):
    with open(os.path.join(out_dir, "predictions.csv")) as f:
        rows = list(csv.reader(f))
    with open(os.path.join(out_dir, "summary.json")) as f:
        return rows[0], rows[1:], json.load(f)


def _port_margins(trun, cfg):
    """The gap between the top two logits of each test item, from the
    port's eval step on the run's weights."""
    state = ttrain.init_state(cfg, device="cpu")
    ttrain.restore_checkpoint(ttrain.latest_checkpoint(str(trun / "ckpt")),
                              state)
    _, eval_step = ttrain.make_steps(cfg, 1)
    out = []
    for b in BatchLoader(build_dataset(cfg, "test", "cpu"), cfg.batch_size,
                         shuffle=False, drop_last=False, pad_last=True):
        valid = int(b.pop("valid"))
        s = eval_step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        top = s["score"].topk(2, -1).values
        out += (top[:, 0] - top[:, 1])[:valid].tolist()
    return out


def test_infer_matches_jax(runs, tmp_path):
    check_infer_matches_jax(runs, tmp_path)


def check_infer_matches_jax(runs, tmp_path, pipeline="host"):
    """``sonet-torch infer`` against ``sonet infer`` with
    ``--input_pipeline pipeline`` on both sides."""
    task, jrun, trun, tc = runs
    flags = ["--input_pipeline", pipeline]
    want = jinfer.main(["--run", str(jrun), "--out", str(tmp_path / "j")]
                       + flags)
    got = tinfer.main(["--run", str(trun), "--out", str(tmp_path / "t"),
                       "--device", "cpu"] + flags)
    jh, jrows, jsum = _rows(tmp_path / "j")
    th, trows, tsum = _rows(tmp_path / "t")
    assert got == tsum and want == jsum
    assert th == jh == {"classify": ["index", "label", "pred", "correct"],
                        "segment": ["index", "label", "iou", "seg_accuracy"],
                        "autoencode": ["index", "chamfer", "chamfer_fwd",
                                       "chamfer_bwd"]}[task]
    n = 10 if task == "classify" else 6   # the last batch padded
    assert len(trows) == len(jrows) == tsum["items"] == jsum["items"] == n
    assert set(tsum) == set(jsum)
    assert tsum["checkpoint"].endswith("step_00000005.pt")
    for k, v in jsum.items():
        if k not in ("items", "checkpoint", "clouds_per_sec"):
            assert abs(tsum[k] - v) <= TOL * max(1.0, abs(v)), (k, tsum, jsum)
    if task == "classify":
        margins = _port_margins(trun, tc.replace(input_pipeline=pipeline))
        assert sum(m > MARGIN for m in margins) >= n - 1
        for t, j, m in zip(trows, jrows, margins):
            assert t[:2] == j[:2]
            if m > MARGIN:
                assert t[2:] == j[2:], (t, j, m)
    else:
        for t, j in zip(trows, jrows):
            assert t[0] == j[0]
            a, b = np.float64(t[1:]), np.float64(j[1:])
            if task == "segment":
                assert t[1] == j[1]
                np.testing.assert_allclose(a[1:], b[1:], rtol=0, atol=TOL)
            else:
                np.testing.assert_allclose(a, b, rtol=TOL, atol=0)


def test_scan_chunk_gives_the_same_rows(runs, tmp_path):
    check_scan_chunk(runs, tmp_path)


def check_scan_chunk(runs, tmp_path):
    _, _, trun, _ = runs
    out = {}
    for k in ("1", "16"):
        s = tinfer.main(["--run", str(trun), "--out", str(tmp_path / k),
                         "--scan_chunk", k, "--device", "cpu",
                         "--dump_arrays"])
        out[k] = _rows(tmp_path / k)[:2], s
        assert s["clouds_per_sec"] is None or s["clouds_per_sec"] > 0
    assert out["1"][0] == out["16"][0]
    for k in ("1", "16"):
        out[k][1].pop("clouds_per_sec")
    assert out["1"][1] == out["16"][1]
    dumped = sorted(os.listdir(tmp_path / "16"))
    if runs[0] != "classify":
        assert len([f for f in dumped if f.endswith(".npy")]) == 6
    else:                          # each item's class scores, pred their argmax
        _, rows, _ = _rows(tmp_path / "16")
        assert len([f for f in dumped if f.endswith(".npy")]) == len(rows)
        for r in rows:
            score = np.load(tmp_path / "16" / f"score_{int(r[0]):06d}.npy")
            assert score.shape == (
                tcfg.load_config(str(trun / "config.json")).classes,)
            assert int(score.argmax()) == int(r[2])


@pytest.mark.parametrize("flags,item", [
    # a mesh of several devices needs as many processes (--distributed)
    (["--mesh_shape", "2"], "one process per device"),
    (["--mesh_shape", "4,2"], "one process per device"),
])
def test_unported_flags_raise(runs, tmp_path, flags, item):
    _, _, trun, _ = runs
    with pytest.raises(ValueError, match=item):
        tinfer.main(["--run", str(trun), "--out", str(tmp_path),
                     "--device", "cpu"] + flags)


@pytest.mark.parametrize("source", ["flag", "run"])
def test_device_pipeline_streams_through_the_host_one(runs, tmp_path,
                                                      source):
    """``--input_pipeline device``, or a run trained with it, gives the host
    pipeline's rows and summary, as ``sonet infer`` does."""
    _, _, trun, tc = runs
    run, flags = trun, ["--input_pipeline", "device"]
    if source == "run":
        run, flags = tmp_path / "device_run", []
        shutil.copytree(trun, run)
        tc.replace(name="device_run", input_pipeline="device").save(
            str(run / "config.json"))
    out = {}
    for name, extra in (("host", ["--input_pipeline", "host"]),
                        ("device", flags)):
        s = tinfer.main(["--run", str(run), "--out", str(tmp_path / name),
                         "--device", "cpu"] + extra)
        s.pop("clouds_per_sec")
        out[name] = _rows(tmp_path / name)[:2], s
    assert out["device"] == out["host"]


def test_native_pipeline_matches_jax(runs, tmp_path, monkeypatch):
    """``--input_pipeline native`` on both sides: the two packages' native
    batches are byte-equal (``tests/test_torch_native_loader.py``).  The
    JAX package's library is built into this test's own directory: it
    would build beside its sources with no lock, where another worker's
    ``tests/test_native_loader.py`` may be building it."""
    from sonet_tpu import native as jnative
    monkeypatch.setattr(jnative, "_LIB", str(tmp_path / "libjax.so"))
    monkeypatch.setattr(jnative, "_lib", None)
    check_infer_matches_jax(runs, tmp_path, pipeline="native")


def test_infer_defaults_to_cuda(runs, tmp_path, monkeypatch):
    _, _, trun, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tinfer.main(["--run", str(trun), "--out", str(tmp_path)])
