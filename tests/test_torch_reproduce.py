"""``sonet-torch reproduce`` (archive -> ingest -> som -> check -> train ->
gated verdict, one command) on the CPU, against ``sonet reproduce``.

The trees are those of ``tests/test_reproduce.py`` (tiny ModelNet,
ShapeNetPart and SHREC16 layouts without SOM nodes, packed as
``.tar.gz``), so the whole chain runs, and then its resume.  The JAX
package's command runs once on the ModelNet archive: both verdict lines
have the same keys, metric, gate, reference and exit-code rule; the
numbers are two different trainings' (torch cannot draw JAX's random
streams) and are held to their ranges.
"""

import json
import tarfile

import numpy as np
import pytest
import torch

from sonet_tpu.data.shapenet import FOLDERS
from sonet_tpu.tasks import reproduce as jreproduce
from sonet_torch.tasks import reproduce as treproduce
from test_reproduce import (_make_modelnet_tree, _make_shapenet_tree,
                            _make_shrec_tree)

torch.set_num_threads(2)

SMALL = ["--node_num", "16", "--k", "2", "--feature_num", "64",
         "--input_pc_num", "64", "--batch_size", "4", "--epochs", "1",
         "--checkpoint_every", "1", "--compute_dtype", "float32",
         "--check_load", "2"]


def _archive(tmp_path, make, arcname):
    tree = tmp_path / "tree"
    make(str(tree))
    arch = tmp_path / f"{arcname}.tar.gz"
    with tarfile.open(arch, "w:gz") as t:
        t.add(tree, arcname=arcname)
    return arch


def _verdict(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith('{"reproduce"')]
    assert len(lines) == 1, out
    return json.loads(lines[0])


def _modelnet_argv(arch, dest, runs):
    return ["--preset", "modelnet40", "--archive", str(arch), "--dest",
            str(dest), "--classes", "3", "--som_k", "4", "--checkpoints_dir",
            str(runs), "--som_sample", "256", "--som_batch", "16"] + SMALL


@pytest.fixture(scope="module")
def jax_verdict(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    arch = _archive(tmp, _make_modelnet_tree, "modelnet3")
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jreproduce.main(_modelnet_argv(arch, tmp / "data", tmp / "runs"))
    return rc, _verdict(out.getvalue())


def test_gates_are_the_jax_packages():
    assert treproduce.GATES == jreproduce.GATES


def test_modelnet_archive_to_verdict_and_resume(tmp_path, capsys,
                                                jax_verdict):
    arch = _archive(tmp_path, _make_modelnet_tree, "modelnet3")
    dest, runs = tmp_path / "data", tmp_path / "runs"
    argv = _modelnet_argv(arch, dest, runs) + ["--device", "cpu"]
    rc = treproduce.main(argv)
    out = capsys.readouterr().out
    v = _verdict(out)
    assert (dest / "ingest.json").exists()
    assert len(list((dest / "4x4_som_nodes" / "shape0").glob("*.npy"))) == 6
    assert '"ok": true' in out                       # prep check passed
    j_rc, jv = jax_verdict
    assert set(v) == set(jv)
    for k in ("reproduce", "metric", "gate", "paper", "reference"):
        assert v[k] == jv[k], k
    assert v["metric"] == "accuracy" and v["gate"] == 0.918
    for verdict, code in ((v, rc), (jv, j_rc)):
        assert 0.0 <= verdict["best"] <= 1.0
        assert set(verdict["final"]) == {"loss", "accuracy"}
        assert verdict["pass"] == (verdict["best"] > 0.918)
        assert code == (0 if verdict["pass"] else 1)

    # the same command again: the tree is reused, the run resumed, no epoch
    # is left, and the verdict is the restored checkpoint's
    rc2 = treproduce.main(argv)
    out2 = capsys.readouterr().out
    assert "reusing ingested tree" in out2
    assert "1/1 epochs already trained" in out2
    assert "fitting" not in out2                    # the nodes are there
    v2 = _verdict(out2)
    assert (v2["best"], v2["pass"], rc2) == (v["best"], v["pass"], rc)


def test_shapenetpart_layout(tmp_path, capsys, monkeypatch):
    arch = _archive(tmp_path, _make_shapenet_tree, "shapenetcore_partanno")
    dest = tmp_path / "data"
    argv = ["--preset", "shapenetpart", "--archive", str(arch), "--dest",
            str(dest), "--som_k", "4", "--checkpoints_dir",
            str(tmp_path / "runs"), "--som_sample", "128", "--som_batch",
            "8", "--device", "cpu"] + SMALL
    # without matplotlib the run goes on without its pictures
    from sonet_torch.utils import visualize
    monkeypatch.setattr(visualize, "available", lambda: False)
    rc = treproduce.main(argv)
    out = capsys.readouterr().out
    assert "eval pictures left out" in out
    v = _verdict(out)
    first = sorted((dest / FOLDERS[0]).glob("*_4x4.npz"))[0]
    with np.load(first) as z:
        assert "som_node" in z.files and z["som_node"].shape == (16, 3)
    assert v["metric"] == "iou" and v["gate"] == 0.835
    assert 0.0 <= v["best"] <= 1.0 and rc == (0 if v["pass"] else 1)
    rc2 = treproduce.main(argv)
    out2 = capsys.readouterr().out
    assert "reusing ingested tree" in out2
    assert "1/1 epochs already trained" in out2
    assert rc2 == (0 if _verdict(out2)["pass"] else 1)


def test_shrec16_layout(tmp_path, capsys):
    arch = _archive(tmp_path, _make_shrec_tree, "shrec2016")
    dest = tmp_path / "data"
    rc = treproduce.main(
        ["--preset", "shrec16", "--archive", str(arch), "--dest", str(dest),
         "--classes", "3", "--checkpoints_dir", str(tmp_path / "runs"),
         "--som_sample", "128", "--som_batch", "8", "--device", "cpu"]
        + SMALL)
    v = _verdict(capsys.readouterr().out)
    first = sorted((dest / "4x4" / "train").glob("model_*.npz"))[0]
    with np.load(first) as z:
        assert "som_node" in z.files and z["som_node"].shape == (16, 3)
    assert v["metric"] == "accuracy"
    assert v["gate"] is None and v["pass"] is None
    assert 0.0 <= v["best"] <= 1.0 and rc == 0


def test_broken_chains_exit_2(tmp_path, capsys):
    assert treproduce.main(["--preset", "modelnet40", "--device", "cpu"]) == 2
    assert "need --archive or --dataroot" in capsys.readouterr().err
    # a tree without its split lists, then one with a shape missing
    argv = ["--preset", "modelnet40", "--classes", "3", "--dataroot",
            str(tmp_path), "--som_sample", "64", "--device", "cpu"]
    assert treproduce.main(argv) == 2
    assert "cannot read the train split" in capsys.readouterr().err
    _make_modelnet_tree(str(tmp_path))
    (tmp_path / "shape2" / "shape2_0003.npy").unlink()
    assert treproduce.main(argv + ["--som_batch", "8"]) == 2
    err = capsys.readouterr().err
    assert "missing:" in err and "dataset validation failed" in err


def test_reproduce_defaults_to_cuda(tmp_path, monkeypatch):
    arch = _archive(tmp_path, _make_modelnet_tree, "modelnet3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        treproduce.main(_modelnet_argv(arch, tmp_path / "data",
                                       tmp_path / "runs"))
