"""The port's mesh sampler, HDF5 readers and ``prep`` command against the
JAX package's, on the CPU.

Sampling, the readers, ``prep sample``, ``check`` and ``ingest`` are numpy
and the stdlib on both sides, so their outputs are held byte for byte
(npz members by name, dtype and bytes: a zip's timestamps are not data).
``farthest_point_sampling_torch`` is held index for index to
``farthest_point_sampling_jax`` on random clouds, whose distances are
distinct.  ``prep som`` is a SOM fit in another framework: the files it
writes, their layouts and shapes are held exactly, and the nodes by their
quantization error (the mean distance of a point to its nearest node),
within 1% of the JAX fit's, as ``tests/test_torch_data.py`` holds the
synthetic nodes.
"""

import io
import json
import os
import tarfile
import zipfile
from contextlib import redirect_stderr, redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sonet_tpu.data import h5 as jh5
from sonet_tpu.data import prep as jprep
from sonet_tpu.data import sampler as jsampler
from sonet_torch.data import h5 as th5
from sonet_torch.data import prep as tprep
from sonet_torch.data import sampler as tsampler

torch.set_num_threads(2)

QE_RTOL = 1e-2


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            assert x[k].tobytes() == y[k].tobytes(), k


def _write_obj(path, kind, scale=1.0):
    """A cube of quads with ``v/vt/vn`` face tokens, or a pyramid of
    triangles and one quad."""
    if kind == "cube":
        v = [(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)]
        f = [(1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2), (3, 4, 8, 7),
             (1, 3, 7, 5), (2, 6, 8, 4)]
        faces = [" ".join(f"{i}/{i}/1" for i in q) for q in f]
    else:
        v = [(0, 0, 0), (2, 0, 0), (2, 1, 0), (0, 1, 0), (1, 0.5, 1.5)]
        faces = ["1 4 3 2", "1 2 5", "2 3 5", "3 4 5", "4 1 5"]
    with open(path, "w") as fh:
        fh.write("# fabricated\n")
        fh.writelines(f"v {a * scale} {b * scale} {c * scale}\n"
                      for a, b, c in v)
        fh.write("vt 0 0\nvn 0 0 1\n")
        fh.writelines(f"f {t}\n" for t in faces)


def _mesh_tree(root):
    for i, (cls, kind) in enumerate((("box", "cube"), ("box", "cube"),
                                     ("tent", "pyramid"))):
        os.makedirs(root / cls, exist_ok=True)
        _write_obj(root / cls / f"{cls}_{i:04d}.obj", kind, 1.0 + 0.5 * i)


def _run(main, argv):
    """(exit code, stdout, stderr) of a prep ``main``."""
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with redirect_stdout(out), redirect_stderr(err):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code or 0
    return code, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cube", "pyramid"])
def test_read_obj_matches_jax(tmp_path, kind):
    path = str(tmp_path / "m.obj")
    _write_obj(path, kind)
    (tv, tf), (jv, jf) = tsampler.read_obj(path), jsampler.read_obj(path)
    assert tf.shape == ((12, 3) if kind == "cube" else (6, 3))
    for a, b in ((tv, jv), (tf, jf)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_sample_normalize_and_fps_match_jax(tmp_path, seed):
    path = str(tmp_path / "m.obj")
    _write_obj(path, "pyramid", 1.7)
    v, f = tsampler.read_obj(path)
    got = tsampler.sample_mesh(v, f, 500, np.random.default_rng(seed))
    want = jsampler.sample_mesh(v, f, 500, np.random.default_rng(seed))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()
    n = tsampler.normalize_cloud(got[0])
    assert n.tobytes() == jsampler.normalize_cloud(want[0]).tobytes()
    assert abs(np.linalg.norm(n, axis=1).max() - 1.0) < 1e-5
    fps = tsampler.farthest_point_sampling(n, 20, np.random.default_rng(seed))
    assert fps.tobytes() == jsampler.farthest_point_sampling(
        n, 20, np.random.default_rng(seed)).tobytes()
    with pytest.raises(ValueError, match="degenerate"):
        tsampler.sample_mesh(v, np.zeros((2, 3), np.int64), 4)


@pytest.mark.parametrize("k,first", [(1, 0), (16, 0), (40, 7)])
def test_fps_torch_matches_jax(k, first):
    from sonet_tpu.data.sampler import farthest_point_sampling_jax
    pts = np.random.RandomState(k).randn(3, 300, 3).astype(np.float32)
    got = tsampler.farthest_point_sampling_torch(torch.from_numpy(pts), k,
                                                 first=first)
    want = np.asarray(farthest_point_sampling_jax(jnp.asarray(pts), k,
                                                  first=first))
    assert got.shape == (3, k) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(3):                  # k distinct points
        assert len(set(got[b].tolist())) == k


def test_fps_torch_takes_the_first_of_tied_maxima():
    # points 1 and 3 are equally far from point 0: the first one wins
    pts = torch.tensor([[[0.0, 0], [1, 0], [0.5, 0], [-1, 0]]])
    assert tsampler.farthest_point_sampling_torch(pts, 3).tolist() == [
        [0, 1, 3]]


# ---------------------------------------------------------------------------
# HDF5
# ---------------------------------------------------------------------------

def test_h5_loaders_match_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rs = np.random.RandomState(0)
    path = str(tmp_path / "ply_data.h5")
    with h5py.File(path, "w") as f:
        f["data"] = rs.randn(5, 64, 3).astype(np.float32)
        f["label"] = rs.randint(0, 40, (5, 1)).astype(np.uint8)
        f["pid"] = rs.randint(0, 50, (5, 64)).astype(np.uint8)
    for got, want in ((th5.load_h5(path), jh5.load_h5(path)),
                      (th5.load_h5_data_label_seg(path),
                       jh5.load_h5_data_label_seg(path))):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# prep sample / som
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("normalize", [False, True])
def test_prep_sample_matches_jax(tmp_path, normalize):
    _mesh_tree(tmp_path / "meshes")
    flags = ["--points", "300", "--seed", "3"] + (
        ["--normalize"] if normalize else [])
    rc_t, out_t, _ = _run(tprep.main, ["sample", "--root",
                                       str(tmp_path / "meshes"), "--out",
                                       str(tmp_path / "t")] + flags)
    rc_j, _, _ = _run(jprep.main, ["sample", "--root",
                                   str(tmp_path / "meshes"), "--out",
                                   str(tmp_path / "j")] + flags)
    assert rc_t == rc_j == 0 and "sampled 3 meshes" in out_t
    files = sorted(p.relative_to(tmp_path / "t")
                   for p in (tmp_path / "t").rglob("*.npz"))
    assert files == sorted(p.relative_to(tmp_path / "j")
                           for p in (tmp_path / "j").rglob("*.npz"))
    assert len(files) == 3
    for rel in files:
        _npz_equal(tmp_path / "t" / rel, tmp_path / "j" / rel)


def _cloud_tree(root, layout, n=6, pts=150):
    """Clouds without nodes: ModelNet ``.npy`` (N, 6) or npz {pc, sn}."""
    rng = np.random.default_rng(2)
    for i in range(n):
        d = root / f"cls{i % 2}"
        os.makedirs(d, exist_ok=True)
        pc = (rng.standard_normal((pts + 10 * i, 3))
              * rng.uniform(0.3, 1.0, 3)).astype(np.float32)
        if layout == "npy":
            np.save(d / f"cls{i % 2}_{i:04d}.npy",
                    np.concatenate([pc, pc], 1))
        else:
            np.savez(d / f"shape{i}.npz", pc=pc, sn=pc,
                     part_label=np.zeros(len(pc), np.int64))


def _qe(pcs, nodes):
    return float(np.mean([np.linalg.norm(
        p[:, None, :3] - q[None], axis=-1).min(-1).mean()
        for p, q in zip(pcs, nodes)]))


@pytest.mark.parametrize("layout", ["npy", "npz"])
def test_prep_som_matches_jax(tmp_path, layout):
    roots = {}
    for side in ("t", "j"):
        roots[side] = tmp_path / side
        _cloud_tree(roots[side], layout)
    # 6 clouds in batches of 4: the last batch is padded
    flags = ["--rows", "4", "--som_sample", "64", "--batch", "4",
             "--seed", "1"]
    rc_t, out_t, _ = _run(tprep.main, ["som", "--root", str(roots["t"]),
                                       "--device", "cpu"] + flags)
    rc_j, out_j, _ = _run(jprep.main, ["som", "--root", str(roots["j"])]
                          + flags)
    assert rc_t == rc_j == 0 and out_t == out_j == (
        "fitted 4x4 SOMs for 6 shapes\n")
    files = {side: sorted(str(p.relative_to(r)) for p in r.rglob("*.np*"))
             for side, r in roots.items()}
    assert files["t"] == files["j"]
    pcs, nodes = {"t": [], "j": []}, {"t": [], "j": []}
    for rel in files["t"]:
        if "_som_nodes" in rel or (layout == "npz"):
            for side in ("t", "j"):
                path = roots[side] / rel
                if layout == "npz":
                    with np.load(path) as z:
                        assert sorted(z.files) == [
                            "part_label", "pc", "sn", "som_node"]
                        node, pc = z["som_node"], z["pc"]
                else:
                    node = np.load(path)
                    pc = np.load(roots[side] / rel.split(os.sep, 1)[1])
                assert node.shape == (16, 3) and node.dtype == np.float32
                nodes[side].append(node)
                pcs[side].append(pc)
    assert len(nodes["t"]) == 6
    if layout == "npy":
        assert all(r.startswith("4x4_som_nodes") for r in files["t"]
                   if "_som_nodes" in r)
    q_t, q_j = _qe(pcs["t"], nodes["t"]), _qe(pcs["j"], nodes["j"])
    assert abs(q_t - q_j) <= QE_RTOL * q_j, (q_t, q_j)


def test_prep_som_refusals(tmp_path, monkeypatch):
    _cloud_tree(tmp_path, "npy", n=2)
    # a mesh of several devices needs as many processes (--distributed)
    with pytest.raises(ValueError, match="one process per device"):
        tprep.main(["som", "--root", str(tmp_path), "--mesh_shape", "2",
                    "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tprep.main(["som", "--root", str(tmp_path)])


# ---------------------------------------------------------------------------
# check
# ---------------------------------------------------------------------------

def _modelnet_tree(root, classes=2, per_class=3, rows=4, pts=80, nodes=True):
    rng = np.random.default_rng(4)
    names = [f"shape{c}" for c in range(classes)]
    os.makedirs(root, exist_ok=True)
    (root / f"modelnet{classes}_shape_names.txt").write_text(
        "\n".join(names) + "\n")
    for mode, base in (("train", 0), ("test", 100)):
        entries = []
        for nm in names:
            os.makedirs(root / nm, exist_ok=True)
            for j in range(per_class):
                ident = f"{nm}_{base + j + 1:04d}"
                np.save(root / nm / f"{ident}.npy",
                        rng.standard_normal((pts, 6)).astype(np.float32))
                if nodes:
                    d = root / f"{rows}x{rows}_som_nodes" / nm
                    os.makedirs(d, exist_ok=True)
                    np.save(d / f"{ident}.npy", rng.standard_normal(
                        (rows * rows, 3)).astype(np.float32))
                entries.append(ident)
        (root / f"modelnet{classes}_{mode}.txt").write_text(
            "\n".join(entries) + "\n")


def _shapenet_tree(root, rows=4, pts=60):
    from sonet_torch.data.shapenet import FOLDERS
    rng = np.random.default_rng(5)
    splits = {"train": [], "test": []}
    for folder in FOLDERS[:2]:
        os.makedirs(root / folder, exist_ok=True)
        for mode, base in (("train", 0), ("test", 100)):
            for j in range(2):
                name = f"{base + j:06d}"
                np.savez(root / folder / f"{name}_{rows}x{rows}.npz",
                         pc=rng.standard_normal((pts, 3)).astype(np.float32),
                         sn=rng.standard_normal((pts, 3)).astype(np.float32),
                         part_label=rng.integers(0, 4, pts),
                         som_node=rng.standard_normal(
                             (rows * rows, 3)).astype(np.float32))
                splits[mode].append(f"shape_data/{folder}/{name}")
    os.makedirs(root / "train_test_split", exist_ok=True)
    for mode, entries in splits.items():
        (root / "train_test_split" / f"shuffled_{mode}_file_list.json"
         ).write_text(json.dumps(entries))


def _shrec_tree(root, rows=4, pts=60):
    rng = np.random.default_rng(6)
    (root / "category.txt").write_text("a\nb\n")
    for mode, n in (("train", 4), ("val", 2)):
        os.makedirs(root / f"{rows}x{rows}" / mode)
        lines = []
        for i in range(n):
            name = f"{mode}{i}"
            np.savez(root / f"{rows}x{rows}" / mode / f"model_{name}.npz",
                     pc=rng.standard_normal((pts, 3)).astype(np.float32),
                     sn=rng.standard_normal((pts, 3)).astype(np.float32),
                     som_node=rng.standard_normal(
                         (rows * rows, 3)).astype(np.float32))
            lines.append(f"{name},{'ab'[i % 2]}")
        (root / f"{mode}.txt").write_text("\n".join(lines) + "\n")


def _break(root, how):
    """Damage a good ModelNet tree."""
    if how == "missing":
        os.remove(root / "shape1" / "shape1_0002.npy")
    elif how == "bad_shape":
        np.save(root / "shape0" / "shape0_0001.npy",
                np.zeros((80, 2), np.float32))
    elif how == "nans":
        a = np.load(root / "4x4_som_nodes" / "shape1" / "shape1_0101.npy")
        a[3, 1] = np.nan
        np.save(root / "4x4_som_nodes" / "shape1" / "shape1_0101.npy", a)
    elif how == "no_split_list":
        for mode in ("train", "test"):
            os.remove(root / f"modelnet2_{mode}.txt")


def _checks(tmp_path, layout, argv):
    """Both packages' ``prep check`` on the same tree: (code, report,
    problems) of each, the report's JSON parsed."""
    out = []
    for main in (tprep.main, jprep.main):
        code, stdout, stderr = _run(main, ["check"] + argv)
        out.append((code, json.loads(stdout.strip().splitlines()[-1]),
                    stderr))
    return out


@pytest.mark.parametrize("layout", ["modelnet", "shapenet", "shrec"])
def test_check_good_tree_matches_jax(tmp_path, layout):
    {"modelnet": _modelnet_tree, "shapenet": _shapenet_tree,
     "shrec": _shrec_tree}[layout](tmp_path)
    got, want = _checks(tmp_path, layout, [
        "--root", str(tmp_path), "--layout", layout, "--rows", "4",
        "--classes", "2", "--load", "-1"])
    assert got == want
    assert got[0] == 0 and got[1]["ok"] and got[1]["items_loaded"] > 0


@pytest.mark.parametrize("how", ["missing", "bad_shape", "nans",
                                 "no_split_list"])
def test_check_broken_tree_matches_jax(tmp_path, how):
    _modelnet_tree(tmp_path)
    _break(tmp_path, how)
    got, want = _checks(tmp_path, "modelnet", [
        "--root", str(tmp_path), "--layout", "modelnet", "--rows", "4",
        "--classes", "2", "--load", "-1"])
    assert got == want
    assert got[0] == 1 and not got[1]["ok"] and got[1]["problems"] >= 1
    word = {"missing": "missing:", "bad_shape": "shape (80, 2)",
            "nans": "non-finite", "no_split_list": "no split lists"}[how]
    assert word in got[2]


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

def _archive(tmp_path, kind):
    tree = tmp_path / "tree"
    _modelnet_tree(tree, nodes=True)
    if kind == "tar.gz":
        path = tmp_path / "mn2.tar.gz"
        with tarfile.open(path, "w:gz") as t:
            t.add(tree, arcname="published/modelnet2")
    else:
        path = tmp_path / "mn2.zip"
        with zipfile.ZipFile(path, "w") as z:
            for p in sorted(tree.rglob("*")):
                z.write(p, "published/modelnet2/" + str(p.relative_to(tree)))
    return path


@pytest.mark.parametrize("kind", ["tar.gz", "zip"])
def test_ingest_matches_jax(tmp_path, kind):
    arch = _archive(tmp_path, kind)
    reports = []
    for side, main in (("t", tprep.main), ("j", jprep.main)):
        dest = tmp_path / f"dest_{side}"
        code, stdout, stderr = _run(main, [
            "ingest", "--archive", str(arch), "--dest", str(dest),
            "--classes", "2", "--rows", "4"])
        assert code == 0, stderr
        lines = stdout.strip().splitlines()
        first = json.loads(lines[-2])
        assert first.pop("ingested") == str(dest)
        manifest = json.loads((dest / "ingest.json").read_text())
        tree = sorted(str(p.relative_to(dest)) for p in dest.rglob("*")
                      if p.name != "ingest.json")
        reports.append((first, manifest, json.loads(lines[-1])["ok"], tree))
    assert reports[0] == reports[1]
    first, manifest, ok, _ = reports[0]
    assert first == {"layout": "modelnet", "entries": 6} and ok
    assert manifest["root_in_archive"] == os.path.join("published",
                                                       "modelnet2")
    assert manifest["bytes"] == os.path.getsize(arch)
    assert len(manifest["sha256"]) == 64


@pytest.mark.parametrize("kind", ["zip", "tar.gz"])
def test_ingest_refuses_a_member_that_escapes(tmp_path, kind):
    if kind == "zip":
        arch = tmp_path / "evil.zip"
        with zipfile.ZipFile(arch, "w") as z:
            z.writestr("ok/readme.txt", "fine")
            z.writestr("../escaped.txt", "outside")
    else:
        arch = tmp_path / "evil.tar.gz"
        data = b"outside"
        with tarfile.open(arch, "w:gz") as t:
            info = tarfile.TarInfo("../escaped.txt")
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    errors = []
    for side, main in (("t", tprep.main), ("j", jprep.main)):
        with pytest.raises(Exception) as ei:
            main(["ingest", "--archive", str(arch), "--dest",
                  str(tmp_path / "d" / side)])
        errors.append((type(ei.value), str(ei.value)))
    assert errors[0] == errors[1]
    assert not (tmp_path / "d" / "escaped.txt").exists()
    assert not (tmp_path / "escaped.txt").exists()
