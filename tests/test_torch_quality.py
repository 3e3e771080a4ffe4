"""The port's quality chain (``tools/torch_*``) against the JAX package's
tools (``tools/make_*_scale.py``, ``soak.py``, ``soak_retrieval.py``,
``quality.py``), on the CPU at a tiny size.

* Each ``torch_make_*_scale.py`` writes the tree its JAX original writes
  for the same arguments and seed (the original run in a subprocess on
  the CPU): the same files, ``.npy`` / ``.txt`` / ``.json`` byte for byte
  and ``.npz`` array for array (dtype, shape, ``==``) and member for
  member byte for byte (``mnist.npz`` among them).
* ``torch_soak.load_band``, ``torch_quality.parse_soak_output`` and
  ``torch_quality.FAMILIES`` equal the JAX tools'.
* ``torch_soak.py`` and ``torch_soak_retrieval.py`` with ``--device cpu``
  for one epoch at a narrow width on generated trees (3 classes, 256
  points a shape; nodes from ``sonet_torch``'s ``prep som`` on the CPU):
  the exit code and the band line for a band that must pass and one that
  must fail, each line read alike by both packages' parsers; the
  retrieval soak's test ids, ground truth and point draws are those of
  ``soak_retrieval.py``'s loader and rule.
* ``torch_quality.py`` runs its chain on the CPU (its first two stages
  skipped on a tree that has their outputs) and writes an artifact with
  ``quality.py``'s keys plus ``device`` and ``package``.
* ``torch_transfer_demo.py`` pretrains, transfers and fine-tunes.
"""

import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import torch_make_mnist_scale  # noqa: E402
import torch_make_modelnet_scale  # noqa: E402
import torch_make_shapenet_scale  # noqa: E402
import torch_make_shrec_scale  # noqa: E402
import torch_quality  # noqa: E402
import torch_soak  # noqa: E402
import torch_soak_retrieval  # noqa: E402
import torch_transfer_demo  # noqa: E402

torch.set_num_threads(2)

# the narrow width every CPU run here takes
NARROW = ["--batch_size", "2", "--input_pc_num", "128", "--feature_num",
          "64"]
SHREC_BLOCK = 9   # 6 train, 1 val, 2 test shapes a class


def _jax_tool(name):
    """A JAX tool as a module, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _prep_som(root, batch):
    from sonet_torch.data import prep
    prep.main(["som", "--root", root, "--rows", "8", "--batch", str(batch),
               "--som_sample", "256", "--device", "cpu"])


def _run(fn, argv):
    """(exit code, standard output) of a tool's ``main(argv)``."""
    out = io.StringIO()
    rc = 0
    with contextlib.redirect_stdout(out):
        try:
            fn(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Tiny ModelNet and SHREC trees from the port's generators, nodes
    fitted by the port's ``prep som`` on the CPU."""
    root = tmp_path_factory.mktemp("quality")
    mn, sh = str(root / "mn"), str(root / "shrec")
    with contextlib.redirect_stdout(io.StringIO()):
        torch_make_modelnet_scale.main(
            ["--out", mn, "--classes", "3", "--train_per_class", "2",
             "--test_per_class", "1", "--points", "256", "--hardness",
             "0.15"])
        torch_make_shrec_scale.main(
            ["--out", sh, "--classes", "3", "--per_class", str(SHREC_BLOCK),
             "--points", "256", "--hardness", "0.35"])
        assert torch_quality.need_som("modelnet40", mn, 8)
        assert torch_quality.need_som("shrec16", sh, 8)
        _prep_som(mn, 9)
        _prep_som(sh, 27)
    assert not torch_quality.need_som("modelnet40", mn, 8)
    assert not torch_quality.need_som("shrec16", sh, 8)
    return {"root": root, "modelnet": mn, "shrec": sh}


# -- the generators ---------------------------------------------------------

GENERATORS = {
    "modelnet": (torch_make_modelnet_scale, "make_modelnet_scale.py",
                 ["--classes", "3", "--train_per_class", "2",
                  "--test_per_class", "1", "--points", "256",
                  "--hardness", "0.15"]),
    "shapenet": (torch_make_shapenet_scale, "make_shapenet_scale.py",
                 ["--train_per_cat", "2", "--test_per_cat", "1",
                  "--points", "256", "--hardness", "0.7"]),
    "shrec": (torch_make_shrec_scale, "make_shrec_scale.py",
              ["--classes", "3", "--per_class", "6", "--points", "256",
               "--hardness", "0.35", "--seed", "3"]),
    "mnist": (torch_make_mnist_scale, "make_mnist_scale.py",
              ["--train", "40", "--test", "10", "--seed", "5"]),
}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    """Each JAX generator's tree, written by a subprocess on the CPU; the
    three start together."""
    root = tmp_path_factory.mktemp("jax_trees")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    children = {}
    for family, (_, original, args) in GENERATORS.items():
        want = str(root / family)
        children[family] = want, subprocess.Popen(
            [sys.executable, os.path.join(TOOLS, original), "--out", want]
            + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env)
    yield children
    for _, child in children.values():
        child.kill()
        child.communicate()


@pytest.mark.parametrize("family", sorted(GENERATORS))
def test_generator_writes_what_the_jax_original_writes(family, jax_trees,
                                                       tmp_path):
    port, _, args = GENERATORS[family]
    got = str(tmp_path / "torch")
    with contextlib.redirect_stdout(io.StringIO()) as said:
        port.main(["--out", got] + args)
    want, child = jax_trees[family]
    out, err = child.communicate(timeout=120)
    assert child.returncode == 0, err
    assert said.getvalue() == out.replace(want, got)
    files = _files(want)
    assert files == _files(got) and files
    for rel in files:
        a, b = os.path.join(want, rel), os.path.join(got, rel)
        if rel.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert sorted(x.files) == sorted(y.files), rel
                for k in x.files:
                    assert x[k].dtype == y[k].dtype, (rel, k)
                    assert x[k].shape == y[k].shape, (rel, k)
                    assert np.array_equal(x[k], y[k]), (rel, k)
            # each member's bytes too (the archives' own bytes hold the
            # time each member was written)
            with zipfile.ZipFile(a) as x, zipfile.ZipFile(b) as y:
                assert x.namelist() == y.namelist(), rel
                for name in x.namelist():
                    assert x.read(name) == y.read(name), (rel, name)
        else:
            assert rel.endswith((".npy", ".txt", ".json")), rel
            with open(a, "rb") as x, open(b, "rb") as y:
                assert x.read() == y.read(), rel


# -- the band table, the parser, the families --------------------------------

@pytest.mark.parametrize("preset", ["modelnet40", "shapenetpart", "shrec16"])
def test_load_band_is_the_jax_tools(preset, capsys):
    want = _jax_tool("soak").load_band(preset)
    want_line = capsys.readouterr().out
    assert torch_soak.load_band(preset) == want
    assert capsys.readouterr().out == want_line


def test_load_band_refuses_an_unknown_preset():
    with pytest.raises(SystemExit):
        torch_soak.load_band("no_such_preset")


def _jax_parse():
    return _jax_tool("quality").parse_soak_output


SOAK_OUTPUTS = {
    "classify": ("""\
band: modelnet40: [0.838, 0.91] on tools/make_modelnet_scale.py ...
epoch 29: 4.30 ms/step sustained = 1861.6 clouds/s (accuracy 0.3750)
eval: {'accuracy': 0.8576612903225806, 'loss': 0.4424035273973019}
band check: accuracy 0.8577 INSIDE [0.838, 0.91]
""", 0),
    "retrieval": ("""\
epoch 19: 3.97 ms/step = 2012.9 clouds/s (loss 1.2539 acc 0.375)
wrote 825 rank files to /tmp/soak_shrec/rank
retrieval metrics (ground-truth labels): {'mAP': 0.6791, 'P@1': 0.8242}
band check: mAP 0.6791 OUTSIDE [0.616, 0.676]
""", 0),
    "crash": ("epoch 0: crash\n", 1),
    "empty": ("", 0),
}


@pytest.mark.parametrize("case", sorted(SOAK_OUTPUTS))
def test_parse_soak_output_is_the_jax_tools(case):
    out, rc = SOAK_OUTPUTS[case]
    assert torch_quality.parse_soak_output(out, rc) == _jax_parse()(out, rc)


def test_families_are_the_jax_tools():
    want = _jax_tool("quality").FAMILIES
    assert sorted(torch_quality.FAMILIES) == sorted(want)
    for preset, (gen, root, rows) in want.items():
        assert torch_quality.FAMILIES[preset] == ("torch_" + gen, root, rows)
        assert os.path.exists(os.path.join(TOOLS, "torch_" + gen))


# -- the soaks on the CPU ------------------------------------------------------

@pytest.mark.parametrize("band,want_rc,verdict", [
    (["--band"], 1, "OUTSIDE"),                 # 3 test shapes: 0, 1/3, ...
    (["--assert_band", "0,1"], 0, "INSIDE")])
def test_soak_band_line_and_exit_code(trees, tmp_path, band, want_rc,
                                      verdict):
    rc, out = _run(torch_soak.main, [
        "--dataroot", trees["modelnet"], "--epochs", "1", "--device", "cpu",
        "--input_pipeline", "device", "--out", str(tmp_path),
        "--save", "--classes", "3"] + NARROW + band)
    assert rc == want_rc, out
    lines = [ln for ln in out.splitlines() if ln.startswith("band check:")]
    assert len(lines) == 1 and lines[0].split()[4] == verdict, out
    epoch = [ln for ln in out.splitlines() if ln.startswith("epoch 0: ")]
    assert len(epoch) == 1 and "lr 0.001, captures 0)" in epoch[0]
    # 3 steps: the epoch's mean accuracy is one of 0, 1/6, ..., 1
    mean = float(epoch[0].split("mean_accuracy ")[1].split()[0])
    assert round(mean * 6, 3) == round(mean * 6) and 0 <= mean <= 1
    ckpt = [ln.split(": ", 1)[1] for ln in out.splitlines()
            if ln.startswith("checkpoint: ")]
    assert len(ckpt) == 1 and os.path.isfile(ckpt[0])
    assert ckpt[0].startswith(str(tmp_path))
    value, inside, ev, clouds = torch_quality.parse_soak_output(out, rc)
    assert (value, inside, ev, clouds) == _jax_parse()(out, rc)
    assert inside == (want_rc == 0) and value == ev["accuracy"]
    assert clouds > 0


def _jax_test_draws(root, extra):
    """The test ids and first-epoch points of ``soak_retrieval.py``'s
    loader (``build_dataset(cfg, "test")``, a fresh ``BatchLoader``)."""
    from sonet_tpu.config import shrec16
    from sonet_tpu.data.pipeline import BatchLoader
    from sonet_tpu.train.trainer import build_dataset
    cfg = shrec16().replace(dataroot=root, **extra)
    ids, pcs = [], []
    for b in BatchLoader(build_dataset(cfg, "test"), cfg.batch_size,
                         shuffle=False, drop_last=False, pad_last=True):
        ids.append(b["id"][:int(b["valid"])])
        pcs.append(b["pc"])
    return np.concatenate(ids), pcs


@pytest.mark.parametrize("band,want_rc", [
    (["--assert_band", "2,3"], 1), (["--assert_band", "0,1"], 0)])
def test_soak_retrieval_band_labels_and_draws(trees, tmp_path, band,
                                              want_rc):
    argv = ["--dataroot", trees["shrec"], "--epochs", "1", "--device",
            "cpu", "--out", str(tmp_path), "--per_class_block",
            str(SHREC_BLOCK)] + NARROW + band
    got = {}

    def keep(a):
        got["result"] = torch_soak_retrieval.main(a)

    rc, out = _run(keep, argv)
    assert rc == want_rc, out
    value, inside, ev, _ = torch_quality.parse_soak_output(out, rc)
    assert (value, inside, ev) == _jax_parse()(out, rc)[:3]
    assert inside == (want_rc == 0) and value == ev["mAP"]
    assert len(os.listdir(tmp_path / "rank")) == 6
    want_ids, want_pcs = _jax_test_draws(
        trees["shrec"], dict(batch_size=2, input_pc_num=128, feature_num=64))
    if want_rc == 0:
        _, ids, labels = got["result"]
        assert np.array_equal(ids, want_ids)
        assert np.array_equal(labels, want_ids // SHREC_BLOCK)
        assert sorted(set(labels.tolist())) == [0, 1, 2]
    else:
        # the port's loader draws the same points as the JAX tool's
        from sonet_torch.config import parse_args
        cfg = parse_args(["--dataroot", trees["shrec"]] + NARROW,
                         preset="shrec16")
        pcs = [b["pc"] for b in torch_soak_retrieval.split_loader(cfg, "cpu")]
        assert len(pcs) == len(want_pcs)
        assert all(np.array_equal(a, b) for a, b in zip(pcs, want_pcs))


# -- the chain and the transfer ------------------------------------------------

def test_quality_chain_writes_the_artifact(trees, tmp_path):
    # the 3-class tree under ModelNet40's list names, its nodes fitted:
    # the chain reuses it and its nodes, and soaks 30 epochs of 3 steps
    root = str(tmp_path / "mn40")
    shutil.copytree(trees["modelnet"], root)
    for what in ("shape_names", "train", "test"):
        os.rename(os.path.join(root, f"modelnet3_{what}.txt"),
                  os.path.join(root, f"modelnet40_{what}.txt"))
    art = str(tmp_path / "QUALITY_torch_modelnet40.json")
    run = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "torch_quality.py"),
         "--preset", "modelnet40", "--dataroot", root, "--device", "cpu",
         "--out", art] + NARROW,
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    out = run.stdout
    assert "quality: reusing dataset" in out, out + run.stderr
    assert "quality: SOM nodes already present" in out
    # 3 test shapes cannot score inside the band: the verdict says so
    assert run.returncode == 1, out + run.stderr
    with open(art) as f:
        got = json.load(f)
    quality_keys = ["quality", "metric", "value", "band", "inside",
                    "hardness", "epochs", "seed", "dataset", "band_seeds",
                    "final_eval", "sustained_clouds_per_sec", "wall_s",
                    "soak_rc"]
    assert list(got) == quality_keys + ["device", "package"]
    with open(os.path.join(TOOLS, "soak_bands.json")) as f:
        band = json.load(f)["modelnet40"]
    assert got["band"] == [band["lo"], band["hi"]] and got["epochs"] == 30
    assert got["inside"] is False and got["soak_rc"] == 1
    assert got["value"] == got["final_eval"]["accuracy"]
    assert got["device"] == "cpu" and got["package"] == "sonet_torch"
    assert out.count("ms/step sustained") == 30
    # the soak's run directory lies beside the artifact
    run_dir = tmp_path / "QUALITY_torch_modelnet40_runs" / \
        "soak_modelnet40_device_s0"
    assert (run_dir / "config.json").is_file()


def test_transfer_demo_on_the_cpu(tmp_path):
    root = str(tmp_path / "snpart")
    with contextlib.redirect_stdout(io.StringIO()):
        torch_make_shapenet_scale.main(
            ["--out", root, "--train_per_cat", "2", "--test_per_cat", "1",
             "--points", "256", "--hardness", "0.7"])
        _prep_som(root, 48)
    got = {}

    def keep(a):
        got["evals"] = torch_transfer_demo.main(a)

    rc, out = _run(keep, ["--dataroot", root, "--ae_epochs", "1",
                          "--seg_epochs", "1", "--device", "cpu", "--out",
                          str(tmp_path / "runs"), "--batch_size", "4",
                          "--input_pc_num", "64", "--feature_num", "32"])
    assert rc == 0, out
    pre, scratch = got["evals"]
    line = [ln for ln in out.splitlines()
            if ln.startswith("transfer delta:")]
    assert line == [f"transfer delta: iou {pre['iou'] - scratch['iou']:+.4f}"
                    f", seg_acc "
                    f"{pre['seg_accuracy'] - scratch['seg_accuracy']:+.4f}"]
    assert os.listdir(tmp_path / "runs" / "ae_ckpt")


def test_rounding_probe_rounds_the_three_products():
    """``tools/torch_tpu_rounding_probe.py`` reaches the products it
    names, and only while it is installed: the pairwise distances that
    the top-k assignment and the nodes' kNN read, the encoder's one bmm
    (the cluster sum) and the gather of its means (the centers)."""
    import torch_tpu_rounding_probe as probe
    from sonet_torch.config import tiny_test
    from sonet_torch.models import build_model
    from sonet_torch.nn import encoder

    cfg = tiny_test()
    model = build_model(cfg, device="cpu").eval()
    rng = np.random.default_rng(0)
    pc, sn = (torch.from_numpy(rng.standard_normal(
        (2, cfg.input_pc_num, 3)).astype(np.float32)) for _ in range(2))
    node = torch.from_numpy(rng.standard_normal(
        (2, cfg.node_num, 3)).astype(np.float32))

    def forward():
        with torch.no_grad():
            logits, enc = model(pc, sn, node)
        return logits, enc.feature

    def sqdist_of(fn):
        return fn.__globals__["pairwise_sqdist"]

    plain = forward()
    with probe.installed() as rounding:
        assert sqdist_of(encoder.assign_topk) is probe.rounded_sqdist
        assert sqdist_of(encoder.knn) is probe.rounded_sqdist
        rounded = forward()
        assert rounding.calls == {"bmm": 1, "centers": 1}
    assert sqdist_of(encoder.assign_topk) is not probe.rounded_sqdist
    assert encoder.torch is torch
    again = forward()
    for p, r, a in zip(plain, rounded, again):
        assert torch.equal(p, a)
        # bfloat16 operands move the result by a rounding's worth: here
        # 7e-4 of the largest entry, held to 1e-2 of it
        assert not torch.equal(p, r)
        assert (p - r).abs().max() <= 1e-2 * p.abs().max()


def test_rounding_probe_rounds_the_sorted_pipelines_cluster_sum():
    """On the sorted pipeline, the card's, the cluster sum is the encoder's
    ``segment_sums``: the probe rounds its points and the centers' gather
    after it as it rounds the scatter path's ``bmm``, and puts the
    encoder's own ``segment_sums`` back when it ends."""
    import torch_tpu_rounding_probe as probe
    from sonet_torch.config import tiny_test
    from sonet_torch.models import build_model
    from sonet_torch.nn import encoder

    cfg = tiny_test().replace(pooling="sorted_window")
    model = build_model(cfg, device="cpu").eval()
    rng = np.random.default_rng(1)
    pc, sn = (torch.from_numpy(rng.standard_normal(
        (2, cfg.input_pc_num, 3)).astype(np.float32)) for _ in range(2))
    node = torch.from_numpy(rng.standard_normal(
        (2, cfg.node_num, 3)).astype(np.float32))

    def forward():
        with torch.no_grad():
            return model(pc, sn, node)[1].som_node

    plain, real = forward(), encoder.segment_sums
    with probe.installed(("cluster",)) as rounding:
        rounded = forward()
        assert rounding.calls == {"bmm": 1, "centers": 1}
    assert encoder.segment_sums is real and encoder.torch is torch
    assert not torch.equal(plain, rounded)
    assert (plain - rounded).abs().max() <= 1e-2 * plain.abs().max()


def _bf16_model():
    from sonet_torch.config import tiny_test
    from sonet_torch.models import build_model
    cfg = tiny_test().replace(compute_dtype="bfloat16")
    rng = np.random.default_rng(1)
    pc, sn = (torch.from_numpy(rng.standard_normal(
        (2, cfg.input_pc_num, 3)).astype(np.float32)) for _ in range(2))
    node = torch.from_numpy(rng.standard_normal(
        (2, cfg.node_num, 3)).astype(np.float32))
    return build_model(cfg, device="cpu"), (pc, sn, node)


def test_rounding_probe_rounds_the_float32_head():
    """``head`` rounds every dense layer without a compute dtype: in a
    bfloat16 classifier only ``fc3``, once a forward, by a rounding's
    worth."""
    import torch_tpu_rounding_probe as probe
    model, args = _bf16_model()
    model.eval()
    with torch.no_grad():
        plain = model(*args)[0]
        with probe.installed(["head"]) as rounding:
            rounded = model(*args)[0]
        assert rounding.calls == {"head": 1}
        again = model(*args)[0]
    assert torch.equal(plain, again) and not torch.equal(plain, rounded)
    assert (plain - rounded).abs().max() <= 1e-2 * plain.abs().max()


def _quantization_error(root, rows=8):
    """The mean over the tree's shapes of each point's squared distance to
    its nearest node."""
    from sonet_torch.som import query
    errs = []
    for d, _, fs in os.walk(os.path.join(root, f"{rows}x{rows}_som_nodes")):
        for f in fs:
            rel = os.path.relpath(os.path.join(d, f),
                                  os.path.join(root, f"{rows}x{rows}_som_nodes"))
            pc = torch.from_numpy(np.load(os.path.join(root, rel))[None, :, :3])
            node = torch.from_numpy(np.load(os.path.join(d, f))[None])
            idx, _ = query(node, pc)
            errs.append(float((pc - node[0][idx[0].long()]).square().sum(-1)
                              .mean()))
    return float(np.mean(errs))


def test_rounding_probe_refits_the_som_and_soaks(trees, tmp_path):
    """``--refit_som`` fits the tree's nodes again with the ``som``
    rounding (the distances' product in bfloat16): other nodes than the
    float32 refit's from the same draws, of about the same quantization
    error; then the soak runs with every rounding in place."""
    import torch_tpu_rounding_probe as probe
    root = str(tmp_path / "mn")
    shutil.copytree(trees["modelnet"], root)
    nodes = os.path.join(root, "8x8_som_nodes")
    first = sorted(os.path.join(d, f) for d, _, fs in os.walk(nodes)
                   for f in fs)[0]
    with contextlib.redirect_stdout(io.StringIO()):
        probe.refit_som(root, "cpu", som_sample=256)
    exact, exact_err = np.load(first), _quantization_error(root)
    rc, out = _run(probe.main, [
        "--round", "all", "--refit_som", "--som_sample", "256",
        "--dataroot", root, "--epochs",
        "1", "--device", "cpu", "--input_pipeline", "device", "--out",
        str(tmp_path / "runs"), "--classes", "3", "--assert_band", "0,1"]
        + NARROW)
    assert rc == 0, out
    assert "with the som rounding" in out
    calls = eval(out.split("rounding probe calls: ")[1].splitlines()[0])
    assert set(calls) == {"bmm", "centers", "som", "head"}
    assert all(n > 0 for n in calls.values()), calls
    rounded, rounded_err = np.load(first), _quantization_error(root)
    assert rounded.shape == exact.shape and not np.array_equal(rounded, exact)
    print(f"quantization error: float32 {exact_err:.6f}, rounded "
          f"{rounded_err:.6f}; nodes apart by up to "
          f"{np.abs(rounded - exact).max():.4f}")
    assert abs(rounded_err - exact_err) <= 0.1 * exact_err


class _Bf16ExactBmm:
    """``torch`` as ``ops/cuda/segment_max_grad.py`` sees it, noting
    whether each operand of its ``bmm`` (``route_max_grad``'s one-hot
    products) is exact in bfloat16."""

    def __init__(self):
        self.exact = []

    def bmm(self, a, b):
        self.exact += [torch.equal(x, x.bfloat16().to(x.dtype))
                       for x in (a, b)]
        return torch.bmm(a, b)

    def __getattr__(self, name):
        return getattr(torch, name)


def test_rounding_probe_knnmax_starves_the_encoder(monkeypatch):
    """``knnmax`` keeps the forward's bits and, in bfloat16, routes the
    max over the neighbours to the float32 values: hardly any equals a
    bfloat16 maximum, so the kNN layer and the first PointNet, which learn
    only through that max, get almost no gradient; the head's gradients
    stay.  The plain backward's one-hot products of pooling's gradient
    take operands exact in bfloat16, which is why the probe leaves them
    unrounded."""
    import torch_tpu_rounding_probe as probe
    from sonet_torch.ops.cuda import segment_max_grad
    model, args = _bf16_model()
    model.train()
    route = _Bf16ExactBmm()
    monkeypatch.setattr(segment_max_grad, "torch", route)

    def run():
        model.zero_grad()
        logits = model(*args, generator=torch.Generator().manual_seed(0))[0]
        logits.float().square().sum().backward()
        return logits.detach(), {n: p.grad.clone() for n, p in
                                 model.named_parameters()
                                 if p.grad is not None}

    plain_out, plain = run()
    assert len(route.exact) == 6 and all(route.exact)   # 3 products
    with probe.installed(["knnmax"]) as rounding:
        out, starved = run()
    assert rounding.calls == {"knnmax": 1}
    assert torch.equal(out, plain_out)
    for name, g in plain.items():
        ratio = float(starved[name].norm() / g.norm().clamp_min(1e-30))
        if name.startswith(("encoder.knnlayer.", "encoder.first_pointnet.")):
            assert ratio < 0.05, (name, ratio)
        elif name.startswith("classifier."):
            assert ratio > 0.5, (name, ratio)
