"""``sonet_torch.compat`` (reference ``.pth`` import and export) against
``sonet_tpu.compat``, on the CPU.

The reference's ``.pth`` files are made from seeded ``sonet_tpu`` weights
(its initial variables with random BatchNorm statistics) by
``sonet_tpu.compat.*_state_dict`` and ``torch.save``, for every head:
the classifier (with and without the kNN layer), the segmenter and the
decoder.  The original SO-Net is not needed.

Held:
* the port's import equals (``==``) ``convert.py``'s carry of the same
  JAX weights, and a run written by ``import_run`` restores to them;
* the port's export of a port run and ``sonet_tpu.compat``'s export of
  the ``sonet_tpu`` run written from the same files: the same files, the
  same keys, every tensor bit-equal;
* an imported run served by ``ServingEngine.from_run`` within 1e-5 of
  ``sonet_tpu``'s imported run served by its own engine (float32, summed
  in another order);
* a config that does not fit the files fails with the per-leaf report
  before anything is written; the payload's step is the directory's;
  ``sonet-torch import-ckpt`` through ``cli.main``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sonet_tpu import compat as jcompat
from sonet_tpu import config as jcfg
from sonet_tpu import models as jmodels
from sonet_tpu.serving import ServingEngine as JEngine
from sonet_torch import cli as tcli
from sonet_torch import compat as tcompat
from sonet_torch import config as tcfg
from sonet_torch.convert import flatten, load_jax_variables
from sonet_torch.models import build_model
from sonet_torch.serving import ServingEngine

torch.set_num_threads(2)

TOL = 1e-5
HEADS = {"classify": "classifier", "retrieve": "classifier",
         "segment": "segmenter", "autoencode": "decoder"}
OVER = {"classify": dict(),
        "retrieve": dict(task="retrieve", som_k=0, classes=5),
        "segment": dict(task="segment", classes=50),
        "autoencode": dict(task="autoencode")}


def _configs(task):
    over = dict(OVER[task], compute_dtype="float32", dropout=0.0, seed=4)
    return jcfg.tiny_test().replace(**over), tcfg.tiny_test().replace(**over)


def _example(cfg):
    rs = np.random.RandomState(2)
    B, N, M = cfg.batch_size, cfg.input_pc_num, cfg.node_num
    ex = [rs.randn(B, N, 3).astype(np.float32),
          rs.randn(B, N, 3).astype(np.float32),
          rs.randn(B, M, 3).astype(np.float32)]
    if cfg.task == "segment":
        ex.append(np.zeros(B, np.int32))
    return ex


def _jax_variables(jc):
    """Seeded sonet_tpu variables, BatchNorm statistics off 0 and 1, as
    nested numpy trees."""
    jm = jmodels.build_model(jc)
    v = jax.jit(lambda r: jm.init(
        {"params": r, "dropout": jax.random.fold_in(r, 1)}, *_example(jc),
        train=False))(jax.random.PRNGKey(1))
    v = jax.tree_util.tree_map(np.asarray, v)
    rs = np.random.RandomState(7)

    def perturb(path, a):
        leaf = path[-1].key
        if leaf == "mean":
            return (0.1 * rs.randn(*a.shape)).astype(np.float32)
        if leaf == "var":
            return rs.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a
    stats = jax.tree_util.tree_map_with_path(perturb, v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def _write_pth(variables, head, out_dir, step=9):
    """The reference's files, written as its save_network writes them."""
    files = {}
    for label, fn in (("encoder", jcompat.encoder_state_dict),
                      (head, getattr(jcompat, f"{head}_state_dict"))):
        arrays = fn(variables["params"][label],
                    variables["batch_stats"].get(label, {}))
        path = os.path.join(out_dir, f"{step}_net_{label}.pth")
        torch.save({k: torch.from_numpy(np.array(a, copy=True))
                    for k, a in arrays.items()}, path)
        files[label] = path
    return files


@pytest.fixture(scope="module", params=list(HEADS))
def case(request, tmp_path_factory):
    task = request.param
    jc, tc = _configs(task)
    variables = _jax_variables(jc)
    base = tmp_path_factory.mktemp(task)
    files = _write_pth(variables, HEADS[task], str(base))
    return task, jc, tc, variables, files, base


def _carried(tc, variables):
    model = build_model(tc, device="cpu")
    load_jax_variables(model, variables)
    return model.state_dict()


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_import_equals_the_carry_of_the_same_weights(case):
    _, _, tc, variables, files, _ = case
    imported = tcompat.import_reference_checkpoint(tc, files)
    model = build_model(tc, device="cpu")
    load_jax_variables(model, imported)
    _assert_same_state(model.state_dict(), _carried(tc, variables))
    # the trees the converters give are the JAX package's, leaf for leaf
    want = flatten(_jax_trees(files))
    got = flatten(imported)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_trees(files):
    """sonet_tpu's converters on the same files (its model check left
    out: it needs a flax init)."""
    params, stats = {}, {}
    for label, path in files.items():
        p, s = jcompat._CONVERTERS[label](jcompat.load_state_dict(path))
        params[label] = p
        if s:
            stats[label] = s
    return {"params": params, "batch_stats": stats}


def test_import_run_restores_the_weights(case, tmp_path):
    _, _, tc, variables, files, _ = case
    ckpt = tcompat.import_run(tc, files, str(tmp_path / "run"), step=3,
                              device="cpu")
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    _assert_same_state(payload["model"], _carried(tc, variables))
    assert tcfg.load_config(str(tmp_path / "run" / "config.json")
                            ).to_dict() == tc.to_dict()


def test_export_is_bit_equal_to_sonet_tpu(case, tmp_path):
    task, jc, tc, _, files, _ = case
    trun, jrun = str(tmp_path / "port"), str(tmp_path / "jax")
    tcompat.import_run(tc, files, trun, step=7, device="cpu")
    jcompat.import_run(jc, files, jrun, step=7)
    got = tcompat.export_reference_checkpoint(trun, str(tmp_path / "t_out"))
    want = jcompat.export_reference_checkpoint(jrun, str(tmp_path / "j_out"))
    assert set(got) == set(want) == {"encoder", HEADS[task]}
    for label in want:
        assert os.path.basename(got[label]) == os.path.basename(want[label])
        g = torch.load(got[label], weights_only=True)
        w = torch.load(want[label], weights_only=True)
        assert list(g) == list(w), label
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
        # the keys of the files that were imported, counters included
        src = torch.load(files[label], weights_only=True)
        assert set(src) == set(g)


@pytest.mark.parametrize("task", ["classify", "segment"])
def test_imported_run_serves_as_sonet_tpus(task, tmp_path):
    jc, tc = _configs(task)
    files = _write_pth(_jax_variables(jc), HEADS[task], str(tmp_path))
    trun, jrun = str(tmp_path / "port"), str(tmp_path / "jax")
    tcompat.import_run(tc, files, trun, device="cpu")
    jcompat.import_run(jc, files, jrun)
    engine = ServingEngine.from_run(trun, device="cpu")
    jengine = JEngine.from_run(jrun)
    rs = np.random.RandomState(3)
    x = {i["name"]: rs.randn(3, *i["shape"][1:]).astype(i["dtype"])
         for i in jengine.manifest["inputs"]}
    if task == "segment":
        x["label"] = np.asarray([0, 3, 1], x["label"].dtype)
    got, want = engine.predict(x), jengine.predict(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_a_config_that_does_not_fit_fails_before_writing(case, tmp_path):
    task, _, tc, _, files, _ = case
    out = tmp_path / "never"
    wrong = (tc.replace(feature_num=32) if task == "autoencode"
             else tc.replace(classes=tc.classes + 3))
    with pytest.raises(ValueError, match="does not fit") as e:
        tcompat.import_run(wrong, files, str(out), device="cpu")
    assert "shape" in str(e.value)
    assert not out.exists()


def test_file_set_validation(case):
    _, _, tc, _, files, _ = case
    with pytest.raises(ValueError, match="missing"):
        tcompat.import_reference_checkpoint(tc, {"encoder": files["encoder"]})
    other = "decoder" if "decoder" not in files else "classifier"
    with pytest.raises(ValueError, match="unexpected"):
        tcompat.import_reference_checkpoint(
            tc, {**files, other: files["encoder"]})


def test_the_payload_step_is_the_directorys(tmp_path):
    jc, tc = _configs("classify")
    files = _write_pth(_jax_variables(jc), "classifier", str(tmp_path))
    ckpt = tcompat.import_run(tc, files, str(tmp_path / "stepped"),
                              step=300, device="cpu")
    assert ckpt.endswith("step_00000300.pt")
    assert torch.load(ckpt, weights_only=True)["step"] == 300
    from sonet_torch import train as ttrain
    state = ttrain.init_state(tc, device="cpu")
    assert ttrain.restore_checkpoint(ckpt, state).step == 300


def test_import_ckpt_command(tmp_path, capsys):
    jc, tc = _configs("classify")
    files = _write_pth(_jax_variables(jc), "classifier", str(tmp_path))
    out = str(tmp_path / "cli_run")
    rc = tcli.main(["import-ckpt", "--device", "cpu",
                    "--encoder", files["encoder"],
                    "--classifier", files["classifier"], "--out", out,
                    "--preset", "tiny_test", "--dropout", "0.0",
                    "--seed", "4", "--step", "12"])
    assert rc == 0
    assert '"task": "classify"' in capsys.readouterr().out
    payload = torch.load(os.path.join(out, "ckpt", "step_00000012.pt"),
                         weights_only=True)
    _assert_same_state(payload["model"], _carried(
        tc, tcompat.import_reference_checkpoint(tc, files)))
    # the command's default preset follows the head: a segmenter's files
    # against modelnet40's classifier would not fit
    with pytest.raises(ValueError, match="does not fit"):
        tcli.main(["import-ckpt", "--device", "cpu",
                   "--encoder", files["encoder"],
                   "--classifier", files["classifier"],
                   "--out", str(tmp_path / "no")])
    assert not (tmp_path / "no").exists()


def test_cuda_is_the_default(tmp_path, monkeypatch):
    jc, tc = _configs("classify")
    files = _write_pth(_jax_variables(jc), "classifier", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcompat.import_run(tc, files, str(tmp_path / "run"))
