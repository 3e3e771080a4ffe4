"""``tools/compare_packages.py`` on the CPU at a narrow width: both
packages' ``Trainer``s count the same steps an epoch on one tree and
each trains an epoch through the tool, and a run of the port
(``tools/torch_soak.py --save``) is scored alike by both packages'
``infer`` from the same weights."""

import contextlib
import io
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import compare_packages  # noqa: E402
import torch_make_modelnet_scale  # noqa: E402
import torch_soak  # noqa: E402

torch.set_num_threads(2)

NARROW = ["--batch_size", "2", "--input_pc_num", "128", "--feature_num",
          "64", "--classes", "3"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """3 classes of 3 train and 2 test shapes of 256 points, nodes fitted
    by the port's ``prep som`` on the CPU."""
    root = str(tmp_path_factory.mktemp("compare") / "mn")
    from sonet_torch.data import prep
    with contextlib.redirect_stdout(io.StringIO()):
        torch_make_modelnet_scale.main(
            ["--out", root, "--classes", "3", "--train_per_class", "3",
             "--test_per_class", "2", "--points", "256", "--hardness",
             "0.15"])
        prep.main(["som", "--root", root, "--rows", "8", "--batch", "15",
                   "--som_sample", "256", "--device", "cpu"])
    return root


@pytest.mark.parametrize("pkg", compare_packages.PACKAGES)
def test_train_counts_steps_and_trains_an_epoch(pkg, tree, tmp_path):
    with contextlib.redirect_stdout(io.StringIO()) as said:
        steps, rows = compare_packages.main(
            ["train", "--dataroot", tree, "--out", str(tmp_path),
             "--epochs", "1", "--run", pkg, "0"] + NARROW)
    # 9 train shapes in batches of 2, the last one dropped: 4 steps
    assert steps == 4
    assert f"{pkg} s0: 4 steps an epoch (len(train_loader) 4)" in \
        said.getvalue()
    (epoch, loss, mean, acc, test_loss), = rows
    assert epoch == 0 and loss > 0 and test_loss > 0
    assert acc in (0.0, 0.1667, 0.3333, 0.5, 0.6667, 0.8333, 1.0)
    # the port's device pipeline gives the epoch's mean accuracy (of 4
    # batches of 2); the JAX Trainer gives the last step's metrics only
    if pkg == "jax":
        assert mean is None
    else:
        assert round(mean * 8, 3) == round(mean * 8) and 0 <= mean <= 1
    with open(tmp_path / f"{pkg}_s0.json") as f:
        assert json.load(f) == {"steps_per_epoch": 4,
                                "rows": [list(rows[0])]}


def test_eval_scores_a_port_run_alike_in_both_packages(tree, tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        torch_soak.main(["--dataroot", tree, "--epochs", "1", "--device",
                         "cpu", "--input_pipeline", "device", "--save",
                         "--out", str(tmp_path / "soak")] + NARROW)
    run = str(tmp_path / "soak" / "soak_modelnet40_device_s0")
    with contextlib.redirect_stdout(io.StringIO()) as said:
        summaries, agree = compare_packages.main(
            ["eval", "--run", run, "--dataroot", tree, "--out",
             str(tmp_path / "cross"), "--input_pc_num", "96"])
    jax_sum, torch_sum = summaries["jax"], summaries["torch"]
    assert agree == {"items": 6, "same_pred": 6}
    assert jax_sum["items"] == torch_sum["items"] == 6
    assert jax_sum["accuracy"] == torch_sum["accuracy"]
    # one forward of the same weights: the bfloat16 layers' rounding
    assert jax_sum["loss"] == pytest.approx(torch_sum["loss"], rel=1e-2)
    assert said.getvalue().splitlines()[-1] == \
        f"agreement: {json.dumps(agree)}"
