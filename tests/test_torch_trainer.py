"""The port's ``Trainer``, command line and task drivers on the CPU, at
``tiny_test`` widths: the twins of the JAX package's
``tests/test_train_e2e.py::TestCheckpoint`` and
``tests/test_tasks.py::TestShrecTask``, ``parse_args`` against the JAX
package's, and one epoch of the port's ``Trainer`` against the JAX
package's ``Trainer``.

The epoch parity run has dropout and point dropout off (torch cannot
reproduce JAX's random streams), float32, the JAX run's initial weights
carried across by ``convert`` and its datasets' SOM nodes given to the
port's datasets; the clouds, the augmentation draws and the batch order
are the same on both sides by construction (``tests/test_torch_data.py``),
and the first step's losses are equal.  It runs at lr 1e-5, as
``tests/test_torch_train.py`` does and for its reason: Adam turns a
noise-level gradient whose sign differs between the two sides into a
step of +lr on one and -lr on the other, and at this size the loss is
non-smooth enough that such flips steer the run (at lr 1e-3 the second
step's losses differ by 0.2% and the test loss after 16 steps by 15%; at
1e-4 by 2%).  At 1e-5 the two test losses agree within 1e-3 relative
(5e-5 measured) and accuracy within one of the 16 test items.

The test loss alone does not show that the optimizer ran: at 1e-5 most of
its fall, 3.23 to 1.62, comes from the BatchNorm running statistics, and
a port that skipped every other Adam update read 8.1e-4 of it.  So each
weight matrix's change over the epoch is held to the JAX run's as well,
by the relative norm of their difference over all of them: 2.7% measured
against a 4% limit.  Three faults planted in the port's Trainer each read
above it (``test_one_epoch_parity_catches_a_faulty_trainer``; ``pytest
-s`` prints the readings): 74% with every other Adam update skipped, 114%
with the batches in reverse order, 6.2% with the last step dropped; the
test loss alone reads 8.1e-4, 6.9e-3 and 3.4e-3 of the JAX run's.
Biases are left out: here their gradients are at noise level, so Adam's
sign flips move them by +-lr on either side.
"""

import copy
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from sonet_tpu import config as jcfg
from sonet_tpu.train import trainer as jtrainer
from sonet_torch import cli
from sonet_torch import config as tcfg
from sonet_torch import train as ttrain
from sonet_torch.config import load_config
from sonet_torch.convert import flatten, load_jax_variables
from sonet_torch.data.synthetic import SyntheticDataset
from sonet_torch.serving import ServingEngine
from sonet_torch.tasks import classify as tclassify
from sonet_torch.tasks import retrieve as tretrieve
from sonet_torch.tasks import partseg as tpartseg
from sonet_torch.train.trainer import Trainer, build_dataset
from sonet_torch.utils import visualize

torch.set_num_threads(2)

LOSS_RTOL = 1e-3
WEIGHT_CHANGE_RTOL = 0.04
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(tmp_path, name, **over):
    return tcfg.tiny_test().replace(checkpoints_dir=str(tmp_path), name=name,
                                    **over)


def _ckpts(trainer):
    return sorted(os.listdir(os.path.join(trainer.out_dir, "ckpt")))


def _state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def periodic_run(tmp_path_factory):
    """Two epochs of 16 steps with an ungated save every 20 steps and a
    metric gate no run can pass."""
    cfg = _cfg(tmp_path_factory.mktemp("runs"), "periodic",
               checkpoint_every=20)
    t = Trainer(cfg, quiet=True, resume=False, device="cpu")
    metrics = t.fit(epochs=2, save_threshold=2.0)
    return t, metrics


class TestRun:
    def test_trains_evaluates_and_writes_the_run(self, periodic_run):
        t, metrics = periodic_run
        assert t.steps_per_epoch == 16 and t.state.step == 32
        assert set(metrics) == {"loss", "accuracy"}
        assert np.isfinite(metrics["loss"]) and 0 <= metrics["accuracy"] <= 1
        assert (load_config(os.path.join(t.out_dir, "config.json")).to_dict()
                == t.cfg.to_dict())
        with open(os.path.join(t.out_dir, "train_metrics.jsonl")) as f:
            text = f.read()
        assert "train_sec_per_step" in text and "test_accuracy" in text

    def test_checkpoint_every_saves_periodically(self, periodic_run):
        t, _ = periodic_run
        # step 16 is in the first bucket of 20; step 32 crosses into the
        # second: the only save, since the metric gate is never passed
        assert _ckpts(t) == ["step_00000032.pt"]
        assert t.best_metric is not None

    def test_from_run_serves_the_run(self, periodic_run):
        t, _ = periodic_run
        engine = ServingEngine.from_run(t.out_dir, device="cpu")
        assert engine.manifest["checkpoint"].endswith("step_00000032.pt")
        batch = next(iter(t.test_loader))
        want = t.eval_step(t.state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()
                                     if k != "valid"})["score"]
        got = engine.predict({n: batch[n] for n in engine.input_names})
        np.testing.assert_allclose(got, want.numpy(), **SERVE_TOL)

    def test_pretrain_restores_only_the_encoder(self, periodic_run, tmp_path):
        src, _ = periodic_run
        path = os.path.join(src.out_dir, "ckpt", "step_00000032.pt")
        cfg = _cfg(tmp_path, "pre", pretrain=path, pretrain_lr_ratio=0.5)
        t = Trainer(cfg, quiet=True, resume=False, device="cpu")
        fresh = ttrain.init_state(cfg, device="cpu", seed=cfg.seed)
        saved = torch.load(path, weights_only=True)["model"]
        got = t.model.state_dict()
        enc = [k for k in got if k.startswith("encoder.")]
        head = [k for k in got if not k.startswith("encoder.")]
        assert enc and head
        assert all(torch.equal(got[k], saved[k]) for k in enc)
        init = fresh.model.state_dict()
        assert all(torch.equal(got[k], init[k]) for k in head)
        assert any(not torch.equal(got[k], saved[k]) for k in head)
        lrs = {g["name"]: t.state.schedules[g["name"]](0)
               for g in t.state.optimizer.param_groups}
        assert lrs == {"encoder": 0.5 * cfg.lr, "head": cfg.lr}


class TestStop:
    def test_graceful_stop_checkpoints_and_resumes(self, tmp_path):
        cfg = _cfg(tmp_path, "gstop", epochs=6)
        t = Trainer(cfg, quiet=True, resume=False, device="cpu")
        t.request_stop()
        t.fit(save_threshold=2.0)       # impossible gate: only the stop saves
        assert t.state.step == 1        # stops after the step it was in
        assert _ckpts(t) == ["step_00000001.pt"]
        assert not t._stop_requested
        t2 = Trainer(cfg, quiet=True, device="cpu")    # resume=True
        assert t2.state.step == 1
        assert _state_equal(t2.model, t.model)
        opt, opt2 = (x.state.optimizer.state_dict() for x in (t, t2))
        assert opt2["param_groups"] == opt["param_groups"]

    def test_sigterm_stops_with_a_checkpoint(self, tmp_path):
        cfg = _cfg(tmp_path, "sigterm", epochs=50)
        t = Trainer(cfg, quiet=True, resume=False, device="cpu")
        def term():
            # only into fit's handler: the default action ends the process
            if signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL:
                os.kill(os.getpid(), signal.SIGTERM)

        timer = threading.Timer(0.3, term)
        timer.start()
        try:
            t.fit(save_threshold=2.0)
        finally:
            timer.cancel()
        assert 0 < t.state.step < 50 * t.steps_per_epoch
        assert _ckpts(t) == [f"step_{t.state.step:08d}.pt"]
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
        assert not t._stop_requested

    def test_training_is_seed_deterministic(self, tmp_path):
        outs = [Trainer(_cfg(tmp_path / tag, "det"), quiet=True,
                        resume=False, device="cpu").fit(epochs=1)
                for tag in ("a", "b")]
        assert outs[0] == outs[1]


def test_segment_eval_draws_its_visuals(tmp_path):
    cfg = _cfg(tmp_path, "seg", task="segment", classes=50)
    t = Trainer(cfg, quiet=True, resume=False, device="cpu")
    metrics = t.evaluate(visualize=True)
    assert set(metrics) == {"loss", "seg_accuracy", "iou"}
    assert 0.0 <= metrics["iou"] <= 1.0
    assert sorted(os.listdir(os.path.join(t.out_dir, "visuals"))) == [
        "index.html", "step0_gt.png", "step0_predicted.png"]


def test_autoencode_run_draws_its_visuals(tmp_path):
    cfg = _cfg(tmp_path, "ae", task="autoencode", output_conv_pc_num=0)
    t = Trainer(cfg, quiet=True, resume=False, device="cpu")
    metrics = t.fit(epochs=1, visualize_every=1)
    assert {"loss", "chamfer_fwd", "chamfer_bwd"} <= set(metrics)
    assert t.best_metric == metrics["loss"]      # lower is better: saved
    assert _ckpts(t) == ["step_00000016.pt"]
    assert sorted(os.listdir(os.path.join(t.out_dir, "visuals"))) == [
        "index.html", "step16_input.png", "step16_recon.png"]


def test_fit_without_matplotlib_raises_before_training(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(visualize, "available", lambda: False)
    t = Trainer(_cfg(tmp_path, "nompl"), quiet=True, resume=False,
                device="cpu")
    with pytest.raises(ImportError, match="matplotlib"):
        t.fit(epochs=1, visualize_every=5)
    assert t.state.step == 0


@pytest.mark.parametrize("matplotlib,every", [(True, 5), (False, 0)])
def test_partseg_driver_draws_only_with_matplotlib(monkeypatch, matplotlib,
                                                   every):
    seen = {}

    class Fake:
        best_metric = None

        def __init__(self, cfg, device):
            seen["device"] = device

        def fit(self, save_threshold, visualize_every):
            seen["every"] = visualize_every
            return {}

    monkeypatch.setattr(visualize, "available", lambda: matplotlib)
    monkeypatch.setattr(tpartseg, "Trainer", Fake)
    tpartseg.main(["--device", "cpu", "--preset", "tiny_test"])
    assert seen == {"device": "cpu", "every": every}


def test_step_timer_skips_warmup(monkeypatch):
    from sonet_torch.utils import logging as tlog
    clock = iter([0.0, 1.0, 1.0, 3.0, 3.0, 7.0])
    monkeypatch.setattr(tlog.time, "perf_counter", lambda: next(clock))
    timer = tlog.StepTimer(warmup=1, device="cpu")
    for _ in range(3):
        with timer:
            pass
    assert timer.count == 3 and timer.mean == 3.0      # (2 + 4) / 2


# ---------------------------------------------------------------------------
# SHREC16: the val split and retrieval over the test split
# ---------------------------------------------------------------------------

def _fake_shrec_root(tmp_path, cfg, n_train=8, n_val=4, n_test=5):
    rows = cfg.rows
    rng = np.random.default_rng(1)
    root = tmp_path / "shrec"
    cats = [f"cat{i}" for i in range(cfg.classes)]
    root.mkdir()
    (root / "category.txt").write_text("\n".join(cats) + "\n")
    idx = 0
    for mode, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        lines = []
        os.makedirs(root / f"{rows}x{rows}" / mode, exist_ok=True)
        for i in range(n):
            name = f"{idx + 37:06d}"
            idx += 1
            np.savez(root / f"{rows}x{rows}" / mode / f"model_{name}.npz",
                     pc=rng.standard_normal((60, 3)).astype(np.float32),
                     sn=rng.standard_normal((60, 3)).astype(np.float32),
                     som_node=rng.standard_normal(
                         (cfg.node_num, 3)).astype(np.float32))
            lines.append(f"{name},{cats[i % len(cats)]}" if mode != "test"
                         else name)
        (root / f"{mode}.txt").write_text("\n".join(lines) + "\n")
    return str(root)


@pytest.mark.parametrize("matplotlib", [True, False])
def test_shrec_val_split_and_retrieval(tmp_path, monkeypatch, capsys,
                                       matplotlib):
    flags = dict(classes=3, batch_size=4, input_pc_num=32, node_num=9, k=2,
                 som_k=0, feature_num=32, dropout=0.0)
    cfg = tcfg.shrec16().replace(checkpoints_dir=str(tmp_path / "ck"),
                                 name="shrec_t", **flags)
    root = _fake_shrec_root(tmp_path, cfg)
    cfg = cfg.replace(dataroot=root)
    t = Trainer(cfg, quiet=True, resume=False, device="cpu")
    assert t.test_set.mode == "val" and len(t.test_set) == 4
    metrics = t.fit(epochs=1)
    assert np.isfinite(metrics["loss"])
    ckpt = ttrain.latest_checkpoint(os.path.join(t.out_dir, "ckpt"))

    out = tmp_path / "rank"
    argv = ["--device", "cpu", "--output_dir", str(out), "--checkpoint",
            ckpt, "--dataroot", root]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    monkeypatch.setattr(visualize, "available", lambda: matplotlib)
    got = tretrieve.main(argv)
    assert set(got) == {"mAP", "P@1", "P@5", "P@10"}
    assert all(0.0 <= v <= 1.0 for v in got.values())
    files = sorted(f for f in os.listdir(out) if f != "gallery")
    # one file a test shape, named by the shape's id in the split
    assert files == [f"{i:06d}" for i in range(37 + 12, 37 + 17)]
    # without matplotlib the gallery is left out, with a line that says so
    assert os.path.exists(out / "gallery" / "index.html") == matplotlib
    assert ("gallery left out" in capsys.readouterr().out) != matplotlib
    test_ids = {int(f) for f in files}
    for f in files:
        rows = (out / f).read_text().split("\n")
        assert int(rows[0].split()[0]) == int(f)        # itself first
        assert {int(r.split()[0]) for r in rows if r} <= test_ids


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--lr", "0.01", "--rot_horizontal", "true", "--pretrain", "None"],
    ["--mesh_shape", "1,1", "--normalization", "none", "--seed", "3"],
    ["--bn_momentum_decay_step", "7", "--compute_dtype", "float32",
     "--dataset", "synthetic", "--surface_normal", "no"],
])
@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_parse_args_matches_jax(preset, argv):
    argv = ["--preset", preset] + argv
    assert (tcfg.parse_args(argv).to_dict()
            == jcfg.parse_args(argv).to_dict())


def test_parse_mesh_shape():
    assert tcfg.parse_mesh_shape("4x2") == (4, 2)
    assert tcfg.parse_mesh_shape("8") == (8, 1)
    for bad in (",", "x", "0,1", "1,2,3", "a"):
        with pytest.raises(ValueError):
            tcfg.parse_mesh_shape(bad)


def test_cli_routes_each_command(monkeypatch, capsys):
    import importlib
    seen = []
    for cmd, (path, _) in cli._COMMANDS.items():
        mod = importlib.import_module(path)
        monkeypatch.setattr(mod, "main",
                            lambda argv, p=path: seen.append((p, argv)))
    cmds = ("classify", "partseg", "segment", "autoencode", "retrieve",
            "reproduce", "infer", "serve", "prep")
    for cmd in cmds:
        assert cli.main([cmd, "--device", "cpu"]) == 0
    assert [p.rsplit(".", 1)[1] for p, _ in seen] == [
        "classify", "partseg", "partseg", "autoencode", "retrieve",
        "reproduce", "infer", "serve", "prep"]
    assert seen[-1][0] == "sonet_torch.data.prep"
    assert all(argv == ["--device", "cpu"] for _, argv in seen)
    assert cli.main(["bogus"]) == 2
    assert cli.main([]) == 0 and "retrieve" in capsys.readouterr().out


def test_cli_help_imports_no_torch():
    import subprocess
    import sys
    code = ("import sys, sonet_torch.cli as c; c.main(['--help']); "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60,
                       cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# what the port refuses, and the cuda default
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over,item", [
    # a mesh of several devices in a world of one
    (dict(mesh_shape=(2, 1)), "one process per device.*--distributed"),
    # 'auto' outside a launcher: torchrun's environment is missing
    (dict(distributed="auto"), "torchrun's environment.*not set"),
])
def test_unported_options_raise(tmp_path, over, item, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    cfg = _cfg(tmp_path, "no", **over)
    with pytest.raises(ValueError, match=item):
        Trainer(cfg, quiet=True, device="cpu")


@pytest.mark.parametrize("command,pipeline", [
    ("classify", "device"), ("classify", "native"),
    ("partseg", "device"), ("autoencode", "device"),
])
def test_commands_take_every_input_pipeline(tmp_path, command, pipeline):
    """The task commands train with the device and native pipelines (the
    synthetic dataset has no native loader: it warns and reads with the
    Python one), and an unknown pipeline is refused."""
    from sonet_torch.tasks import autoencode as tautoencode
    mains = {"classify": tclassify.main, "partseg": tpartseg.main,
             "autoencode": tautoencode.main}
    argv = ["--device", "cpu", "--preset", "tiny_test", "--epochs", "1",
            "--checkpoints_dir", str(tmp_path), "--name", "run",
            "--input_pipeline", pipeline]
    if command != "classify":
        argv += ["--feature_num", "64"]
    if pipeline == "native":
        with pytest.warns(UserWarning, match="falls back"):
            final = mains[command](argv)
    else:
        final = mains[command](argv)
    assert np.isfinite(final["loss"])
    assert load_config(str(tmp_path / "run" / "config.json")
                       ).input_pipeline == pipeline
    with pytest.raises(ValueError, match="input_pipeline"):
        Trainer(_cfg(tmp_path, "bad", input_pipeline="disk"), quiet=True,
                device="cpu")


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tmp_path, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, quiet=True)
    with pytest.raises(RuntimeError, match="cuda"):
        SyntheticDataset(cfg, size=4)
    with pytest.raises(RuntimeError, match="cuda"):
        build_dataset(cfg, "train")
    with pytest.raises(RuntimeError, match="cuda"):
        tclassify.main(["--preset", "tiny_test", "--checkpoints_dir",
                        str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        tretrieve.main(["--preset", "tiny_test", "--output_dir",
                        str(tmp_path / "r")])


# ---------------------------------------------------------------------------
# one epoch against the JAX package's Trainer
# ---------------------------------------------------------------------------

PARITY = dict(dropout=0.0, compute_dtype="float32", lr=1e-5)


@pytest.fixture(scope="module")
def jax_epoch(tmp_path_factory):
    """One epoch of the JAX package's Trainer: its datasets' nodes, its
    variables before and after, its test metrics."""
    jc = jcfg.tiny_test().replace(
        checkpoints_dir=str(tmp_path_factory.mktemp("jax")), name="par",
        **PARITY)
    j = jtrainer.Trainer(jc, quiet=True, resume=False)

    def variables():
        return flatten({"params": j.state.params,
                        "batch_stats": j.state.batch_stats})

    nodes = {n: getattr(j, n).som_node.copy()
             for n in ("train_set", "test_set")}
    before = variables()
    metrics = j.fit(epochs=1, save_threshold=2.0)
    assert int(j.state.step) == 16 and jax.default_backend() == "cpu"
    return nodes, before, variables(), metrics


def _faulty(t, fault):
    """Plant ``fault`` in the port's Trainer ``t``."""
    if fault == "skip_every_other_update":
        step, calls = t.state.optimizer.step, [0]

        def every_other(*a, **k):
            calls[0] += 1
            return step(*a, **k) if calls[0] % 2 else None
        t.state.optimizer.step = every_other
        return
    batches = t._device_batches

    def reordered(loader):
        items = list(batches(loader))
        if loader is t.train_loader:
            items = {"reverse_the_batches": items[::-1],
                     "drop_the_last_step": items[:-1]}[fault]
        yield from items
    t._device_batches = reordered


def _port_epoch(tmp_path, jax_epoch, fault=None):
    """One epoch of the port's Trainer from the JAX run's start: (test
    metrics, the relative difference of the weight matrices' change over
    the epoch from the JAX run's)."""
    nodes, before_jax, after_jax, _ = jax_epoch
    t = Trainer(_cfg(tmp_path, "par", **PARITY), quiet=True, resume=False,
                device="cpu")
    for name, node in nodes.items():
        getattr(t, name).som_node = node.copy()
    load_jax_variables(t.model, before_jax)
    before = {k: v.detach().clone() for k, v in t.model.named_parameters()}
    if fault:
        _faulty(t, fault)
    got = t.fit(epochs=1, save_threshold=2.0)
    jax_after = copy.deepcopy(t.model)
    load_jax_variables(jax_after, after_jax)
    ref = dict(jax_after.named_parameters())
    apart, moved = 0.0, 0.0
    for k, w in t.model.named_parameters():
        if w.dim() > 1:                 # the weight matrices
            ours = w.detach() - before[k]
            theirs = ref[k].detach() - before[k]
            apart += float((ours - theirs).square().sum())
            moved += float(theirs.square().sum())
    assert moved > 0
    return t, got, (apart / moved) ** 0.5


def test_one_epoch_matches_jax_trainer(tmp_path, jax_epoch):
    want = jax_epoch[3]
    t, got, weights = _port_epoch(tmp_path, jax_epoch)
    print(f"test loss {got['loss']} vs {want['loss']}, weight change apart "
          f"by {weights:.4f}")
    assert t.state.step == 16
    assert set(got) == set(want) == {"loss", "accuracy"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert want["loss"] < 2.0           # it trained (3.23 before the epoch)
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / 16 + 1e-9
    assert weights < WEIGHT_CHANGE_RTOL


@pytest.mark.parametrize("fault", ["skip_every_other_update",
                                   "reverse_the_batches",
                                   "drop_the_last_step"])
def test_one_epoch_parity_catches_a_faulty_trainer(tmp_path, jax_epoch,
                                                   fault):
    want = jax_epoch[3]
    _, got, weights = _port_epoch(tmp_path, jax_epoch, fault)
    loss = abs(got["loss"] - want["loss"]) / want["loss"]
    print(f"{fault}: test loss apart by {loss:.3e}, weight change apart by "
          f"{weights:.4f}")
    assert weights > WEIGHT_CHANGE_RTOL
