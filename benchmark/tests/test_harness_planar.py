"""The cell ``mnist.train-device`` on the CPU at a tiny size: its FLOP count
by hand, its 2-D inputs, the 2-D reference against the program, whole
runs (sound; with the timed path broken underneath: a state left
unchanged, the loss over half of the batch), the control and the half
batch judged with the cell's limits, and the reading of the program's
grouping range from a profiled eager step."""

import dataclasses
import time

import pytest
import torch

from benchmark import compare, counts_planar, data, data_planar, harness
from benchmark.drivers.train_planar import comparison
from benchmark.reference import planar as rp
from benchmark.reference.precision import Precision

CELL = "mnist.train-device"
TINY = {"config": {"input_pc_num": 64, "node_num": 9, "som_k": 4,
                   "feature_num": 64, "compute_dtype": "float32"},
        "split": {"items": 48, "points": 64, "nodes": 9},
        "traffic": {"part_rows": 4, "settle_seconds": [0, 0]}}


def run(overrides=TINY, seconds=0.5, trace=False, seed=2**33 + 11):
    ctx = harness.make_context(harness.load_manifest(), CELL, seed, seconds,
                               trace, "cpu", time.perf_counter(),
                               overrides=overrides)
    return harness.run_cell(ctx)


def tiny_counts():
    return {"task": "classify", "batch_size": 2, "input_pc_num": 4,
            "node_num": 4, "k": 2, "som_k": 2, "feature_num": 8,
            "classes": 3, "surface_normal": False,
            "compute_dtype": "bfloat16"}


def test_counts_by_hand():
    # B=2, N=4, k=2 (kN=8), M=4, K=2, F=8, 3 classes, D=2
    # first PointNet, 16 rows: 2 (2*64 + 64*128 + 128*256 + 320*384)
    first = 16 * 2 * (128 + 8192 + 32768 + 122880)
    # kNN layer, B M K = 16 rows: 2 (386*512 + 512*512)
    knn = 16 * 2 * (386 * 512 + 512 * 512)
    # final PointNet, B M = 8 rows: 2 (514*768 + 768*8)
    final = 8 * 2 * (514 * 768 + 768 * 8)
    # head, B = 2 rows: 2 (8*512 + 512*256 + 256*3)
    head = 2 * 2 * (8 * 512 + 512 * 256 + 256 * 3)
    # distances 2 B N 2 M, cluster sums 2 B M kN 2, node distances 2 B M 2 M
    geo = 2 * 2 * 4 * 2 * 4 + 2 * 2 * 4 * 8 * 2 + 2 * 2 * 4 * 2 * 4
    f = counts_planar.forward_flops(tiny_counts(), 2)
    assert f == {"weights": first + knn + final + head, "geometry": geo}
    assert counts_planar.train_step_flops(tiny_counts()) == \
        3 * (first + knn + final + head) + geo
    with pytest.raises(NotImplementedError):
        counts_planar.forward_flops({**tiny_counts(), "surface_normal": True},
                                    2)


def test_full_width_counts():
    from sonet_torch.config import mnist
    d = dataclasses.asdict(mnist())
    # 327,936 FLOP a stacked point over 12,288 (4.03 G), 1.66 G in the kNN
    # layer, 0.47 G in the final PointNet, 0.01 G in the head
    w = counts_planar.forward_flops(d, 8)["weights"]
    assert w == pytest.approx(6.1679e9, rel=1e-4)
    assert counts_planar.train_step_flops(d) == pytest.approx(
        3 * w + counts_planar.forward_flops(d, 8)["geometry"])


def test_strokes_and_nodes():
    sp = data_planar.split({"items": 30, "points": 128, "nodes": 9,
                            "classes": 10}, 3, "cpu")
    assert sp["pc"].shape == (30, 128, 2) and sp["node"].shape == (30, 9, 2)
    assert float(sp["pc"].abs().amax()) == pytest.approx(1.0)
    assert torch.equal(sp["label"], torch.arange(30) % 10)
    # every node is a point of its cloud, and no two coincide
    hit = (sp["node"][:, :, None] == sp["pc"][:, None]).all(-1).any(-1)
    assert bool(hit.all())
    assert (torch.cdist(sp["node"], sp["node"])
            + torch.eye(9) * 9).amin() > 0
    again = data_planar.split({"items": 30, "points": 128, "nodes": 9,
                               "classes": 10}, 3, "cpu")
    assert torch.equal(again["pc"], sp["pc"])


def setup():
    from sonet_torch.config import mnist
    cfg = mnist().replace(compute_dtype="float32", batch_size=4,
                          input_pc_num=48, node_num=9, som_k=4,
                          feature_num=64)
    d = dataclasses.asdict(cfg)
    sp = data_planar.split({"items": 12, "points": 64, "nodes": 9,
                            "classes": 10}, 9, "cpu")
    return cfg, d, data.weights(rp.param_specs(d), 5, "cpu"), sp


@pytest.mark.parametrize("train", [True, False])
def test_reference_against_the_program(train):
    """At N=48 of 64 points, so the subset keys are drawn as well."""
    from sonet_torch.models import build_model
    cfg, d, w, sp = setup()
    batch = rp.sample({k: v[:4] for k, v in sp.items()},
                      torch.Generator().manual_seed(3), d, train)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(w, strict=True)
    model.train(train)
    out, _ = model(batch["pc"], None, batch["node"], epoch=0,
                   generator=torch.Generator().manual_seed(4))
    p = {n: t.clone().requires_grad_(True) for n, t in w.items()}
    ref = rp.forward(p, d, batch, train, torch.Generator().manual_seed(4))
    torch.testing.assert_close(out.float(), ref, rtol=1e-4, atol=1e-4)
    if not train:
        return
    rp.loss(d, out, batch).backward()
    rp.loss(d, ref, batch).backward()
    ref_grad = {n: p[n].grad for n in rp.trainable(rp.param_specs(d))}
    leaves = compare.kept_leaves(ref_grad)
    prog_grad = {n: q.grad for n, q in model.named_parameters()}
    assert compare.leaf_gap(prog_grad, ref_grad, leaves) < 1e-3


def test_sound():
    r = run()
    assert r.correct, r.checks
    assert r.attempted > 0 and r.failed == 0
    assert set(r.end_to_end) == {"train_clouds_per_s", "setup_s"}
    checks = {name: value for name, value, _ in r.checks}
    assert set(checks) == {"loss_gap", "head_grad_gap", "change_worst_gap",
                           "logit_gap"}
    # float32 against float32: the logits by sums in other orders
    assert checks["logit_gap"] < 1e-4


def test_state_unchanged(monkeypatch):
    from sonet_torch.train.state import TrainState

    def no_update(self):
        self.step += 1
    monkeypatch.setattr(TrainState, "apply_gradients", no_update)
    r = run()
    assert not r.correct
    checks = {n: v for n, v, _ in r.checks}
    assert checks["change_worst_gap"] == pytest.approx(1.0)


def test_half_batch(monkeypatch):
    from sonet_torch.train import losses
    ce = losses.cross_entropy
    monkeypatch.setattr(losses, "cross_entropy",
                        lambda s, y: ce(s[:len(s) // 2], y[:len(y) // 2]))
    r = run()
    assert not r.correct
    checks = {n: (v, lim) for n, v, lim in r.checks}
    assert checks["loss_gap"][0] > checks["loss_gap"][1]


def judged(**kw):
    """The reference run as ``kw`` says, in the program's place, judged
    against the float32 reference with the cell's limits, at a tiny size:
    (correct, {number: (value, limit)})."""
    cfg, d, w, sp = setup()
    raws = [{k: v[i:i + 4] for k, v in sp.items()} for i in (0, 4, 8)]
    ref = rp.checked_steps(w, d, raws[:2], raws[2:], 6, 3)
    got = rp.checked_steps(w, d, raws[:2], raws[2:], 6, 3, **kw)
    same = comparison(ref, ref)
    assert same["loss_gap"] == same["logit_gap"] == 0
    ctx = harness.make_context(harness.load_manifest(), CELL, 1, 1.0, False,
                               "cpu", 0.0)
    ok, checks = harness.judge(comparison(got, ref), ctx.limits)
    return ok, {n: (v, lim) for n, v, lim in checks}


def test_float8_control_fails_the_limits():
    ok, checks = judged(prec=Precision("float8"))
    assert not ok
    for n in ("loss_gap", "head_grad_gap", "logit_gap"):
        assert checks[n][0] > checks[n][1], n


def test_half_batch_reference_fails_the_limits():
    ok, checks = judged(loss_rows=2)
    assert not ok
    assert checks["loss_gap"][0] > checks["loss_gap"][1]
    assert checks["head_grad_gap"][0] > checks["head_grad_gap"][1]
    # its forward is sound
    assert checks["logit_gap"][0] == 0


def test_traced_run_reads_the_grouping_range():
    """A traced run profiles an eager step after its window and reads the
    grouping range there (0 device seconds on the CPU, which has no device
    rows)."""
    r = run({**TINY, "traffic": {"part_rows": 2, "settle_seconds": [0, 0]}},
            seconds=3.0, trace=True)
    assert r.correct, r.checks
    assert set(r.readings["span_device_s"]) == {"sonet:grouping"}
    per_layer = r.readings["per_layer"]
    assert {"grouping_device_ms.train", "step_device_ms.train",
            "mfu.train", "device_idle_pct.train"} <= set(per_layer)


def test_calibration_readings():
    """``calibrate_planar.readings`` at a tiny size on the CPU: the program
    and the bfloat16-rounded reference within the cell's limits, the
    control and the half batch outside them."""
    from benchmark import calibrate_planar
    ctx = harness.make_context(harness.load_manifest(), CELL, 3, 0.0, False,
                               "cpu", time.perf_counter(), overrides=TINY)
    driver = harness.load_module(
        harness.BENCH_DIR / "drivers" / "train_planar.py", "bench_driver")
    out = calibrate_planar.readings(ctx, driver, 2**33 + 13)
    assert harness.judge(out["program"], ctx.limits)[0]
    assert not harness.judge(out["reference_float8"], ctx.limits)[0]
    assert not harness.judge(out["half_batch"], ctx.limits)[0]
