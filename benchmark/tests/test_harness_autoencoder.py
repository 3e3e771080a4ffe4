"""The cell ``autoencoder.train-device`` on the CPU at a tiny size: its
FLOP count by hand, the reference against the program, whole runs (sound;
with the timed path broken underneath: the pc4 term dropped from the
program's loss, the loss over half of the batch, a state left unchanged),
the control and the half batch judged with the cell's limits, and the
reading of the program's ranges from a profiled eager step
(``span_time.py``)."""

import dataclasses
import json
import time

import pytest
import torch

from benchmark import compare, counts_autoencoder, data, harness, span_time
from benchmark.drivers.train_autoencode import comparison, weights
from benchmark.reference import autoencoder as ra, train as rt
from benchmark.reference.precision import Precision

CELL = "autoencoder.train-device"
TINY = {"config": {"input_pc_num": 128, "node_num": 16, "feature_num": 64,
                   "compute_dtype": "float32"},
        "split": {"items": 48, "points": 256, "nodes": 16},
        "traffic": {"part_rows": 4}}


def run(overrides=TINY, seconds=0.5, trace=False, seed=2**33 + 5):
    ctx = harness.make_context(harness.load_manifest(), CELL, seed, seconds,
                               trace, "cpu", time.perf_counter(),
                               overrides=overrides)
    return harness.run_cell(ctx)


def tiny_counts():
    return {"task": "autoencode", "batch_size": 2, "input_pc_num": 4,
            "node_num": 4, "k": 2, "som_k": 2, "feature_num": 8,
            "classes": 3, "surface_normal": True,
            "compute_dtype": "bfloat16", "output_fc_pc_num": 2,
            "output_conv_pc_num": 1024}


def test_counts_by_hand():
    # B=2, N=4, k=2 (kN=8), M=4, K=2, F=8, P=2; conv widths 8 4 2 1 1 1
    enc = (16 * 2 * (384 + 8192 + 32768 + 122880)        # first PointNet
           + 16 * 2 * (387 * 512 + 512 * 512)           # kNN layer
           + 8 * 2 * (515 * 768 + 768 * 8))             # final PointNet
    fc = 2 * 2 * (8 * 4 + 4 * 6 + 6 * 8 + 8 * 6)        # 8 -> 4 -> 6 -> 8 -> 6
    # 2 B side^2 9 cin cout at 2x2, 4x4, 8x8, 16x16, 32x32 (read), 64x64
    conv = [2 * 2 * 4 * 9 * 8 * 8, 2 * 2 * 16 * 9 * 8 * 4,
            2 * 2 * 64 * 9 * 4 * 2, 2 * 2 * 256 * 9 * 2 * 1,
            2 * 2 * 1024 * 9 * 1 * 1, 2 * 2 * 4096 * 9 * 1 * 1]
    tap = {s: 2 * 2 * s * s * (1 * 1 + 1 * 3) for s in (16, 32, 64)}
    geo = (2 * 2 * 4 * 3 * 4 + 2 * 2 * 4 * 8 * 3 + 2 * 2 * 4 * 3 * 4
           # Chamfer: (P + 1024) and 256 predicted points against N
           + 2 * 2 * 1026 * 4 * 3 + 2 * 2 * 256 * 4 * 3)
    read = fc + sum(conv[:5]) + tap[16] + tap[32]
    unread = conv[5] + tap[64]
    f = counts_autoencoder.forward_flops(tiny_counts(), 2)
    assert f == {"weights": enc + read, "unread": unread, "geometry": geo}
    assert counts_autoencoder.train_step_flops(tiny_counts()) == \
        3 * (enc + read) + unread + geo


def test_full_width_counts():
    from sonet_torch.config import autoencoder
    d = dataclasses.asdict(autoencoder())
    f = counts_autoencoder.forward_flops(d, 8)
    # the 64x64 stage: 9.66 G of convolution and 1.10 G of tap
    assert f["unread"] == pytest.approx(10.763e9, rel=1e-3)
    assert counts_autoencoder.train_step_flops(d) == pytest.approx(
        72.505e9, rel=1e-3)


def setup():
    from sonet_torch.config import autoencoder
    cfg = autoencoder().replace(compute_dtype="float32", batch_size=4,
                                input_pc_num=96, node_num=16, feature_num=64)
    d = dataclasses.asdict(cfg)
    sp = data.split({"items": 4, "points": 192, "nodes": 16, "classes": 16,
                     "parts": False}, 9, "cpu")
    return cfg, d, weights(d, 5, "cpu"), sp


@pytest.mark.parametrize("train", [True, False])
def test_reference_against_the_program(train):
    from sonet_torch.models import build_model
    from sonet_torch.train.loops import _ae_loss
    cfg, d, w, sp = setup()
    batch = rt.sample(sp, torch.Generator().manual_seed(3), d, train)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(w, strict=True)
    model.train(train)
    dec, _ = model(batch["pc"], batch["sn"], batch["node"], epoch=0)
    specs = ra.param_specs(d)
    p = {n: t.clone().requires_grad_(kind not in ("running_mean",
                                                   "running_var"))
         for n, t in w.items() for _, kind in [specs[n]]}
    ref = ra.forward(p, d, batch, train)
    # float32 sums in other orders: 1e-4 of the largest coordinate
    for name, got in (("pc", dec.pc), ("pc4", dec.conv_pc4)):
        scale = max(1.0, float(ref[name].abs().max()))
        assert float((got - ref[name]).abs().max()) < 1e-4 * scale, name
    if not train:
        return
    _ae_loss(cfg, dec, batch["pc"])[0].backward()
    ra.loss(d, ref, batch).backward()
    ref_grad = {n: (p[n].grad if p[n].grad is not None
                    else torch.zeros_like(p[n]))
                for n in ra.model.trainable(specs)}
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
                           "recon_gap", "recon_loss_gap"}
    # float32 against float32: the clouds by sums in other orders, the
    # loss of the program's own clouds by near-ties at most
    assert checks["recon_gap"] < 1e-4 and checks["recon_loss_gap"] < 1e-5


def test_pc4_term_dropped(monkeypatch):
    from sonet_torch.ops.chamfer import chamfer
    from sonet_torch.train import loops

    def final_only(cfg, dec, pc):
        c = chamfer(dec.pc, pc)
        return c.loss, {"loss": c.loss, "chamfer": c.loss}
    monkeypatch.setattr(loops, "_ae_loss", final_only)
    r = run()
    assert not r.correct
    checks = {n: (v, lim) for n, v, lim in r.checks}
    assert checks["loss_gap"][0] > checks["loss_gap"][1]
    assert checks["recon_loss_gap"][0] > checks["recon_loss_gap"][1]


def test_half_batch(monkeypatch):
    from sonet_torch.train import loops
    ae_loss = loops._ae_loss

    def half(cfg, dec, pc):
        n = pc.shape[0] // 2
        return ae_loss(cfg, dec._replace(**{
            k: v[:n] for k, v in dec._asdict().items() if v is not None}),
            pc[:n])
    monkeypatch.setattr(loops, "_ae_loss", half)
    r = run()
    assert not r.correct
    checks = {n: (v, lim) for n, v, lim in r.checks}
    assert checks["recon_loss_gap"][0] > checks["recon_loss_gap"][1]


def test_state_unchanged(monkeypatch):
    from sonet_torch.train.state import TrainState

    def no_update(self):
        self.step += 1
    monkeypatch.setattr(TrainState, "apply_gradients", no_update)
    r = run()
    assert not r.correct
    checks = {n: v for n, v, _ in r.checks}
    assert checks["change_worst_gap"] == pytest.approx(1.0)


def limits():
    return json.loads((harness.BENCH_DIR / "limits" / f"{CELL}.json")
                      .read_text())


def judged(**kw):
    """The reference run as ``kw`` says, in the program's place, judged
    against the float32 reference with the cell's limits, at a tiny
    size: (correct, {number: (value, limit)})."""
    cfg, d, w, sp = setup()
    d = {**d, "batch_size": 4}
    raws = [{k: v[:4] for k, v in sp.items()}] * 2
    ref = ra.checked_steps(w, d, raws[:1], raws[1:], 6, 3)
    got = ra.checked_steps(w, d, raws[:1], raws[1:], 6, 3, **kw)
    same = comparison(d, ref, ref)
    assert same["loss_gap"] == same["recon_gap"] == 0
    ok, checks = harness.judge(comparison(d, got, ref), limits())
    return ok, {n: (v, lim) for n, v, lim in checks}


def test_float8_control_departs():
    """The control (the reference in 8-bit floats) comes out not correct
    with the cell's limits: its clouds depart from the reference's."""
    ok, checks = judged(prec=Precision("float8"))
    assert not ok
    assert checks["recon_gap"][0] > checks["recon_gap"][1]


def test_half_batch_reference_fails():
    """The reference with its loss over half of each batch, in the
    program's place, comes out not correct with the cell's limits: its
    loss is not the Chamfer loss of its clouds."""
    ok, checks = judged(loss_rows=2)
    assert not ok
    assert checks["recon_loss_gap"][0] > checks["recon_loss_gap"][1]
    assert checks["recon_gap"][0] == 0


def test_traced_run_reads_the_ranges():
    """A traced run profiles an eager step after its window and reads both
    ranges there (0 device seconds on the CPU, which has no device
    rows)."""
    r = run({**TINY, "traffic": {"part_rows": 2}}, seconds=3.0, trace=True)
    assert r.correct, r.checks
    spans = r.readings["span_device_s"]
    assert set(spans) == {"sonet:decoder", "sonet:chamfer"}
    per_layer = r.readings["per_layer"]
    assert {"decoder_device_ms.train", "chamfer_device_ms.train",
            "step_device_ms.train", "mfu.train"} <= set(per_layer)


# ---------------------------------------------------------------------------
# span_time

def _op(name, corr, start, end, thread=1, seq=-1, fwd_thread=0):
    return span_time.Op(name, corr, thread, start, end, seq, fwd_thread)


def test_span_device_time_by_hand():
    """A range's forward ops, the backward functions of the sequence
    numbers they own, and the device rows linked to either."""
    B = span_time.BACKWARD
    ops = [
        _op("bench:step", 1, 0, 1000),
        _op("sonet:dec", 2, 10, 100),
        _op("aten::mm", 3, 20, 40, seq=7),
        _op("aten::relu", 4, 50, 60, seq=8),
        _op("aten::add", 5, 90, 95, seq=9),     # makes no node: peeks 9
        _op("aten::mul", 6, 110, 120, seq=9),   # after the range, makes 9
        _op(B + "MulBackward0", 10, 300, 320, thread=2, seq=9, fwd_thread=1),
        _op("aten::mul", 11, 305, 315, thread=2),
        _op(B + "ReluBackward0", 12, 330, 350, thread=2, seq=8, fwd_thread=1),
        _op("aten::threshold_backward", 13, 335, 345, thread=2),
        _op(B + "MmBackward0", 14, 360, 400, thread=2, seq=7, fwd_thread=1),
        _op("aten::mm", 15, 365, 380, thread=2),
        _op("aten::mm", 16, 381, 395, thread=2),
    ]
    rows = [("gemm", 500, 530, 3), ("relu", 530, 535, 4),
            ("add", 535, 536, 5), ("mul", 536, 540, 6),
            ("mul_bwd", 600, 610, 11), ("thr", 610, 615, 13),
            ("gemm_a", 615, 640, 15), ("gemm_b", 640, 660, 16)]
    ev = span_time.Events(ops, rows)
    fwd, bwd = span_time.span_ops(ev, "sonet:dec", 0, 1000)
    assert [o.corr for o in fwd] == [2, 3, 4, 5]
    assert sorted(o.corr for o in bwd) == [12, 13, 14, 15, 16]
    # 30 + 5 + 1 forward, 5 + 25 + 20 backward (ns)
    assert span_time.span_device_s(ev, "sonet:dec", 0, 1000) == \
        pytest.approx(86e-9)
    assert span_time.span_device_s(ev, "sonet:dec", 0, 50) is None
    assert span_time.span_ops(ev, "sonet:other", 0, 1000) is None


def test_span_ops_of_a_profiled_autoencode_step():
    """On a CPU profile of two eager steps, the second inside the harness's
    span: the decoder's range holds its convolutions and their backward,
    the Chamfer ranges their argmins and the gathers' backward."""
    from torch.profiler import ProfilerActivity, profile
    from sonet_torch import config, train
    cfg = config.tiny_test().replace(task="autoencode")
    state = train.init_state(cfg, device="cpu", seed=0, steps_per_epoch=4)
    step, _ = train.make_steps(cfg, 4)
    g = torch.Generator().manual_seed(2)
    B, N = cfg.batch_size, cfg.input_pc_num
    batch = {"pc": torch.randn((B, N, 3), generator=g),
             "sn": torch.randn((B, N, 3), generator=g),
             "node": torch.randn((B, cfg.node_num, 3), generator=g),
             "label": torch.zeros(B, dtype=torch.int64)}
    spans = harness.Spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch, None)
        with spans("span_step"):
            step(state, batch, None)
    ev = span_time.collect(prof)
    mark = [o for o in ev.ops if o.name == "bench:span_step"][0]
    names = {}
    for span in ("sonet:decoder", "sonet:chamfer"):
        fwd, bwd = span_time.span_ops(ev, span, mark.start, mark.end)
        assert all(mark.start <= o.start and o.end <= mark.end for o in fwd)
        names[span] = ({o.name for o in fwd}, {o.name for o in bwd})
    dec_f, dec_b = names["sonet:decoder"]
    ch_f, ch_b = names["sonet:chamfer"]
    assert "aten::convolution" in dec_f
    assert span_time.BACKWARD + "ConvolutionBackward0" in dec_b
    assert "aten::argmin" in ch_f and "aten::argmin" not in dec_f
    assert span_time.BACKWARD + "GatherBackward0" in ch_b
    assert not dec_b & {o for o in ch_b if o.startswith(span_time.BACKWARD)
                        and "Gather" in o}
    assert span_time.read(prof, "span_step", ("sonet:decoder", "nothing")) \
        == {"sonet:decoder": 0.0}


def test_reference_turns_tf32_off_on_a_card():
    """The reference's products on a card are float32 products: TF32 off
    for matrix products and cuDNN's convolutions while it runs, the flags
    as they were afterwards."""
    mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (mm.allow_tf32, conv.allow_tf32)
    mm.allow_tf32 = conv.allow_tf32 = True
    try:
        with ra.true_float32("cuda"):
            assert (mm.allow_tf32, conv.allow_tf32) == (False, False)
        assert (mm.allow_tf32, conv.allow_tf32) == (True, True)
        with ra.true_float32("cpu"):
            assert (mm.allow_tf32, conv.allow_tf32) == (True, True)
    finally:
        mm.allow_tf32, conv.allow_tf32 = before
