"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have (a step that leaves its state unchanged; the loss over half of the
batch; an answer altered where it is produced).  One chip has no exchange
between chips to leave out."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness

TINY = {"config": {"input_pc_num": 128, "node_num": 16, "feature_num": 64,
                   "compute_dtype": "float32"},
        "split": {"items": 48, "points": 256, "nodes": 16}}
TRAIN = {**TINY, "traffic": {"part_rows": 4}}
SERVE = {**TINY, "traffic": {"bodies": 16, "rate_per_s": 20,
                             "warmup_requests": 2}}
TRAIN_CELLS = ["modelnet40.train-device", "shapenetpart.train-device"]
# the serving harness, kept for a later cell (PERF.md, Open questions):
# its cell as it would enter BENCHMARK.json
SERVE_CELL = {"name": "modelnet40.serve-http", "config": "modelnet40",
              "traffic": "serve-http", "chips": 1, "why": "kept for later"}


def manifest():
    man = harness.load_manifest()
    man["workloads"] = man["workloads"] + [SERVE_CELL]
    return man


def run(cell, overrides, seconds=0.5, seed=2**33 + 3):
    ctx = harness.make_context(manifest(), cell, seed, seconds, False, "cpu",
                               time.perf_counter(), overrides=overrides)
    return harness.run_cell(ctx)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_sound(cell):
    r = run(cell, TRAIN)
    assert r.correct, r.checks
    assert r.attempted > 0 and r.failed == 0
    assert set(r.end_to_end) == {"train_clouds_per_s", "setup_s"}


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_state_unchanged(cell, monkeypatch):
    from sonet_torch.train.state import TrainState

    def no_update(self):
        self.step += 1
    monkeypatch.setattr(TrainState, "apply_gradients", no_update)
    r = run(cell, TRAIN)
    assert not r.correct
    checks = {n: v for n, v, _ in r.checks}
    assert checks["change_worst_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_train_half_batch(cell, monkeypatch):
    from sonet_torch.train import losses
    ce, ce_seg = losses.cross_entropy, losses.cross_entropy_seg
    monkeypatch.setattr(losses, "cross_entropy",
                        lambda s, y: ce(s[:len(s) // 2], y[:len(y) // 2]))
    monkeypatch.setattr(losses, "cross_entropy_seg",
                        lambda s, y: ce_seg(s[:len(s) // 2], y[:len(y) // 2]))
    assert not run(cell, TRAIN).correct


def test_serve_sound():
    r = run("modelnet40.serve-http", SERVE, seconds=1.0)
    assert r.correct, r.checks
    assert r.attempted == 20 and r.failed == 0
    assert set(r.end_to_end) == {"serve_p95_ms", "serve_p50_ms", "setup_s"}
    assert r.end_to_end["serve_p95_ms"] >= r.end_to_end["serve_p50_ms"] > 0
    assert r.readings["engine"]["items"] == 20


def test_serve_answer_altered(monkeypatch):
    from sonet_torch.serving import ServingEngine
    predict = ServingEngine.predict

    def altered(self, inputs):
        out = np.array(predict(self, inputs))
        out[0, 0] += 0.5 * np.abs(out[0]).max()
        return out
    monkeypatch.setattr(ServingEngine, "predict", altered)
    r = run("modelnet40.serve-http", SERVE, seconds=1.0)
    assert not r.correct


def test_control_fails_the_limits():
    """The control (the reference in 8-bit floats) read as the program is:
    over a train cell's limits and the serving cell's."""
    from benchmark import compare, data
    from benchmark.reference import model as rm, train as rt
    from benchmark.reference.precision import Precision
    man = manifest()
    for cell in TRAIN_CELLS + [SERVE_CELL["name"]]:
        ctx = harness.make_context(man, cell, 4, 1.0, False, "cpu", 0.0,
                                   overrides=TRAIN)
        d = ctx.cfg_dict
        w = data.weights(rm.param_specs(d), 4, "cpu")
        spec = {**ctx.config_file["split"], "items": 12}
        sp = data.split(spec, 4, "cpu")
        raws = [{k: v[i:i + 4] for k, v in sp.items()} for i in (0, 4, 8)]
        singles, chain = raws[:2], raws[2:]
        if cell.endswith("serve-http"):
            batch = rt.sample(raws[0], torch.Generator().manual_seed(1), d,
                              False)
            numbers = {"logit_gap": compare.logit_gap(
                rt.serve(w, d, batch, prec=Precision("float8")),
                rt.serve(w, d, batch))}
        else:
            ref = rt.checked_steps(w, d, singles, chain, 6, 3)
            ctl = rt.checked_steps(w, d, singles, chain, 6, 3,
                                   prec=Precision("float8"))
            numbers = compare.train_numbers(ctl, ref)
        ok, _ = harness.judge(numbers, ctx.limits)
        assert not ok, (cell, numbers)
