"""The program's profiler ranges (``sonet_torch/utils/spans.py``) on the
CPU: ``EpochGraph.run`` marks each step as ``sonet:EpochGraph.replay``,
changes nothing it computes, and enters no profiler code while none is
recording.  No JAX here."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sonet_torch import config
from sonet_torch.data.device_pipeline import DeviceData, sample_batch
from sonet_torch.nn.encoder import GROUPING
from sonet_torch.train import init_state, make_steps
from sonet_torch.train import graphs
from sonet_torch.train.state import snapshot
from sonet_torch.utils import spans

ROWS = 3


def _tiny_epoch():
    """A tiny classifier's train step over a resident split, as the device
    pipeline runs it, an ``EpochGraph`` over it, a table of ``ROWS`` rows
    and a function that puts the state and the draws back."""
    cfg = config.tiny_test()
    g = torch.Generator().manual_seed(0)
    T = 12
    data = DeviceData(pc=torch.randn((T, 80, 3), generator=g),
                      sn=torch.randn((T, 80, 3), generator=g),
                      node=torch.randn((T, cfg.node_num, 3), generator=g),
                      label=torch.randint(0, cfg.classes, (T,), generator=g))
    state = init_state(cfg, device="cpu", seed=0, steps_per_epoch=ROWS)
    train_step, _ = make_steps(cfg, ROWS)
    gen = torch.Generator().manual_seed(1)

    def step(d, idx):
        _, metrics = train_step(state, sample_batch(d, idx, gen, cfg,
                                                    train=True), gen)
        return metrics

    table = np.arange(ROWS * cfg.batch_size).reshape(ROWS, cfg.batch_size)
    restore_state, gen_state = snapshot(state), gen.get_state()

    def restore():
        restore_state()
        gen.set_state(gen_state)
    return graphs.EpochGraph(step, "cpu", generators=(gen,)), data, table, \
        restore


@pytest.fixture
def one_thread():
    """One CPU thread: with several, the CPU's parallel reductions sum in
    another order from run to run, so two runs of a step differ in their
    last bits whatever the profiler does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _sonet_ranges(prof):
    return [e.name for e in prof.events() if e.name.startswith("sonet:")]


def test_one_replay_range_a_row_and_the_same_metrics(one_thread):
    graph, data, table, restore = _tiny_epoch()
    plain = graph.run(data, table)
    restore()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = graph.run(data, table)
    # each step's encoder forward marks its point-to-node grouping
    assert _sonet_ranges(prof) == [graphs.REPLAY, GROUPING] * ROWS
    assert set(plain) == set(traced) and plain
    for k in plain:
        np.testing.assert_array_equal(plain[k], traced[k])


def test_span_enters_no_profiler_code_when_off(monkeypatch):
    entered = []
    real = spans.record_function

    def counting(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(spans, "record_function", counting)
    graph, data, table, restore = _tiny_epoch()
    graph.run(data, table)
    assert entered == []
    assert spans.span("sonet:x") is spans.span("sonet:y")
    restore()
    with profile(activities=[ProfilerActivity.CPU]):
        graph.run(data, table)
    assert entered == [graphs.REPLAY, GROUPING] * ROWS


def _tiny_autoencode_step():
    """A tiny auto-encoder's state, its train step and a batch: the decoder
    emits 16 FC and 1,024 conv points, against 64 input points."""
    cfg = config.tiny_test().replace(task="autoencode")
    state = init_state(cfg, device="cpu", seed=0, steps_per_epoch=ROWS)
    train_step, _ = make_steps(cfg, ROWS)
    g = torch.Generator().manual_seed(2)
    B, N = cfg.batch_size, cfg.input_pc_num
    batch = {"pc": torch.randn((B, N, 3), generator=g),
             "sn": torch.randn((B, N, 3), generator=g),
             "node": torch.randn((B, cfg.node_num, 3), generator=g),
             "label": torch.zeros(B, dtype=torch.int64)}
    return lambda: train_step(state, batch, None), cfg


def test_decoder_and_chamfer_ranges_and_counter(one_thread):
    from sonet_torch.nn.decoder import SPAN as DECODER
    from sonet_torch.ops import chamfer
    step, cfg = _tiny_autoencode_step()
    final = (cfg.output_fc_pc_num + cfg.output_conv_pc_num, cfg.input_pc_num)
    pc4 = (256, cfg.input_pc_num)
    before = dict(chamfer.calls)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    # the decoder's forward, then the final cloud's and pc4's Chamfer loss
    assert _sonet_ranges(prof) == [GROUPING, DECODER, "sonet:chamfer",
                                   "sonet:chamfer"]
    grew = {k: v - before.get(k, 0) for k, v in chamfer.calls.items()
            if v != before.get(k, 0)}
    assert grew == {final: 1, pc4: 1}


def test_decoder_and_chamfer_spans_enter_no_profiler_code_when_off(
        monkeypatch):
    entered = []
    real = spans.record_function

    def counting(name):
        entered.append(name)
        return real(name)
    monkeypatch.setattr(spans, "record_function", counting)
    step, _ = _tiny_autoencode_step()
    step()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    assert entered == [GROUPING, "sonet:decoder", "sonet:chamfer",
                       "sonet:chamfer"]


@pytest.mark.parametrize("pooling", ["scatter", "sorted_window"])
def test_grouping_range_holds_the_grouping(pooling, one_thread):
    """A 2-D MNIST forward (no normals) marks its point-to-node grouping
    once: the top-k assignment's sort, the node counts and cluster sums
    (the segment sums on the sorted path, the one-hot product on the
    scatter path) lie inside the range; the first PointNet's products and
    node pooling lie after it; the range changes no output."""
    from sonet_torch.models import build_model
    cfg = config.mnist().replace(batch_size=2, input_pc_num=64, node_num=9,
                                 som_k=4, feature_num=64, pooling=pooling,
                                 compute_dtype="float32", dropout=0.0)
    model = build_model(cfg, device="cpu", seed=0).train()
    g = torch.Generator().manual_seed(3)
    pc = torch.rand((2, 64, 2), generator=g) * 2 - 1
    node = pc[:, :9] + 0.01
    plain, _ = model(pc, None, node, epoch=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced, _ = model(pc, None, node, epoch=0)
    torch.testing.assert_close(traced, plain, rtol=0, atol=0)
    events = prof.events()
    ranges = [e for e in events if e.name == GROUPING]
    assert len(ranges) == 1
    lo, hi = ranges[0].time_range.start, ranges[0].time_range.end
    inside = {e.name for e in events
              if lo <= e.time_range.start and e.time_range.end <= hi}
    after = {e.name for e in events if e.time_range.start > hi}
    assert "aten::sort" in inside
    if pooling == "sorted_window":
        assert "sonet_torch::segment_sums" in inside
        assert "sonet_torch::segment_sums" not in after
    else:
        assert "aten::bmm" in inside
    assert "aten::linear" not in inside and "aten::linear" in after
