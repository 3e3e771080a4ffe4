"""The replays of a traced part and the idle time split by them, on a
made-up slice; on a card, the replays found from the device rows against
the program's own range around each (``sonet:EpochGraph.replay``)."""

import pytest

from benchmark import harness, replays, trace

US = 1_000

STEP = ("void index_select_kernel<long>", "nvjet_hsh_gemm",
        "void at::native::elementwise_kernel<...>")


def slice_(step=STEP):
    """A part of three replays of a three-row step, in a slice of 100 us:
    the table's upload, the replays with idle time inside, between and
    around them, and the fetch."""
    dev = [("Memcpy HtoD (Pinned -> Device)", 2 * US, 4 * US)]
    for start in (10 * US, 36 * US, 62 * US):   # a replay: 24 us, 2 idle
        dev += [(step[0], start, start + 5 * US),
                (step[1], start + 6 * US, start + 16 * US),
                (step[2], start + 17 * US, start + 24 * US)]
    dev += [("Memcpy DtoH (Device -> Pageable)", 90 * US, 92 * US)]
    spans = [("EpochGraph.run", 1 * US, 95 * US)]
    return trace.Trace(start=0, end=100 * US, device=dev, spans=spans)


def readings(t, steps=3):
    return {"trace": t, "slice_steps": steps, "step_flops": 1e9,
            "peak_flops_per_s": 1e12, "pooling_bound_s": 0.5e-3}


def read(name, r):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "m").read(r)


def test_extents_are_the_repeats_between_head_and_tail():
    t = slice_()
    assert replays.extents(t, 3) == [(10 * US, 34 * US), (36 * US, 60 * US),
                                     (62 * US, 86 * US)]
    # one replay too many or too few: the rows do not repeat so
    assert replays.extents(t, 2) is None
    assert replays.extents(t, 4) is None
    # the order of the rows as listed does not matter
    t.device = t.device[::-1]
    assert replays.extents(t, 3)[0] == (10 * US, 34 * US)


def test_no_extents_when_the_steps_differ():
    t = slice_()
    t.device[5] = ("another_kernel", *t.device[5][1:])
    assert replays.extents(t, 3) is None
    assert replays.extents(trace.Trace(0, 100 * US, [], []), 3) is None


def test_idle_split_adds_up_to_the_idle_time():
    t = slice_()
    split = replays.idle_split(t, replays.extents(t, 3))
    # inside: 2 us a replay; between: 34-36 and 60-62; outside: 0-2,
    # 4-10, 86-90, 92-100
    assert split["in_replay"] == pytest.approx(6e-6)
    assert split["between_replays"] == pytest.approx(4e-6)
    assert split["outside_replays"] == pytest.approx(20e-6)
    idle = t.window_s - trace.busy_s(t)
    assert sum(split.values()) == pytest.approx(idle)
    idle_pct = read("device_idle_pct.train", readings(t))
    assert sum(100 * v / t.window_s for v in split.values()) \
        == pytest.approx(idle_pct)


def test_readers_on_the_slice():
    r = readings(slice_())
    assert read("idle_in_replay_pct.train", r) == pytest.approx(6.0)
    assert read("idle_between_replays_pct.train", r) == pytest.approx(4.0)
    assert read("idle_outside_replays_pct.train", r) == pytest.approx(20.0)
    assert read("kernels_per_step.train", r) == pytest.approx(3.0)


@pytest.mark.parametrize("name", ["idle_in_replay_pct.train",
                                  "idle_between_replays_pct.train",
                                  "idle_outside_replays_pct.train",
                                  "kernels_per_step.train"])
def test_readers_find_nothing_without_replays(name):
    assert read(name, {"trace": None}) is None
    assert read(name, readings(slice_(), steps=0)) is None
    t = slice_()
    t.device[5] = ("another_kernel", *t.device[5][1:])
    assert read(name, readings(t)) is None


class _Event:
    """A kineto event as ``trace.collect`` reads it."""

    def __init__(self, name, s, e, cuda, annotation=False):
        self._v = (name, s, e, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        kineto = type("K", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def test_collect_leaves_the_programs_ranges_out_of_the_device_rows():
    t = slice_()
    events = [_Event("bench:slice", 0, 100 * US, cuda=False)]
    events += [_Event(n, s, e, cuda=True) for n, s, e in t.device]
    events += [_Event("sonet:EpochGraph.replay", s, e, cuda=True,
                      annotation=True)
               for s, e in replays.extents(t, 3)]
    got = trace.collect(_Prof(events))
    assert sorted(got.device) == sorted(t.device)
    assert replays.extents(got, 3) == replays.extents(t, 3)


@pytest.mark.cuda
def test_extents_are_the_programs_replay_ranges_on_a_card(card):
    """A captured train step of a tiny classifier, a few replays under the
    profiler inside the harness's slice: the replays found from the
    device rows are the device rows of the program's own ranges."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sonet_torch import config
    from sonet_torch.data.device_pipeline import DeviceData, sample_batch
    from sonet_torch.train import graphs, init_state, make_steps
    from sonet_torch.train.state import set_capturable, snapshot

    cfg, rows = config.tiny_test(), 5
    g = torch.Generator().manual_seed(0)
    data = DeviceData(
        pc=torch.randn((12, 80, 3), generator=g).to(card),
        sn=torch.randn((12, 80, 3), generator=g).to(card),
        node=torch.randn((12, cfg.node_num, 3), generator=g).to(card),
        label=torch.randint(0, cfg.classes, (12,), generator=g).to(card))
    state = init_state(cfg, device=card, seed=0, steps_per_epoch=rows)
    set_capturable(state.optimizer, True)
    train_step, _ = make_steps(cfg, rows)
    gen = torch.Generator(device=card).manual_seed(1)

    def step(d, idx):
        return train_step(state, sample_batch(d, idx, gen, cfg, train=True),
                          gen)[1]
    graph = graphs.EpochGraph(step, card, generators=(gen,),
                              snapshot=lambda: snapshot(state))
    table = np.arange(rows * cfg.batch_size).reshape(rows, -1) % 12
    graph.run(data, table)                  # the capture
    spans = harness.Spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans("slice"):
            graph.run(data, table)
    assert graph.captures == 1
    marked = sorted((int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA
                    and e.name() == graphs.REPLAY)
    got = replays.extents(trace.collect(prof), rows)
    assert got is not None and len(marked) == rows
    assert got == marked
