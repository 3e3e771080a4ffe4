"""The trace reduction on a made-up slice."""

import pytest

from benchmark import trace

MS = 1_000_000


def slice_():
    dev = [("segment_max_window_bulk<128>", 1 * MS, 2 * MS),
           ("fill_empty(float*, long)", 2 * MS, 3 * MS),
           ("void at::native::elementwise_kernel<...>", 2500_000, 4 * MS),
           ("nvjet_hsh_gemm", 6 * MS, 7 * MS),
           ("Memcpy DtoH (Device -> Pinned)", 9 * MS, 11 * MS)]
    spans = [("EpochGraph.run", 0, 8 * MS), ("table", 8 * MS, 10 * MS)]
    return trace.Trace(start=0, end=10 * MS, device=dev, spans=spans)


def test_busy_and_gaps():
    t = slice_()
    # union: [1, 4] + [6, 7] + [9, 10] (clipped) = 5 ms of 10
    assert trace.busy_s(t) == pytest.approx(5e-3)
    assert trace.gaps(t) == [(0, MS), (4 * MS, 6 * MS), (7 * MS, 9 * MS)]
    assert t.window_s == pytest.approx(10e-3)


def test_idle_gaps_name_the_open_span():
    gaps = trace.idle_gaps(slice_())
    assert gaps[0][0] == "EpochGraph.run" and gaps[0][1] == pytest.approx(2e-3)
    # the gap from 7 to 9 ms starts inside the run and ends in the table
    assert [g[0] for g in gaps] == ["EpochGraph.run", "EpochGraph.run",
                                    "EpochGraph.run"]
    t = slice_()
    t.spans = [("table", 8 * MS, 10 * MS)]
    assert trace.open_span(t, 8500_000) == "table"
    assert trace.open_span(t, 5 * MS) == "no span"


def test_kernel_time_and_buckets():
    t = slice_()
    s, n = trace.kernel_time(t, r"\bsegment_max_window_(bulk|direct)\b")
    assert (s, n) == (pytest.approx(1e-3), 1)
    s, n = trace.kernel_time(
        t, r"\b(segment_max_window_(bulk|direct)|fill_empty)\b")
    assert (s, n) == (pytest.approx(2e-3), 2)
    b = trace.by_bucket(t)
    assert b["pooling kernel"] == pytest.approx(2e-3)
    assert b["GEMMs"] == pytest.approx(1e-3)
    assert b["copies and memsets"] == pytest.approx(2e-3)
    assert b["elementwise"] == pytest.approx(1.5e-3)
    ops = trace.device_ops(t)
    assert ops[0][1] >= ops[-1][1]


def test_metric_readers_on_the_slice():
    from benchmark import harness
    t = slice_()
    r = {"trace": t, "slice_steps": 2, "step_flops": 1e9,
         "peak_flops_per_s": 1e12, "pooling_bound_s": 0.5e-3}

    def read(name):
        return harness.load_module(
            harness.BENCH_DIR / "metrics" / f"{name}.py", "m").read(r)
    assert read("step_device_ms.train") == pytest.approx(2.5)
    assert read("device_idle_pct.train") == pytest.approx(50.0)
    assert read("mfu.train") == pytest.approx(100 * 2e9 / (10e-3 * 1e12))
    assert read("segment_max_window_roofline") == pytest.approx(25.0)
    # nothing to read: nothing returned, never 0
    assert read.__call__ and harness.load_module(
        harness.BENCH_DIR / "metrics" / "segment_max_window_roofline.py",
        "m").read({"trace": None}) is None
