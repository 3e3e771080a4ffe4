"""On a card: the trace reduction reads the device's rows inside the
harness's slice."""

import pytest
import torch

from benchmark import harness, trace


@pytest.mark.cuda
def test_slice_reads_device_rows(card):
    from torch.profiler import ProfilerActivity, profile
    spans = harness.Spans()
    x = torch.randn(2048, 2048, device=card)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans("slice"):
            with spans("work"):
                for _ in range(10):
                    x = x @ x / 2048
            torch.cuda.synchronize()
    t = trace.collect(prof)
    assert len(t.device) >= 10
    assert 0 < trace.busy_s(t) <= t.window_s
    assert trace.by_bucket(t).get("GEMMs", 0) > 0
    assert any(name == "work" for name, _, _ in t.spans)
