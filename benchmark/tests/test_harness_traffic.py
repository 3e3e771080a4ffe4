"""The traffic generators: open-loop schedules, lateness arithmetic and
the epochs of a training run."""

import math

import numpy as np
import pytest

from benchmark import harness
from benchmark.traffic import (EpochRows, arrivals, epoch_table,
                               lateness_growth, percentile)

SERVE = harness.load_module(harness.BENCH_DIR / "drivers" / "serve_http.py",
                            "bench_driver_serve_http")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40])
def test_arrivals_same_work_every_seed(seed):
    due, which = arrivals(150.0, 20.0, 256, seed)
    ref_due, ref_which = arrivals(150.0, 20.0, 256, 1)
    assert len(due) == 3000 and due[0] > 0.0
    gaps, ref_gaps = np.diff(due, prepend=0.0), np.diff(ref_due, prepend=0.0)
    assert np.all(gaps > 0)
    # the same set of gaps, in another order
    np.testing.assert_allclose(np.sort(gaps), np.sort(ref_gaps), rtol=0,
                               atol=1e-9)
    # each body the same number of times
    assert np.array_equal(np.bincount(which, minlength=256),
                          np.bincount(ref_which, minlength=256))
    assert due[-1] == pytest.approx(20.0, rel=0.05)


def test_arrivals_follow_the_seed():
    a, _ = arrivals(150.0, 5.0, 16, 3)
    b, _ = arrivals(150.0, 5.0, 16, 3)
    c, _ = arrivals(150.0, 5.0, 16, 4)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_latency_from_due_time():
    due = np.array([0.0, 0.1, 0.2])
    res = {"done": np.array([0.05, 0.3, np.nan])}
    lat = SERVE.latencies(due, res, waited_s=10.0)
    # the second request was sent late: its wait counts; the third never
    # answered and counts the whole wait after its due time
    np.testing.assert_allclose(lat, [50.0, 200.0, 9800.0])


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 50) == 50 and percentile(v, 95) == 95
    assert percentile([1.0, math.inf], 95) == math.inf
    assert percentile([3.0], 95) == 3.0


def test_lateness_growth():
    due = np.arange(30) * 0.01
    steady = due + 0.001
    growing = due + np.arange(30) * 0.002
    assert lateness_growth(due, steady) == pytest.approx(0.0)
    assert lateness_growth(due, growing) == pytest.approx(0.04)


def test_epoch_rows():
    rows = EpochRows(items=20, batch=4, seed=5)
    assert rows.steps_per_epoch == 5
    parts = [rows.take(3), rows.take(3), rows.take(3)]
    # epoch 0 ends after 5 rows: the second part stops there
    assert [len(p) for p in parts] == [3, 2, 3]
    first = np.concatenate(parts[:2]).ravel()
    assert sorted(first) == list(range(20))
    assert np.array_equal(np.concatenate(parts[:2]), epoch_table(20, 4, 5, 0))
    assert np.array_equal(parts[2], epoch_table(20, 4, 5, 1)[:3])
    # drop last: 22 items make 5 whole batches
    assert epoch_table(22, 4, 5, 0).shape == (5, 4)
