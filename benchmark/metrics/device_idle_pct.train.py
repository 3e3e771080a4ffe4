"""device_idle_pct.train: the share (%) of the traced slice of training in
which the device ran nothing: 100 (1 - union of device activity / the
slice's wall time)."""

from benchmark import trace


def read(r):
    t = r.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(t) / t.window_s)
