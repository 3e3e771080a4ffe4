"""step_device_ms.train: the device time of a train step, in ms: the
union of the device's kernels, copies and memsets over the traced slice,
over the steps in the slice."""

from benchmark import trace


def read(r):
    t = r.get("trace")
    if t is None or not r.get("slice_steps"):
        return None
    return trace.busy_s(t) / r["slice_steps"] * 1e3
