"""segment_max_window_roofline: kernel 1 (the windowed segment max of the
encoder's node pooling) against its least time a call
(``counts.pooling_bound_s``, bytes at the HBM rate), as a share (%): the
bound over the device time of its launches (fill and main kernel) per
call, a call counted by its main kernel's rows in the traced slice."""

from benchmark import trace

MAIN = r"\bsegment_max_window_(bulk|direct)\b"
ALL = r"\b(segment_max_window_(bulk|direct)|fill_empty)\b"


def read(r):
    t = r.get("trace")
    if t is None:
        return None
    _, calls = trace.kernel_time(t, MAIN)
    seconds, _ = trace.kernel_time(t, ALL)
    if calls == 0 or seconds <= 0:
        return None
    return 100.0 * r["pooling_bound_s"] / (seconds / calls)
