"""grouping_device_ms.train: the device time, in ms, of the kernels that
the program's range ``sonet:grouping`` (the encoder's point-to-node
grouping: the top-k assignment, the node sort, the node counts and
cluster sums, the decentered points) and its backward launch in one
profiled eager train step, read after the window (``span_time.py``)."""


def read(r):
    s = r.get("span_device_s", {}).get("sonet:grouping")
    return None if s is None else s * 1e3
