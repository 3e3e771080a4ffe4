"""chamfer_device_ms.train: the device time, in ms, of the kernels that
the program's ranges ``sonet:chamfer`` (each Chamfer loss call: the
output cloud's and ``pc4``'s) and their backward launch in one profiled
eager train step, read after the window (``span_time.py``)."""


def read(r):
    s = r.get("span_device_s", {}).get("sonet:chamfer")
    return None if s is None else s * 1e3
