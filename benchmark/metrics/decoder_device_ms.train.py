"""decoder_device_ms.train: the device time, in ms, of the kernels that
the program's range ``sonet:decoder`` (the auto-encoder's decoder
forward) and its backward launch in one profiled eager train step, read
after the window (``span_time.py``)."""


def read(r):
    s = r.get("span_device_s", {}).get("sonet:decoder")
    return None if s is None else s * 1e3
