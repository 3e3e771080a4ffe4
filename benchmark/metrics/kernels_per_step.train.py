"""kernels_per_step.train: the device rows (kernels, copies and memsets)
that start inside a replay's extent, over the replays in the traced
slice: the rows one captured train step launches."""

from benchmark import replays


def read(r):
    found = replays.of_readings(r)
    if found is None:
        return None
    t, ext = found
    return replays.kernels_in_replays(t, ext) / len(ext)
