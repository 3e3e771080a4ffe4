"""idle_outside_replays_pct.train: the share (%) of the traced slice of
training in which the device ran nothing before the first replay or after
the last (the profiler's start, the table's upload, the part's fetch):
100 x ``replays.idle_split``'s ``outside_replays`` / the slice's wall
time."""

from benchmark import replays


def read(r):
    return replays.idle_pct(r, "outside_replays")
