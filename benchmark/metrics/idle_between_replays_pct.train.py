"""idle_between_replays_pct.train: the share (%) of the traced slice of
training in which the device ran nothing between two replays, after the
first replay starts and before the last ends, outside every replay's
extent: 100 x ``replays.idle_split``'s ``between_replays`` / the slice's
wall time."""

from benchmark import replays


def read(r):
    return replays.idle_pct(r, "between_replays")
