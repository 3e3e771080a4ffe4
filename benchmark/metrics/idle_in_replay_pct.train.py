"""idle_in_replay_pct.train: the share (%) of the traced slice of training
in which the device ran nothing inside a replay's extent, between the
kernels of one captured step: 100 x ``replays.idle_split``'s
``in_replay`` / the slice's wall time."""

from benchmark import replays


def read(r):
    return replays.idle_pct(r, "in_replay")
