"""outside_engine_ms.serve: the median over the window's answered requests
of the client's time from send to answer minus the daemon's own "ms" (the
time inside ``engine.predict``): parsing, the socket, the handler thread
and serialising the answer, in ms."""

import numpy as np


def read(r):
    outside = r.get("outside_engine_ms")
    if outside is None or len(outside) == 0:
        return None
    return float(np.median(outside))
