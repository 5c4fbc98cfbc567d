"""response_p95_ms (serve loop, ``serve/scheduler.py``): the 95th
percentile (nearest rank) over every request answered in the window of the
host-clock time from just before its ``submit`` to the return of the
``step`` that answered it.  Moves ``queries_per_s``: in a closed loop a
client's next query waits for this reply."""

import math

import numpy as np


def read(ctx):
    lat = np.sort(np.asarray(ctx.loop.latencies_ms, np.float64))
    if lat.size == 0:
        return None
    return float(lat[max(math.ceil(0.95 * lat.size), 1) - 1])
