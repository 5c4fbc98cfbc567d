"""engine_call_ms (engine and host prep, ``serve/trie_engine.py``,
``kernels/ops.py``): the mean wall time of the engine calls the scheduler
made in the window, each from its call to the end of the device work it
queued (the benchmark's ``serve_loop.TimedEngine``, which synchronizes at
the end of each call: the host copy that follows waits for that work
anyway).  Moves ``queries_per_s``: every request that misses the cache
waits for one."""

import numpy as np


def read(ctx):
    if ctx.events is None:
        return None
    lo, hi = ctx.events.window
    ms = [(c[2] - c[1]) / 1e6 for c in ctx.calls
          if c[1] >= lo and c[2] <= hi]
    if not ms:
        return None
    return float(np.mean(ms))
