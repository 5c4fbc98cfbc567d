"""cache_hit_pct (serve loop, ``serve/scheduler.py``): the share of the
window's requests that the scheduler's versioned LRU answered, its
``serve.cache_hits`` counter over ``serve.submitted``, both taken as their
change over the window.  Moves ``queries_per_s``: a hit never reaches host
prep or a kernel."""


def read(ctx):
    c = ctx.loop.counters
    if c.get("submitted", 0) <= 0:
        return None
    return 100.0 * c["cache_hits"] / c["submitted"]
