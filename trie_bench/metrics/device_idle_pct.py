"""device_idle_pct (device, H100): the share of the traced window in which
no kernel, copy or memset ran on the card, from the ``torch.profiler``
timeline.  Moves ``queries_per_s``: it says how far the host holds the
card back."""


def read(ctx):
    if ctx.events is None:
        return None
    w = ctx.events.window_s()
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx.events.busy_s() / w)
