"""What the per-layer metric files share: the engine calls of the window,
and the work of a ranking launch counted from the reference's ranges."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .reference import answers as ra
from .roofline import least_seconds, member_work, rank_work


def window_calls(ctx, op: str) -> List[tuple]:
    """The engine calls of ``op`` that lie inside the traced window."""
    if ctx.events is None:
        return []
    lo, hi = ctx.events.window
    return [c for c in ctx.calls
            if c[0] == op and c[1] >= lo and c[2] <= hi]


def topk_launch_work(ctx, mat) -> tuple:
    """(bytes, operations) of one ``top_k_rules_batch`` call: its distinct
    prefix rows (``-1`` pads a row) as the reference's subtree ranges."""
    kw = ctx.traffic.kwargs["top_k"]
    rows = {tuple(int(x) for x in r if x != -1) for r in np.asarray(mat)}
    lo, hi = ra.prefix_ranges(ctx.ref, list(rows))
    return rank_work(lo, hi, kw["k"], kw["metric"])


def member_launch_work(ctx, items: Sequence[int]) -> tuple:
    """(bytes, operations) of one ``rules_with`` call: its distinct items
    (ids outside the vocabulary are one absent query) as the reference's
    member ranges and postings."""
    kw = ctx.traffic.kwargs["rules_with"]
    ref = ctx.ref
    it = np.asarray(list(items), np.int64)
    it = np.where((it >= 0) & (it < ref.n_items), it, -1)
    uq = np.unique(it)
    qid, lo, hi = ra.member_ranges(ref, uq, kw["role"])
    r = ref.ranks(uq)
    r = r[r < ref.n_frequent]
    postings = int((ref.post_offsets[r + 1] - ref.post_offsets[r]).sum())
    return member_work(qid, lo, hi, postings, uq.shape[0], kw["k"],
                       kw["metric"], kw["role"])


def roofline_pct(ctx, op: str, kernels: Sequence[str],
                 work) -> Optional[float]:
    """Least time over device time of ``kernels`` across the window's calls
    of ``op``, in percent; None where the trace holds none of them."""
    calls = window_calls(ctx, op)
    if not calls:
        return None
    dev = ctx.events.seconds_within([(c[1], c[2]) for c in calls], kernels)
    least = total = 0.0
    for c, s in zip(calls, dev):
        if s <= 0:
            continue
        least += least_seconds(*work(ctx, c[3]))
        total += s
    if total <= 0:
        return None
    return 100.0 * least / total
