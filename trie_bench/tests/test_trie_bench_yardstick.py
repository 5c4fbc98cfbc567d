"""The yardstick's arithmetic: the work of a ranking launch counted from
the reference's ranges, and the reading of a device timeline."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from trie_bench import roofline
from trie_bench.readers import roofline_pct
from trie_bench.trace import DeviceEvents, breakdown, short_name


@pytest.mark.parametrize("los,his,want", [
    ([], [], 0),
    ([0], [10], 10),
    ([0, 5], [10, 12], 12),          # overlap counted once
    ([0, 2, 20], [10, 4, 25], 15),   # nested and apart
    ([3, 3], [3, 2], 0),             # empty and reversed
])
def test_covered_positions(los, his, want):
    assert roofline.covered_positions(np.array(los, np.int64),
                                      np.array(his, np.int64)) == want


def test_rank_and_member_work():
    b, ops = roofline.rank_work([0, 5], [10, 12], 8, "confidence")
    assert b == roofline.score_bytes("confidence") * 12 + 8 * 2 * 9
    assert ops == 3 * (10 + 7)
    b, ops = roofline.member_work(np.array([0, 1]), np.array([0, 20]),
                                  np.array([4, 22]), 2, 2, 100, "lift",
                                  "any")
    assert b == roofline.score_bytes("lift") * 6 + 8 * 2 + 12 * 2 \
        + 8 * 2 * 100
    assert ops == 3 * 6
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)


def events(spans, names=None, window=(0, 100)):
    s = np.array([a for a, _ in spans], np.int64)
    e = np.array([b for _, b in spans], np.int64)
    return DeviceEvents(names=names or ["k"] * len(spans), start=s, end=e,
                        window=window, drift_ns=0.0)


def test_busy_is_the_union_inside_the_window():
    ev = events([(-10, 5), (10, 20), (15, 30), (90, 130)])
    assert ev.busy_s() == pytest.approx((5 + 20 + 10) / 1e9)
    assert ev.window_s() == pytest.approx(100 / 1e9)


def test_breakdown_names_gaps_by_the_innermost_host_span():
    ev = events([(0, 10), (60, 70)], ["void a(int)", "b"])
    out = breakdown(ev, [("scheduler.step", 0, 100),
                         ("engine.top_k", 20, 50)])
    assert out["device_ops"][0] == ["a", pytest.approx(10 / 1e9)]
    gaps = dict((round(v * 1e9), k) for k, v in out["idle_gaps"])
    assert gaps == {50: "engine.top_k", 30: "scheduler.step"}
    assert short_name("void ns::kern<4>(float*, int)") == "ns::kern<4>"


def test_roofline_share_reads_only_the_calls_kernels():
    ev = events([(10, 20), (12, 14), (30, 40)],
                ["rank_topk_kernel", "other", "rank_topk_kernel"])
    ctx = SimpleNamespace(events=ev, calls=[("top_k", 5, 25, None),
                                            ("rules_with", 28, 45, None)])
    share = roofline_pct(ctx, "top_k", ("rank_topk_kernel",),
                         lambda ctx, arg: (3.35e12 * 5e-9, 0))
    assert share == pytest.approx(50.0)
    assert roofline_pct(ctx, "rules_with", ("member_topk_kernel",),
                        lambda ctx, arg: (1, 0)) is None
