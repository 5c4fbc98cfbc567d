"""The yardstick's peaks and the work of a kernel launch, counted from the
reference's own ranges (never from the program's outputs), so that the
count is the same whatever implements the op.

The peaks are NVIDIA's data sheet figures for one H100 SXM (a copy of the
port's ``launch/roofline.py`` constants).  A launch's least time is the
larger of its bytes over the HBM bandwidth and its operations over the
float32 rate; its roofline share is that least time over the device time
its kernels took.  Bytes count each input byte read once and each output
byte written once, as frozen copies of the port's ``chip_smoke.py``
``score_bytes`` / ``covered_positions`` / ``member_work`` count them: the
score's columns at every position a launch's ranges cover (each position
once, however many ranges hold it), the ranges or posting bounds read, and
k results of 8 bytes a query; three operations (a score, a compare, a
select) per position of each query's ranges.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # HBM3
F32_OPS_PER_S = 67e12         # float32 on the CUDA cores

# the node columns each rank score reads (the port's score pass loads these
# and no other), each 4 bytes in the f32 layout, plus the 4-byte depth of
# the min_depth mask
METRIC_COLUMNS = {
    "support": ("support",),
    "confidence": ("confidence",),
    "lift": ("lift",),
    "leverage": ("support", "lift"),
    "conviction": ("confidence", "lift"),
}

# the device kernels each ranking op launches, by name in a trace
RANK_KERNELS = ("score_kernel", "rank_seed_kernel", "rank_topk_kernel")
MEMBER_KERNELS = ("score_kernel", "member_count_kernel",
                  "member_ranges_kernel", "member_plan_kernel",
                  "member_topk_kernel")


def score_bytes(metric: str) -> int:
    return 4 + 4 * len(METRIC_COLUMNS[metric])


def covered_positions(los: np.ndarray, his: np.ndarray) -> int:
    """Positions that one of the ranges ``[los, his)`` covers."""
    los = np.asarray(los, np.int64)
    his = np.asarray(his, np.int64)
    keep = his > los
    los, his = los[keep], his[keep]
    if los.size == 0:
        return 0
    order = np.argsort(los, kind="stable")
    los, his = los[order], np.maximum.accumulate(his[order])
    new = np.ones(los.shape[0], bool)
    new[1:] = los[1:] > his[:-1]
    idx = np.nonzero(new)[0]
    ends = np.append(idx[1:], los.shape[0]) - 1
    return int((his[ends] - los[idx]).sum())


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def rank_work(los: Sequence[int], his: Sequence[int], k: int,
              metric: str):
    """(bytes, operations) of a top-k over the distinct ranges of one
    launch."""
    los = np.asarray(los, np.int64)
    his = np.asarray(his, np.int64)
    q = los.shape[0]
    span = float(np.maximum(his - los, 0).sum())
    return (score_bytes(metric) * covered_positions(los, his)
            + 8 * q * (1 + k), 3 * span)


def member_work(qid: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                postings: int, q: int, k: int, metric: str, role: str):
    """(bytes, operations) of a membership top-k over one launch's member
    ranges (``q`` distinct items, ``postings`` nodes of those items)."""
    per_posting = 4 if role == "consequent" else 8
    span = float(np.maximum(np.asarray(hi) - np.asarray(lo), 0).sum())
    return (score_bytes(metric) * covered_positions(lo, hi)
            + per_posting * postings + 12 * q + 8 * q * k, 3 * span)
