"""Shared metric math: the Eq. 1-4 compound lift, the rank scores, and
the widening of the compressed layout's quantized metric columns.

PyTorch twin of ``repro.kernels.metrics_inkernel``.  Every plain version
in this package scores through these functions, and the CUDA kernels
through their ``__device__`` twins in ``csrc/metrics.cuh``; both are the
same sequence of IEEE f32 operations (the kernels build with
``-fmad=false`` and correctly rounded division), so kernel and plain
version agree bitwise.

The scores, from the node columns (Support s, Confidence c, Lift l):

    support     s
    confidence  c
    lift        l
    leverage    s - s / l                                  (l > 0, else 0)
    conviction  (1 - c / l) / (1 - c)        (l > 0 and c < 1; CAP at c >= 1)

``dequantize_metrics`` widens the compressed layout's quantized columns
to f32, with the same arithmetic as ``csrc/metrics.cuh::dequantize``:

    int32 support (transaction counts)  count * f32(1 / max(n, 1))
    bf16                                exact widening
    int8 (``quantize_int8`` codes)      q * f32(scale)
    f32                                 untouched

The int32 reciprocal is taken on the host in f64 and rounded to f32 once,
and the column is multiplied by it: one correctly rounded f32 multiply
per element, the same on every device and in every kernel (a divide
would be a second formula to keep equal).
"""
from __future__ import annotations

import torch

# the widening has one owner, core.array_trie; the kernels' wrappers and
# plain versions take it from here
from ..core.array_trie import (  # noqa: F401
    count_reciprocal, dequantize_metrics,
)

CONVICTION_CAP = 1e30

RANK_METRICS = ("support", "confidence", "lift", "leverage", "conviction")


def metric_index(metric: str) -> int:
    """Position of ``metric`` in ``RANK_METRICS``: the id the CUDA
    kernels switch on (``csrc/metrics.cuh``)."""
    try:
        return RANK_METRICS.index(metric)
    except ValueError:
        raise ValueError(f"unknown rank metric {metric!r}") from None


# the node columns each score reads; the kernels' score pass loads these
# and no other (csrc/metrics.cuh::metric_reads)
METRIC_COLUMNS = {
    "support": ("support",),
    "confidence": ("confidence",),
    "lift": ("lift",),
    "leverage": ("support", "lift"),
    "conviction": ("confidence", "lift"),
}


# storage types the kernels widen, in the order of their codes
# (csrc/metrics.cuh RtSupportType / RtColumnType)
SUPPORT_STORAGE = (torch.float32, torch.int32, torch.bfloat16)
COLUMN_STORAGE = (torch.float32, torch.bfloat16, torch.int8)
# the (support, confidence/lift) pairs core.array_trie's
# quantize_metric_columns makes: the only ones the kernels instantiate
STORAGE_PAIRS = (
    (torch.float32, torch.float32),
    (torch.int32, torch.bfloat16),
    (torch.int32, torch.int8),
    (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.int8),
)


def storage_codes(what: str, support, confidence, lift) -> tuple:
    """``(support code, confidence/lift code)`` of the storage types a
    kernel launch passes; raises on a pair of types that no layout makes
    (``STORAGE_PAIRS``), or on confidence and lift of different types."""
    pair = (support.dtype, confidence.dtype)
    if pair not in STORAGE_PAIRS or lift.dtype != confidence.dtype:
        raise TypeError(f"{what}: support/confidence/lift are "
                        f"{support.dtype}/{confidence.dtype}/{lift.dtype}, "
                        f"expected a (support, confidence = lift) pair of "
                        f"{STORAGE_PAIRS}")
    return (SUPPORT_STORAGE.index(support.dtype),
            COLUMN_STORAGE.index(confidence.dtype))


def metric_pad_dtype(a: torch.Tensor) -> torch.dtype:
    """Storage dtype a metric column keeps on its way to a kernel: the
    quantized dtypes (int32 counts, bf16, int8) stay narrow, anything
    else normalizes to f32."""
    if a.dtype in (torch.int32, torch.bfloat16, torch.int8):
        return a.dtype
    return torch.float32


def rank_score(metric: str, support, confidence, lift):
    """Elementwise interestingness score from the f32 node columns."""
    if metric == "support":
        return support
    if metric == "confidence":
        return confidence
    if metric == "lift":
        return lift
    if metric == "leverage":
        pos = lift > 0
        safe_lift = torch.where(pos, lift, 1.0)
        return torch.where(pos, support - support / safe_lift, 0.0)
    if metric == "conviction":
        pos = lift > 0
        below = confidence < 1.0
        safe_lift = torch.where(pos, lift, 1.0)
        sup_c = torch.where(pos, confidence / safe_lift, 1.0)
        safe_den = torch.where(below, 1.0 - confidence, 1.0)
        conv = torch.where(below, (1.0 - sup_c) / safe_den, CONVICTION_CAP)
        return torch.where(pos, conv, 0.0)
    raise ValueError(f"unknown rank metric {metric!r}")


def compound_lift(found, single, node_lift, confidence, consequent_support):
    """Paper Eq. 1-4 lift select: the node lift for single-item
    consequents, compound confidence over the consequent-path Support
    otherwise (0 when that path is absent), 0 for absent rules."""
    has_c = consequent_support > 0
    safe_c = torch.where(has_c, consequent_support, 1.0)
    lift = torch.where(
        single, node_lift, torch.where(has_c, confidence / safe_c, 0.0)
    )
    return torch.where(found, lift, 0.0)
