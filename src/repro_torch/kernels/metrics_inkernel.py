"""Shared metric math: the Eq. 1-4 compound lift and the rank scores.

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

``dequantize_metrics`` belongs to the compressed layout and is not part
of this package yet.
"""
from __future__ import annotations

import torch

CONVICTION_CAP = 1e30

RANK_METRICS = ("support", "confidence", "lift", "leverage", "conviction")


def metric_index(metric: str) -> int:
    """Position of ``metric`` in ``RANK_METRICS``: the id the CUDA
    kernels switch on (``csrc/metrics.cuh``)."""
    try:
        return RANK_METRICS.index(metric)
    except ValueError:
        raise ValueError(f"unknown rank metric {metric!r}") from None


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
