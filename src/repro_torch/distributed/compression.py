"""int8 quantization with a per-tensor f32 scale.

PyTorch copy of ``quantize_int8`` / ``dequantize_int8`` in
``repro.distributed.compression``: the same f32 arithmetic (scale =
max|x| / 127, floored at 1e-12 / 127; codes rounded half to even and
clipped to [-127, 127]), so both packages encode a column to the same
codes and scale.  The compressed layout stores confidence and lift this
way (``core.array_trie.quantize_metric_columns``).  The reference's
error-feedback gradient compressor belongs to the LM lanes (ROADMAP
slice 8) and is not copied.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 codes, f32 scale)`` with ``x ~= codes * scale``."""
    x = x.to(torch.float32)
    peak = x.abs().max() if x.numel() else torch.zeros((), device=x.device)
    scale = torch.clamp(peak, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale
