"""Gradient compression: int8 quantization with error feedback.

PyTorch copy of ``repro.distributed.compression``.  ``quantize_int8`` /
``dequantize_int8`` keep the reference's f32 arithmetic (scale = max|x| /
127, floored at 1e-12 / 127; codes rounded half to even and clipped to
[-127, 127]), so both packages encode a tensor to the same codes and
scale; the compressed trie layout stores confidence and lift this way
(``core.array_trie.quantize_metric_columns``).

``ErrorFeedbackInt8`` quantizes each gradient leaf (plus the residual the
last step left) to int8 and carries the quantization residual to the next
step; the trainer wires it in through ``make_train_step``'s
``grad_transform`` hook.  ``compressed_psum`` is the int8-on-the-wire
all-reduce: over a mesh axis of extent 1 it computes what the reference's
``shard_map`` body computes on a one-device mesh.  An extent above 1
needs a process group per card, which waits for the multi-GPU slice
(``MULTI_GPU``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed.sharding import MULTI_GPU
from repro_torch.pytree import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 codes, f32 scale)`` with ``x ~= codes * scale``."""
    x = x.to(torch.float32)
    peak = x.abs().max() if x.numel() else torch.zeros((), device=x.device)
    scale = torch.clamp(peak, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


class ErrorFeedbackInt8:
    """Stateful compressor: state = residual tree (same shapes as grads)."""

    def init(self, params):
        return tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)

    def compress(self, grads, residual):
        """Returns (decompressed grads as seen post-collective, residual')."""
        def one(g, r):
            g = g.to(torch.float32) + r
            q, scale = quantize_int8(g)
            dq = dequantize_int8(q, scale)
            return dq, g - dq

        out = tree_map(one, grads, residual)
        return (tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out))


def compressed_psum(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """int8-on-the-wire all-reduce of ``x`` over ``mesh``'s ``axis``
    (``mesh``: anything with a ``.shape`` mapping).  Each shard quantizes
    its contribution with the max of the shards' scales, the int32 sum of
    the codes is rescaled by that scale.  One shard: its own codes."""
    extent = mesh.shape[axis]
    if extent != 1:
        raise NotImplementedError(
            f"compressed_psum over {axis!r} of extent {extent} needs one "
            f"process a card: {MULTI_GPU}")
    _, scale = quantize_int8(x)           # the pmax over one shard
    q = torch.clamp(torch.round(x.to(torch.float32) / scale),
                    -127, 127).to(torch.int8)
    return q.to(torch.int32).to(torch.float32) * scale
