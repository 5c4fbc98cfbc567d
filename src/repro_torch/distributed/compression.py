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
``grad_transform`` hook.  A placed leaf (a DTensor) is quantized with the
max over the whole leaf, as the reference's per-tensor scale is.
``compressed_psum`` is the int8-on-the-wire all-reduce of the reference's
``shard_map`` body over one axis of a process mesh (an all-reduce MAX of
the scale, then an all-reduce SUM of the int8 codes as int32, then the
rescale); over an axis of extent 1 it is that body on one shard.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

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
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def compress(self, grads, residual):
        """Returns (decompressed grads as seen post-collective, residual').
        Placed leaves run as DTensors: the max is the whole leaf's."""
        def one(g, r):
            with implicit_replication():
                g = g.to(torch.float32) + r
                q, scale = quantize_int8(g)
                dq = dequantize_int8(q, scale)
                return dq, g - dq

        out = tree_map(one, grads, residual)
        return (tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out))


def compressed_psum(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """int8-on-the-wire all-reduce of each rank's ``x`` over ``mesh``'s
    ``axis``: each shard quantizes its contribution with the max of the
    shards' scales, and the int32 sum of the codes is rescaled by that
    scale.  On a process mesh the collectives run over the axis's
    process group; on any other mesh (anything with a ``.shape``
    mapping) the axis must have extent 1: the shard's own codes."""
    extent = mesh.shape[axis]
    group = None
    if extent != 1:
        if not hasattr(mesh, "device_mesh"):
            raise ValueError(
                f"compressed_psum over {axis!r} of extent {extent} takes a "
                "process mesh (launch.mesh.make_mesh, one process a device)")
        group = mesh.group(axis)
    _, scale = quantize_int8(x)
    if group is not None:                 # the pmax
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale),
                    -127, 127).to(torch.int8)
    acc = q.to(torch.int32)
    if group is not None:                 # the psum of the codes
        dist.all_reduce(acc, group=group)
    return acc.to(torch.float32) * scale
