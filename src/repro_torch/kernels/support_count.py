"""Itemset support counting over the vertical transaction bitmaps.

``support_count_bitmap`` counts, for each candidate row of an int32
``[C, K]`` item matrix, the transactions that hold every valid item of the
row: the popcount of the AND of the rows' bitmaps (``arm.transactions``'s
layout, uint32 ``[I, W]`` viewed as int32).  A negative entry is skipped
anywhere in the row, a repeated item counts once, a row with ``lengths <=
0`` counts 0, and a row with ``lengths > 0`` and no valid item counts all
``n_transactions``.

On a CUDA tensor it launches the hand-written kernel in
``csrc/support_count.cu`` (replacing the TPU kernel
``repro.kernels.support_count.support_count_pallas``, a dense 0/1 product
on the matrix unit); on a CPU tensor it runs the plain version
``ref.support_count_bitmap_ref``, the reference's dense formulation.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import support_count_bitmap_ref


def check_transaction_count(n_words: int, n_transactions: int) -> None:
    """``n_transactions`` must fill the last of the ``n_words`` words:
    ``32 (W - 1) < T <= 32 W`` (``T = W = 0`` for an empty DB)."""
    t, w = int(n_transactions), int(n_words)
    if not (32 * (w - 1) < t <= 32 * w or t == w == 0):
        raise ValueError(
            f"{t} transactions do not fill {w} bitmap words of 32"
        )


def support_count_bitmap(bitmaps, candidates, lengths, n_transactions: int):
    """``counts`` int32 ``[C]`` of every candidate row against the
    bitmaps: ``bitmaps`` int32 ``[I, W]``, ``candidates`` int32 ``[C, K]``
    (-1 padded), ``lengths`` int32 ``[C]``, all on one device.  Raises
    ``ValueError`` on an item id ``>= I``."""
    dev = bitmaps.device
    if bitmaps.dim() != 2 or candidates.dim() != 2 or lengths.dim() != 1:
        raise ValueError(
            "support_count_bitmap: bitmaps [I, W], candidates [C, K] and "
            "lengths [C] expected"
        )
    n_items, n_words = bitmaps.shape
    c, k = candidates.shape
    if lengths.shape[0] != c:
        raise ValueError(
            f"support_count_bitmap: {lengths.shape[0]} lengths for {c} "
            f"candidate rows"
        )
    check_transaction_count(n_words, n_transactions)
    if candidates.numel():
        top = int(candidates.max())
        if top >= n_items:
            raise ValueError(f"item {top} out of range [0,{n_items})")
    if dev.type == "cpu":
        return support_count_bitmap_ref(
            bitmaps, candidates, lengths, n_transactions
        )
    if dev.type != "cuda":
        raise ValueError(f"support_count_bitmap: unsupported device {dev}")
    _build.check_inputs(
        "support_count_bitmap", dev,
        bitmaps=(bitmaps, torch.int32, 2),
        candidates=(candidates, torch.int32, 2),
        lengths=(lengths, torch.int32, 1),
    )
    counts = torch.empty((c,), dtype=torch.int32, device=dev)
    if c == 0:
        return counts
    err = _build.lib("support_count").support_count_launch(
        bitmaps.data_ptr(), n_words, candidates.data_ptr(), c, k,
        lengths.data_ptr(), int(n_transactions), counts.data_ptr(),
        _build.stream_handle(dev),
    )
    _build.check(err, "support_count_bitmap")
    support_count_bitmap.launches += 1
    return counts


support_count_bitmap.launches = 0
