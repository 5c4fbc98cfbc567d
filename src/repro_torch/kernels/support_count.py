"""Itemset support counting over the vertical transaction bitmaps.

``support_count_bitmap`` counts, for each candidate row of an int32
``[C, K]`` item matrix, the transactions that hold every valid item of the
row: the popcount of the AND of the rows' bitmaps (``arm.transactions``'s
layout, uint32 ``[I, W]`` viewed as int32).  A negative entry is skipped
anywhere in the row, a repeated item counts once, a row with ``lengths <=
0`` counts 0, and a row with ``lengths > 0`` and no valid item counts all
``n_transactions``.

On a CUDA tensor it launches the hand-written kernels in
``csrc/support_count.cu`` (replacing the TPU kernel
``repro.kernels.support_count.support_count_pallas``, a dense 0/1 product
on the matrix unit): a pre-pass maps the launch's distinct items to slots
and finds its largest id, the wrapper reads (largest id, D) back in one
copy and sizes the main launch (``launch_shape``), whose blocks stage a
word tile of the D item rows in shared memory for a slice of candidates.
``ref.support_slots_ref`` and ``ref.support_count_tiled_ref`` mirror that
plan.  On a CPU tensor it runs the plain version
``ref.support_count_bitmap_ref``, the reference's dense formulation.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import support_count_bitmap_ref, support_slots_ref

# mirrors of csrc/support_count.cu's constants
THREADS = 768         # candidates a tile block holds at once: one block an SM
MAX_BW = 32           # words a staged tile, at most
GLOBAL_BW = 32        # words a tile of the unstaged variant
# H100: dynamic shared memory a block may take (227 KB)
SMEM_BLOCK = 232_448


def check_transaction_count(n_words: int, n_transactions: int) -> None:
    """``n_transactions`` must fill the last of the ``n_words`` words:
    ``32 (W - 1) < T <= 32 W`` (``T = W = 0`` for an empty DB)."""
    t, w = int(n_transactions), int(n_words)
    if not (32 * (w - 1) < t <= 32 * w or t == w == 0):
        raise ValueError(
            f"{t} transactions do not fill {w} bitmap words of 32"
        )


def tile_bytes(n_distinct: int, bw: int, n_items: int) -> int:
    """Shared memory of a staged block: ``n_distinct + 1`` rows of ``bw``
    words (the items and the mask row), a slot word of 8 bytes per 32 ids
    of ``n_items``, then the items' ids."""
    d, nw = int(n_distinct), -(-int(n_items) // 32)
    return (d + 1) * bw * 4 + 8 * nw + 4 * d


def tile_words(n_distinct: int, n_words: int, n_items: int) -> int:
    """Words ``BW`` of a staged tile for ``n_distinct`` of ``n_items``
    item rows: the largest power of two in 4..``MAX_BW``, and not above the
    smallest one that covers ``n_words``, whose ``tile_bytes`` fit
    ``SMEM_BLOCK``; 0 when even 4 words do not fit, and the rows are read
    from device memory unstaged."""
    cap = 4
    while cap < min(int(n_words), MAX_BW):
        cap *= 2
    bw = cap
    while bw >= 4:
        if tile_bytes(n_distinct, bw, n_items) <= SMEM_BLOCK:
            return bw
        bw //= 2
    return 0


def staging_limit(n_items: int) -> int:
    """The most distinct of ``n_items`` items a launch can stage (at 4
    words a tile); below 0 when the slot words alone do not fit."""
    return (SMEM_BLOCK - 16 - 8 * -(-int(n_items) // 32)) // 20


def launch_shape(n_distinct: int, n_words: int, n_items: int, c: int,
                 sms: int) -> dict:
    """The main launch for ``n_distinct`` of ``n_items`` items,
    ``n_words`` words and ``c`` candidates on ``sms`` SMs: ``bw`` words a
    tile, ``staged``, ``smem`` bytes a block, ``tiles`` x ``slices`` blocks
    (one block an SM, as many slices as keep the blocks to one wave, at
    most one per ``THREADS`` candidates) and ``per_slice`` candidates a
    slice."""
    bw = tile_words(n_distinct, n_words, n_items)
    staged = bw > 0
    if not staged:
        bw = GLOBAL_BW
    smem = tile_bytes(n_distinct, bw, n_items) if staged else 0
    tiles = -(-int(n_words) // bw)
    slices = int(sms) // tiles if 0 < tiles < int(sms) else 1
    slices = max(1, min(slices, -(-int(c) // THREADS), 65535))
    return {"bw": bw, "staged": staged, "smem": smem, "tiles": tiles,
            "slices": slices, "per_slice": -(-int(c) // slices)}


def _distinct_items(candidates, n_items: int):
    """The pre-pass on the card: ``(largest id, D, bits, counts)``, the
    first two read back in one copy (-1 for the largest id of a matrix of
    no entry), then int32 scratch filled on the stream: the bitmask of the
    named ids (``ceil(I / 32)`` words) and the counts, zeroed.
    ``candidates`` is a checked int32 CUDA tensor with C > 0."""
    dev = candidates.device
    c, k = candidates.shape
    n_entries = c * k
    if n_entries >= 1 << 31:
        raise ValueError(
            f"support_count_bitmap: {n_entries} candidate entries, at most "
            f"2^31 - 1"
        )
    zeroed = torch.empty((2 + -(-n_items // 32),), dtype=torch.int32,
                         device=dev)
    counts = torch.empty((c,), dtype=torch.int32, device=dev)
    err = _build.lib("support_count").support_prepass_launch(
        candidates.data_ptr(), c, k, n_items, zeroed.data_ptr(),
        counts.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "support_count_bitmap (pre-pass)")
    top_enc, d = zeroed[:2].tolist()
    return top_enc - 1, d, zeroed[2:], counts


def _check_range(top: int, n_items: int) -> None:
    if top >= n_items:
        raise ValueError(f"item {top} out of range [0,{n_items})")


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
    if dev.type == "cpu":
        _check_range(support_slots_ref(candidates, n_items)[0], n_items)
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
    if c == 0:
        return torch.empty((0,), dtype=torch.int32, device=dev)
    top, d, bits, counts = _distinct_items(candidates, n_items)
    _check_range(top, n_items)
    shape = launch_shape(d, n_words, n_items, c, _build.sm_count(dev))
    err = _build.lib("support_count").support_count_launch(
        bitmaps.data_ptr(), n_words, candidates.data_ptr(), c, k,
        lengths.data_ptr(), int(n_transactions), n_items, bits.data_ptr(),
        d, shape["bw"], int(shape["staged"]), shape["smem"],
        shape["slices"], counts.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "support_count_bitmap")
    support_count_bitmap.launches += 1
    return counts


support_count_bitmap.launches = 0
