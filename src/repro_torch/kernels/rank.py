"""Segmented top-k rule ranking over the DFS layout.

``topk_rank_batch`` ranks Q DFS ranges ``[los[q], his[q])`` in one call:
the top-k of ``rank_score(metric)`` over each range, nodes at
``depth >= min_depth`` only, in ``jax.lax.top_k`` order (value desc,
position asc) with ``(-inf, -1)`` empty slots.  Because the trie is
DFS-contiguous, an antecedent-prefix subtree is one such range, and a
posting list in posting order is another.

On a CUDA tensor it launches the hand-written kernel in ``csrc/rank.cu``
(replacing the TPU kernel ``repro.kernels.rank.topk_rank_batch_pallas``):
three launches, planned on the device with no host read.  Equal ranges
are ranked once (``ref.dedup_ranges_ref``); a range with at least k full
tiles (else full 32-position groups) starts from the k-th smallest of
their keys (``ref.tile_keys_ref``, ``ref.seed_thresholds_ref``) and
reads only the tiles below it; one planned selection launch spreads the tiles read over
the card (``ref.plan_blocks_ref``) and a range's last block merges its
blocks' lists.  ``ref.topk_rank_planned_ref`` runs that design in plain
PyTorch.  On a CPU tensor it runs the plain version
``ref.topk_rank_batch_ref``.  The metric columns may be the compressed
layout's quantized storage (int32 support counts, bf16 or int8 confidence
and lift): the kernel widens them in its score pass, with
``n_transactions`` and the int8 scales, as the TPU kernel does.
``rank_merge`` is the reference's k-best list merge as a tensor op.
"""
from __future__ import annotations

import torch

from . import _build
from .metrics_inkernel import count_reciprocal, metric_index, storage_codes
from .ref import _empty_ranked, topk_rank_batch_ref

TILE = 1024   # positions per DFS tile (RT_TILE in topk_select.cuh)
GROUP = 32    # positions per group key (RT_GROUP)
# blocks a selection launch (here and in item_index) spreads a call's
# tiles over: about a wave of the card's 132 SMs
WORK_BLOCKS = 1024
# the fewest tiles a rank block takes: a block's first tile sorts every
# candidate it admits, later ones only those that beat the range's running
# k-th key
MIN_TILES = 4
# list elements (k keys per block) one call's lists may take
LIST_ELEMS = 1 << 22
_BIG = 2**30


def selection_grid(q: int, k: int) -> tuple[int, int]:
    """``(work_blocks, grid)`` of a selection launch: about
    ``WORK_BLOCKS`` blocks share the tiles read, plus one a query at most;
    every block keeps a list of k, and the lists stay within
    ``LIST_ELEMS``."""
    work_blocks = max(1, min(WORK_BLOCKS, LIST_ELEMS // k - q))
    return work_blocks, work_blocks + q


def scratch(size: int, dtype, dev):
    """An uninitialised device buffer of at least one element."""
    return torch.empty((max(size, 1),), dtype=dtype, device=dev)


def selection_lists(grid: int, k: int, dev) -> list:
    """The running lists of a selection launch: k keys and values a block,
    and their spill to global scratch when k is past a tile (shared memory
    holds a tile's)."""
    spill = grid * k if k > TILE else 0
    return [scratch(grid * k, torch.int64, dev),
            scratch(grid * k, torch.float32, dev),
            scratch(spill, torch.int64, dev),
            scratch(spill, torch.float32, dev)]


def launch_shape(q: int, k: int, n: int) -> dict:
    """Host-side sizes of one launch, from its shape alone (no device
    read): the selection grid (``work_blocks`` for the tiles plus one
    block a query at most), the hash table of ranges (a power of two at
    least ``2 q``), each range's tile list (``list_cap``: no range reads
    more than ``k + 2`` tiles below its seed, nor more than the trie's
    ``n_tiles``) and the 32-bit words of the plan scratch
    (``rank.cu::rank_scratch_words``)."""
    work_blocks, grid = selection_grid(q, k)
    table = 1 << (2 * q - 1).bit_length()
    n_tiles = -(-n // TILE)
    list_cap = min(k + 2, n_tiles)
    words = 2 * table + 2 * q + table + 1 + 6 * q + grid + q * list_cap
    return dict(work_blocks=work_blocks, grid=grid, table=table,
                n_tiles=n_tiles, list_cap=list_cap, words=words)


def metric_column_args(what, support, confidence, lift, n_transactions,
                       confidence_scale, lift_scale) -> tuple:
    """The eight leading arguments of a launch that widens metric columns
    (``_build._COLUMNS``): pointers, storage codes, dequant scalars.  The
    caller has checked device, rank and contiguity (``check_inputs``)."""
    sup_t, col_t = storage_codes(what, support, confidence, lift)
    return (
        support.data_ptr(), confidence.data_ptr(), lift.data_ptr(),
        sup_t, col_t, count_reciprocal(n_transactions),
        float(confidence_scale), float(lift_scale),
    )


def topk_rank_batch(
    support, confidence, lift, depth, los, his,
    *, k: int, metric: str = "confidence", min_depth: int = 1,
    n_transactions: int = 0, confidence_scale: float = 1.0,
    lift_scale: float = 1.0,
):
    """Top-k of every DFS range ``[los[q], his[q])``: ``(f32[Q, k],
    int32[Q, k])``."""
    dev = support.device
    dequant = dict(n_transactions=n_transactions,
                   confidence_scale=confidence_scale, lift_scale=lift_scale)
    if dev.type == "cpu":
        return topk_rank_batch_ref(
            support, confidence, lift, depth, los, his,
            k=k, metric=metric, min_depth=min_depth, **dequant,
        )
    if dev.type != "cuda":
        raise ValueError(f"topk_rank_batch: unsupported device {dev}")
    n, q, k = support.shape[0], los.shape[0], int(k)
    if n == 0 or k <= 0 or q == 0:
        return _empty_ranked(q, k, dev)
    # the kernel clamps each range to [0, n) itself
    los = los.to(torch.int32).contiguous()
    his = his.to(torch.int32).contiguous()
    _build.check_inputs(
        "topk_rank_batch", dev,
        support=(support, support.dtype, 1),
        confidence=(confidence, confidence.dtype, 1),
        lift=(lift, lift.dtype, 1), depth=(depth, torch.int32, 1),
        los=(los, torch.int32, 1), his=(his, torch.int32, 1),
    )
    columns = metric_column_args("topk_rank_batch", support, confidence,
                                 lift, **dequant)
    shape = launch_shape(q, k, n)
    # held here until the launch returns: the C side takes raw pointers;
    # the score column is padded to whole tiles (the selection reads a
    # tile four positions a thread)
    bufs = [
        scratch(shape["n_tiles"] * TILE, torch.float32, dev),
        scratch(shape["n_tiles"], torch.int64, dev),
        scratch(-(-n // GROUP), torch.int64, dev),
        scratch(shape["words"], torch.int32, dev),
    ]
    lists = selection_lists(shape["grid"], k, dev)
    vals = torch.empty((q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((q, k), dtype=torch.int32, device=dev)
    err = _build.lib("rank").topk_rank_batch_launch(
        *columns, depth.data_ptr(), n, los.data_ptr(), his.data_ptr(),
        q, k, metric_index(metric), int(min_depth), shape["table"],
        shape["list_cap"], MIN_TILES, shape["work_blocks"],
        *[b.data_ptr() for b in bufs], shape["words"],
        *[b.data_ptr() for b in lists],
        vals.data_ptr(), pos.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "topk_rank_batch")
    topk_rank_batch.launches += 1
    return vals, pos


topk_rank_batch.launches = 0


def ieee_amax_last(x: torch.Tensor) -> torch.Tensor:
    """The max over the last axis as ``jnp.max`` takes it: a NaN
    propagates with its own bits (the first one, where there are more),
    and +0.0 is above -0.0.  ``amax`` alone canonicalizes a NaN, or on
    some paths sets every bit, and keeps whichever zero it meets."""
    isnan = torch.isnan(x)
    first = isnan.to(torch.uint8).argmax(-1, keepdim=True)
    nan_bits = torch.gather(x, -1, first).squeeze(-1)
    mx = x.amax(-1)
    pos_zero = ((x == 0) & ~torch.signbit(x)).any(-1)
    mx = torch.where((mx == 0) & pos_zero, torch.zeros_like(mx), mx)
    return torch.where(isnan.any(-1), nan_bits, mx)


def ieee_maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max as ``jnp.maximum`` takes it: a NaN operand
    propagates with its own bits, and +0.0 is above -0.0."""
    m = torch.maximum(a, b)
    zeros = (a == 0) & (b == 0)
    m = torch.where(zeros & ~(torch.signbit(a) & torch.signbit(b)),
                    torch.zeros_like(m), m)
    return torch.where(torch.isnan(a), a, torch.where(torch.isnan(b), b, m))


def rank_merge(av, ap, tv, tp, kpad: int):
    """Merge two (value desc, pos asc)-sorted kpad-lists into the top
    kpad of their union by rank scatter; live positions must be distinct
    between the lists, ``-inf`` entries are empty.  The lists are
    ``[kpad]``, or ``[Q, kpad]`` for Q independent merges.  NaN and
    signed-zero values merge as the reference's do (``ieee_amax_last``,
    ``ieee_maximum``)."""
    lane = torch.arange(kpad, dtype=torch.int32, device=av.device)
    apk = torch.where(av > -torch.inf, ap, _BIG + lane)
    tpk = torch.where(tv > -torch.inf, tp, _BIG + kpad + lane)

    def precedes(v1, p1, v2, p2):
        return (v1 > v2) | ((v1 == v2) & (p1 < p2))

    # [..., other list's entry, own entry]
    rank_a = lane + precedes(
        tv[..., :, None], tpk[..., :, None], av[..., None, :],
        apk[..., None, :],
    ).sum(-2, dtype=torch.int32)
    rank_t = lane + precedes(
        av[..., :, None], apk[..., :, None], tv[..., None, :],
        tpk[..., None, :],
    ).sum(-2, dtype=torch.int32)
    hit_a = lane[:, None] == rank_a[..., None, :]
    hit_t = lane[:, None] == rank_t[..., None, :]
    nv = ieee_maximum(
        ieee_amax_last(torch.where(hit_a, av[..., None, :], -torch.inf)),
        ieee_amax_last(torch.where(hit_t, tv[..., None, :], -torch.inf)),
    )
    np_ = torch.maximum(
        torch.where(hit_a, ap[..., None, :], -1).amax(-1),
        torch.where(hit_t, tp[..., None, :], -1).amax(-1),
    )
    return nv, torch.where(nv > -torch.inf, np_, -1).to(torch.int32)
