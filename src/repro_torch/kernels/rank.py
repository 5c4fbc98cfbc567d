"""Segmented top-k rule ranking over the DFS layout.

``topk_rank_batch`` ranks Q DFS ranges ``[los[q], his[q])`` in one call:
the top-k of ``rank_score(metric)`` over each range, nodes at
``depth >= min_depth`` only, in ``jax.lax.top_k`` order (value desc,
position asc) with ``(-inf, -1)`` empty slots.  Because the trie is
DFS-contiguous, an antecedent-prefix subtree is one such range, and a
posting list in posting order is another.

On a CUDA tensor it launches the hand-written kernel in ``csrc/rank.cu``
(replacing the TPU kernel ``repro.kernels.rank.topk_rank_batch_pallas``);
on a CPU tensor it runs the plain version ``ref.topk_rank_batch_ref``.
The metric columns may be the compressed layout's quantized storage
(int32 support counts, bf16 or int8 confidence and lift): the kernel
widens them in its score pass, with ``n_transactions`` and the int8
scales, as the TPU kernel does.  ``rank_merge`` is the reference's k-best
list merge as a tensor op.
"""
from __future__ import annotations

import torch

from . import _build
from .metrics_inkernel import count_reciprocal, metric_index, storage_codes
from .ref import _empty_ranked, topk_rank_batch_ref

TILE = 1024   # positions per selection tile (RT_TILE in topk_select.cuh)
# blocks a selection launch aims for: enough to fill the card's 132 SMs
# several times over, few enough that each block's running top-k sees
# many tiles
TARGET_BLOCKS = 16384
# list elements the chunk lists of one launch may take (24 bytes each over
# the four scratch buffers); a large k gets fewer, longer chunks instead
SCRATCH_ELEMS = 1 << 24
_BIG = 2**30


def chunking(q: int, n_tiles: int, k: int) -> tuple:
    """``(n_chunks, tiles_per_chunk, list_len)``: how many blocks share one
    query's ``n_tiles`` tiles, each streaming a contiguous chunk of them
    and keeping its chunk's best ``list_len = min(k, chunk positions)``
    (``chunk_list_len`` in ``topk_select.cuh``).  The lists take at most
    ``SCRATCH_ELEMS`` elements, or one list per query when ``q * k`` alone
    is more."""
    n_tiles = max(int(n_tiles), 1)
    n_chunks = min(n_tiles, max(1, -(-TARGET_BLOCKS // q)),
                   max(1, SCRATCH_ELEMS // (q * k)))
    per = -(-n_tiles // n_chunks)
    return -(-n_tiles // per), per, min(k, per * TILE)


def scratch_elems(q: int, n_lists: int, kk: int, k: int) -> int:
    """Elements each of the two merge scratch buffers must hold: the chunk
    lists of ``kk`` and every level of ``topk_select.cuh``'s pairwise merge
    before the last."""
    cap = q * n_lists * kk
    n, length = n_lists, kk
    while (n + 1) // 2 > 1:
        n = (n + 1) // 2
        length = min(k, 2 * length)
        cap = max(cap, q * n * length)
    return cap


def _scratch(n: int, q: int, n_lists: int, kk: int, k: int, device):
    """The score column (``n``) and the two merge scratch buffers."""
    cap = scratch_elems(q, n_lists, kk, k)
    return (
        torch.empty((n,), dtype=torch.float32, device=device),
        torch.empty((cap,), dtype=torch.int64, device=device),
        torch.empty((cap,), dtype=torch.float32, device=device),
        torch.empty((cap,), dtype=torch.int64, device=device),
        torch.empty((cap,), dtype=torch.float32, device=device),
        cap,
    )


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
    los = los.to(torch.int32).clamp(0, n).contiguous()
    his = his.to(torch.int32).clamp(max=n).contiguous()
    _build.check_inputs(
        "topk_rank_batch", dev,
        support=(support, support.dtype, 1),
        confidence=(confidence, confidence.dtype, 1),
        lift=(lift, lift.dtype, 1), depth=(depth, torch.int32, 1),
        los=(los, torch.int32, 1), his=(his, torch.int32, 1),
    )
    columns = metric_column_args("topk_rank_batch", support, confidence,
                                 lift, **dequant)
    span = int((his - los).clamp(min=0).max())
    n_chunks, per_chunk, kk = chunking(q, -(-span // TILE), k)
    sc, ka, va, kb, vb, cap = _scratch(n, q, n_chunks, kk, k, dev)
    vals = torch.empty((q, k), dtype=torch.float32, device=dev)
    pos = torch.empty((q, k), dtype=torch.int32, device=dev)
    err = _build.lib("rank").topk_rank_batch_launch(
        *columns, depth.data_ptr(), n, los.data_ptr(), his.data_ptr(),
        q, k, metric_index(metric), int(min_depth), n_chunks, per_chunk,
        sc.data_ptr(), ka.data_ptr(), va.data_ptr(), kb.data_ptr(),
        vb.data_ptr(), cap,
        vals.data_ptr(), pos.data_ptr(), _build.stream_handle(dev),
    )
    _build.check(err, "topk_rank_batch")
    topk_rank_batch.launches += 1
    return vals, pos


topk_rank_batch.launches = 0


def rank_merge(av, ap, tv, tp, kpad: int):
    """Merge two (value desc, pos asc)-sorted kpad-lists into the top
    kpad of their union by rank scatter; live positions must be distinct
    between the lists, ``-inf`` entries are empty."""
    lane = torch.arange(kpad, dtype=torch.int32, device=av.device)
    apk = torch.where(av > -torch.inf, ap, _BIG + lane)
    tpk = torch.where(tv > -torch.inf, tp, _BIG + kpad + lane)

    def precedes(v1, p1, v2, p2):
        return (v1 > v2) | ((v1 == v2) & (p1 < p2))

    rank_a = lane + precedes(
        tv[:, None], tpk[:, None], av[None, :], apk[None, :]
    ).sum(0, dtype=torch.int32)
    rank_t = lane + precedes(
        av[:, None], apk[:, None], tv[None, :], tpk[None, :]
    ).sum(0, dtype=torch.int32)
    hit_a = lane[:, None] == rank_a[None, :]
    hit_t = lane[:, None] == rank_t[None, :]
    nv = torch.maximum(
        torch.where(hit_a, av[None, :], -torch.inf).amax(1),
        torch.where(hit_t, tv[None, :], -torch.inf).amax(1),
    )
    np_ = torch.maximum(
        torch.where(hit_a, ap[None, :], -1).amax(1),
        torch.where(hit_t, tp[None, :], -1).amax(1),
    )
    return nv, torch.where(nv > -torch.inf, np_, -1).to(torch.int32)
