"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, with ordinary tensor
operations, on any device.  A kernel wrapper runs its plain version only
for tensors that lie on the CPU; the tests hold these against the
reference's jnp oracles, and ``chip_smoke.py`` holds every kernel against
them on the card.

Ranked results follow ``jax.lax.top_k`` order: value descending, ties by
ascending position (a stable descending sort over ascending positions),
with ``(-inf, -1)`` in slots past the live count.

The ranking, membership, span-search and reduction versions take the
compressed layout's quantized storage columns (int32 support counts, bf16
or int8 confidence and lift) and widen them with
``metrics_inkernel.dequantize_metrics``, as their kernels do.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.array_trie import (
    bucket_edge_lookup, ieee_amax, span_step,
)

from .metrics_inkernel import compound_lift, dequantize_metrics, rank_score

# masked [rows, N] score block size the plain rankings materialize at once
_BLOCK_ELEMS = 1 << 24
# elements of each [rows, E] match block the plain full sweep materializes
# at once (a few bool and 4-byte blocks of it: ~0.5 GB at 2^26)
_SWEEP_ELEMS = 1 << 26
# elements of the [T, chunk] product (and of the [chunk, I] membership) the
# plain support count materializes at once: 256 MB of f32
_DENSE_ELEMS = 1 << 26


# ----------------------------------------------------------------------
# support counting: the reference's dense formulation
# ----------------------------------------------------------------------
def bitmaps_to_dense(bitmaps: torch.Tensor, n_transactions: int):
    """Vertical bitmaps (int32 ``[I, W]``, the uint32 words viewed signed)
    -> f32 ``[T, I]`` 0/1 transaction membership, ``T = n_transactions``;
    the padding bits of the last word are dropped."""
    n_items, n_words = bitmaps.shape
    shifts = torch.arange(32, dtype=torch.int32, device=bitmaps.device)
    bits = (bitmaps[:, :, None] >> shifts) & 1   # [I, W, 32], bit t of word
    dense = bits.reshape(n_items, n_words * 32)[:, :n_transactions]
    return dense.T.to(torch.float32)


def members_from_candidates(candidates: torch.Tensor, n_items: int):
    """``[C, K]`` padded item lists -> f32 ``[C, I]`` 0/1 membership: a
    row-indexed scatter-max, so a repeated item sets its column once and a
    negative entry anywhere in the row sets none."""
    c = candidates.shape[0]
    valid = candidates >= 0
    safe = torch.where(valid, candidates, 0).long()
    member = torch.zeros((c, n_items), dtype=torch.float32,
                         device=candidates.device)
    return member.scatter_reduce_(1, safe, valid.to(torch.float32), "amax")


def support_count_ref(dense_tx, member, lengths) -> torch.Tensor:
    """``counts[c] = |{t : <dense_tx[t], member[c]> == lengths[c]}|``: the
    reference's formulation (``repro.kernels.ref.support_count_ref``), an
    f32 product of the 0/1 matrices compared with the itemset size and
    summed over the T transactions, a bounded chunk of C at a time.  Exact:
    0/1 sums stay <= I < 2^24.  TF32 is switched off for the product (it
    would be exact on 0/1 too); ``lengths = -1`` marks a padding row."""
    t = dense_tx.shape[0]
    c, n_items = member.shape
    tx = dense_tx.to(torch.float32)
    lens = lengths.to(torch.float32)
    step = max(1, _DENSE_ELEMS // max(t, n_items, 1))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = [
            (tx @ member[c0:c0 + step].to(torch.float32).T
             == lens[None, c0:c0 + step]).sum(0, dtype=torch.int32)
            for c0 in range(0, c, step)
        ]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=member.device)
    return torch.cat(out)


def support_count_bitmap_ref(bitmaps, candidates, lengths,
                             n_transactions: int) -> torch.Tensor:
    """The plain version of ``support_count.support_count_bitmap``: the
    bitmaps unpacked to dense transactions, each chunk of candidate rows
    to its membership, compared with the row's distinct valid item count
    (``-1``, count 0, where ``lengths <= 0``).  A row with ``lengths > 0``
    and no valid item matches every transaction: Support(∅)."""
    dense = bitmaps_to_dense(bitmaps, n_transactions)
    n_items = bitmaps.shape[0]
    c = candidates.shape[0]
    step = max(1, _DENSE_ELEMS // max(dense.shape[0], n_items, 1))
    out = []
    for c0 in range(0, c, step):
        member = members_from_candidates(candidates[c0:c0 + step], n_items)
        distinct = member.sum(1).to(torch.int32)
        eff_len = torch.where(lengths[c0:c0 + step] > 0, distinct, -1)
        out.append(support_count_ref(dense, member, eff_len))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=bitmaps.device)
    return torch.cat(out)


def support_slots_ref(candidates, n_items: int):
    """The plain mirror of the support-count pre-pass
    (``support_mark_kernel`` and ``support_slot_kernel``): ``(largest id,
    D, slot_of, slot_item)``, the largest entry of the matrix (-1 when it
    has none), the number D of distinct valid ids, ``slot_of`` int32
    ``[I]`` (an id's slot in ascending id order, -1 for an id the matrix
    does not name) and its inverse ``slot_item`` int32 ``[D]``.  With an
    id ``>= n_items`` only the largest id is computed: D is 0 and the maps
    are None, as the kernel writes no slots then."""
    flat = candidates.reshape(-1)
    top = int(flat.max()) if flat.numel() else -1
    if top >= n_items:
        return top, 0, None, None
    named = torch.zeros((n_items,), dtype=torch.bool, device=flat.device)
    named[flat[flat >= 0].long()] = True
    slot_item = named.nonzero().flatten().to(torch.int32)
    slot_of = torch.full((n_items,), -1, dtype=torch.int32,
                         device=flat.device)
    slot_of[slot_item.long()] = torch.arange(
        slot_item.numel(), dtype=torch.int32, device=flat.device)
    return top, int(slot_item.numel()), slot_of, slot_item


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int64 holding 0..2^32-1), int64."""
    x = words - ((words >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def support_count_tiled_ref(bitmaps, candidates, lengths,
                            n_transactions: int, bw: int) -> torch.Tensor:
    """The plain mirror of the support-count kernel's plan: the slot map
    of ``support_slots_ref``, the D item rows and the mask row (ones, the
    tail mask at word W-1, zeros past W) cut into word tiles of ``bw``
    words (the last one zero-padded), each candidate's valid items' tile
    words ANDed (from ones, or from the mask row in the last tile), a
    partial popcount per tile, the partials summed; 0 where ``lengths <=
    0``.  Equals ``support_count_bitmap_ref`` for every ``bw >= 1``.
    Raises ``ValueError`` on an item id ``>= I``."""
    n_items, n_words = bitmaps.shape
    c, k = candidates.shape
    dev = bitmaps.device
    top, d, slot_of, slot_item = support_slots_ref(candidates, n_items)
    if top >= n_items:
        raise ValueError(f"item {top} out of range [0,{n_items})")
    counts = torch.zeros((c,), dtype=torch.int64, device=dev)
    if c == 0 or n_words == 0:
        return counts.to(torch.int32)
    tiles = -(-n_words // bw)
    ones = 0xFFFFFFFF
    # rows 0..D-1 the items by slot, D the mask row, D + 1 all ones (the
    # row an invalid entry reads, so that it changes nothing)
    rows = torch.zeros((d + 2, tiles * bw), dtype=torch.int64, device=dev)
    rows[:d, :n_words] = bitmaps[slot_item.long()].to(torch.int64) & ones
    rows[d, :n_words] = ones
    tail = int(n_transactions) % 32
    rows[d, n_words - 1] = (1 << tail) - 1 if tail else ones
    rows[d + 1] = ones
    lookup = torch.cat([slot_of.long(),
                        torch.tensor([d + 1], dtype=torch.int64, device=dev)])
    slots = lookup[torch.where(candidates >= 0, candidates, n_items).long()]
    for t in range(tiles):
        tile = rows[:, t * bw:(t + 1) * bw]
        last = t == tiles - 1
        acc = tile[d if last else d + 1].expand(c, bw).clone()
        for j in range(k):
            acc &= tile[slots[:, j]]
        counts += popcount32(acc).sum(1)
    return torch.where(lengths > 0, counts, 0).to(torch.int32)


def _empty_ranked(q: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    k = max(int(k), 0)
    return (
        torch.full((q, k), -torch.inf, dtype=torch.float32, device=device),
        torch.full((q, k), -1, dtype=torch.int32, device=device),
    )


def _ordered_topk(masked: torch.Tensor, k: int):
    """Top-k of each row by (value desc, position asc); -inf is empty."""
    rows, n = masked.shape
    vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    if k > n:
        pv, pi = _empty_ranked(rows, k - n, masked.device)
        vals, idx = torch.cat([vals, pv], 1), torch.cat([idx, pi], 1)
    return vals, torch.where(vals > -torch.inf, idx, -1)


def _rank_rows(score, row_mask, q: int, k: int):
    """Rank ``score`` under ``row_mask(r0, r1) -> bool[r1-r0, N]`` for Q
    rows, a bounded block of rows at a time."""
    n = score.shape[0]
    step = max(1, _BLOCK_ELEMS // n)
    vals, pos = [], []
    for r0 in range(0, q, step):
        r1 = min(q, r0 + step)
        masked = torch.where(row_mask(r0, r1), score[None, :], -torch.inf)
        v, p = _ordered_topk(masked, k)
        vals.append(v)
        pos.append(p)
    return torch.cat(vals), torch.cat(pos)


def topk_rank_batch_ref(
    support, confidence, lift, depth, los, his,
    *, k: int, metric: str = "confidence", min_depth: int = 1,
    n_transactions: int = 0, confidence_scale: float = 1.0,
    lift_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``rank_score(metric)`` over each DFS range ``[los[q],
    his[q])``, nodes at ``depth >= min_depth`` only: ``(f32[Q, k],
    int32[Q, k])``."""
    n = support.shape[0]
    q = los.shape[0]
    if n == 0 or k <= 0 or q == 0:
        return _empty_ranked(q, k, support.device)
    score = rank_score(metric, *dequantize_metrics(
        support, confidence, lift,
        n_transactions, confidence_scale, lift_scale))
    pos = torch.arange(n, dtype=torch.int32, device=support.device)
    los = los.to(torch.int32).clamp(min=0)[:, None]
    his = his.to(torch.int32).clamp(max=n)[:, None]
    live = depth >= min_depth
    return _rank_rows(
        score,
        lambda r0, r1: (pos >= los[r0:r1]) & (pos < his[r0:r1]) & live,
        q, k,
    )


def topk_rank_ref(support, confidence, lift, depth, lo, hi, *, k: int,
                  metric: str = "confidence", min_depth: int = 1, **dequant):
    """The single-range slice of ``topk_rank_batch_ref``."""
    dev = support.device
    vals, pos = topk_rank_batch_ref(
        support, confidence, lift, depth,
        torch.as_tensor(lo, dtype=torch.int32, device=dev).reshape(1),
        torch.as_tensor(hi, dtype=torch.int32, device=dev).reshape(1),
        k=k, metric=metric, min_depth=min_depth, **dequant,
    )
    return vals[0], pos[0]


# ----------------------------------------------------------------------
# the rank kernel's design, step by step (csrc/rank.cu)
# ----------------------------------------------------------------------
# The kernels' 64-bit key (topk_select.cuh::topk_key) in int64 with its top
# bit flipped, so that int64 order is the key's unsigned order: ascending
# in (score desc, position asc).  The empty key ~0 becomes the int64 max.
EMPTY_KEY = 2**63 - 1


def masked_scores_ref(support, confidence, lift, depth, *, metric: str,
                      min_depth: int, n_transactions: int = 0,
                      confidence_scale: float = 1.0,
                      lift_scale: float = 1.0) -> torch.Tensor:
    """The score pass's column: ``rank_score(metric)``, ``-inf`` below
    ``min_depth``."""
    score = rank_score(metric, *dequantize_metrics(
        support, confidence, lift,
        n_transactions, confidence_scale, lift_scale))
    return torch.where(depth >= min_depth, score, -torch.inf)


def topk_keys_ref(score: torch.Tensor) -> torch.Tensor:
    """Each position's key (``EMPTY_KEY`` for ``-inf``); +0.0 and -0.0
    share one."""
    s = torch.where(score == 0, torch.zeros_like(score), score)
    u = s.view(torch.int32).long() & 0xFFFFFFFF
    image = torch.where(u >= 2**31, u ^ 0xFFFFFFFF, u | 2**31)
    high = image ^ 0xFFFFFFFF
    pos = torch.arange(score.shape[0], dtype=torch.int64,
                       device=score.device)
    key = ((high - 2**31) << 32) + pos
    return torch.where(score == -torch.inf, EMPTY_KEY, key)


def tile_keys_ref(keys: torch.Tensor, tile: int) -> torch.Tensor:
    """The smallest key of every ``tile``-position tile (the last one
    partial): it bounds every position in the tile.  The kernel keeps
    these for its tiles and for its groups of 32 positions."""
    n_tiles = -(-keys.shape[0] // tile)
    pad = keys.new_full((n_tiles * tile - keys.shape[0],), EMPTY_KEY)
    return torch.cat([keys, pad]).view(n_tiles, tile).amin(1)


def clamp_ranges_ref(los, his, n: int):
    """Each range clamped to ``[0, n)``, and every empty one as
    ``[0, 0)``, as the kernel reads them (int64)."""
    lo = los.long().clamp(min=0)
    hi = his.long().clamp(max=n)
    empty = hi <= lo
    return torch.where(empty, 0, lo), torch.where(empty, 0, hi)


def dedup_ranges_ref(los, his, n: int):
    """``(lo, hi, inverse)``: the distinct clamped ranges and, per query,
    the index of its range; row ``inverse[i]`` of the distinct ranges'
    answers is query i's answer."""
    lo, hi = clamp_ranges_ref(los, his, n)
    pairs, inverse = torch.unique(torch.stack([lo, hi], 1), dim=0,
                                  return_inverse=True)
    return pairs[:, 0], pairs[:, 1], inverse


def seed_thresholds_ref(tile_keys, group_keys, lo, hi, k: int, tile: int,
                        group: int):
    """Per range, the strict threshold it starts from: one past the seed,
    the k-th smallest key of the tiles lying wholly inside ``[lo, hi)``
    when there are at least k of them, else of the groups lying wholly
    inside it when there are at least k of those; ``EMPTY_KEY`` without a
    seed or when the seed is the empty key.  The k keys up to the seed
    belong to k distinct live positions of the range, so its k-th best key
    is at most the seed."""
    out = []
    for a, b in zip(lo.tolist(), hi.tolist()):
        seed = EMPTY_KEY
        for keys, size in ((tile_keys, tile), (group_keys, group)):
            f0, f1 = -(-a // size), b // size
            if f1 - f0 >= k:
                seed = int(torch.kthvalue(keys[f0:f1], k).values)
                break
        out.append(EMPTY_KEY if seed == EMPTY_KEY else seed + 1)
    return torch.tensor(out, dtype=torch.int64, device=tile_keys.device)


def tiles_read_ref(tile_keys, lo, hi, thr, tile: int) -> list:
    """Per range, the tiles it reads, ascending: those meeting ``[lo,
    hi)`` whose key is below its threshold (at most ``k + 2``)."""
    out = []
    for a, b, t in zip(lo.tolist(), hi.tolist(), thr.tolist()):
        t1 = -(-b // tile) if b > a else a // tile
        idx = torch.arange(a // tile, t1, device=tile_keys.device)
        out.append(idx[tile_keys[idx] < t])
    return out


def plan_blocks_ref(tiles, min_tiles: int, work_blocks: int):
    """``topk_select.cuh::plan_blocks``: query i takes ``max(1,
    ceil(tiles[i] / P))`` blocks (none for ``tiles[i] < 0``), ``P =
    max(min_tiles, ceil(sum / work_blocks))``.  Returns ``(first,
    n_blocks, block_query)``; the kernel's grid is ``work_blocks + Q``
    blocks, the ones past the plan idle."""
    t = torch.as_tensor(tiles, dtype=torch.int64)
    per = max(min_tiles, -(-int(t.clamp(min=0).sum()) // work_blocks))
    nb = torch.where(t < 0, 0, ((t + per - 1) // per).clamp(min=1))
    first = torch.cumsum(nb, 0) - nb
    block_query = torch.repeat_interleave(
        torch.arange(t.shape[0], dtype=torch.int64), nb)
    return first, nb, block_query


def block_tiles_ref(read, n_blocks: int, block: int):
    """The slice of a range's tiles ``read`` that its ``block``-th block
    streams: the tiles split evenly, in order."""
    per = -(-read.shape[0] // n_blocks)
    return read[block * per:(block + 1) * per]


def topk_rank_planned_ref(
    support, confidence, lift, depth, los, his,
    *, k: int, metric: str = "confidence", min_depth: int = 1,
    tile: int, group: int, work_blocks: int, min_tiles: int,
    n_transactions: int = 0,
    confidence_scale: float = 1.0, lift_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``topk_rank_batch`` as ``csrc/rank.cu`` computes it, in plain
    PyTorch, the blocks run one after another (``group`` divides
    ``tile``): the distinct ranges, each range's seed and the tiles below
    it, the plan, each block's tiles
    (skipping a tile whose key is not below the range's running threshold,
    admitting keys below it, keeping its best k), the merge of a range's
    block lists, and the rows gathered back to every query.  It equals
    ``topk_rank_batch_ref``; the main path does not call it."""
    n, q = support.shape[0], los.shape[0]
    if n == 0 or k <= 0 or q == 0:
        return _empty_ranked(q, k, support.device)
    score = masked_scores_ref(
        support, confidence, lift, depth, metric=metric, min_depth=min_depth,
        n_transactions=n_transactions, confidence_scale=confidence_scale,
        lift_scale=lift_scale)
    keys = topk_keys_ref(score)
    tkeys = tile_keys_ref(keys, tile)
    lo, hi, inverse = dedup_ranges_ref(los, his, n)
    thr = seed_thresholds_ref(tkeys, tile_keys_ref(keys, group), lo, hi, k,
                              tile, group)
    read = tiles_read_ref(tkeys, lo, hi, thr, tile)
    first, nblocks, _ = plan_blocks_ref([r.shape[0] for r in read],
                                        min_tiles, work_blocks)
    pos = torch.arange(n, device=keys.device)
    rows = []
    for r in range(lo.shape[0]):
        shared = int(thr[r])
        lists = []
        for blk in range(int(nblocks[r])):
            own = keys.new_full((k,), EMPTY_KEY)
            for t in block_tiles_ref(read[r], int(nblocks[r]), blk).tolist():
                bound = min(shared, int(own[-1]))
                if int(tkeys[t]) >= bound:
                    continue
                span = slice(t * tile, min((t + 1) * tile, n))
                inside = (pos[span] >= lo[r]) & (pos[span] < hi[r])
                cand = keys[span][inside & (keys[span] < bound)]
                own = torch.sort(torch.cat([own, cand])).values[:k]
                if int(own[-1]) != EMPTY_KEY:
                    shared = min(shared, int(own[-1]))
            lists.append(own)
        rows.append(torch.sort(torch.cat(lists)).values[:k])
    best = torch.stack(rows)[inverse]
    live = best != EMPTY_KEY
    p = torch.where(live, best & 0xFFFFFFFF, 0)
    return (torch.where(live, score[p], -torch.inf),
            torch.where(live, p, -1).to(torch.int32))


def laminar_members(node_item, post_lo, post_hi, plos, phis, items,
                    role: str) -> torch.Tensor:
    """``bool[Q, N]``: which DFS positions involve each queried item, by the
    per-position test (consequent: ``node_item == item``; antecedent/any:
    the laminar count ``#(post_lo <= p) - #(post_hi <= p)`` over the
    item's posting slice ``[plos[q], phis[q])``, minus the node's own entry
    for the antecedent role)."""
    pos = torch.arange(node_item.shape[0], dtype=torch.int32,
                       device=node_item.device)
    self_hit = node_item[None, :] == items.to(torch.int32)[:, None]
    if role == "consequent":
        return self_hit
    cnt = torch.stack([
        torch.searchsorted(post_lo[a:b], pos, right=True)
        - torch.searchsorted(post_hi[a:b], pos, right=True)
        for a, b in zip(plos.tolist(), phis.tolist())
    ]) if plos.shape[0] else torch.zeros(
        (0, pos.shape[0]), dtype=torch.int64, device=pos.device)
    if role == "antecedent":
        cnt = cnt - self_hit.to(cnt.dtype)
    return cnt > 0


def member_ranges_ref(post_lo, post_hi, plos, phis, items, node_item,
                      role: str):
    """The same members in closed form, from the posting slices alone:
    ``(query, lo, hi)`` int64 rows, one per member range ``[lo, hi)``,
    ascending within each query.

    With an item's slice holding all its non-root nodes in DFS order
    (``post_lo`` ascending), laminar subtree ranges and ``post_hi``
    sorted within the slice, posting ``j`` is outermost iff ``j == plo``
    or ``post_hi[j-1] <= post_lo[j]``, and the outermost range opened at
    ``j`` ends at ``post_hi[j'-1]``, ``j'`` the next outermost posting
    (``phi`` if none).  Then any = the outermost ``[lo, hi)``,
    antecedent = the outermost ``(lo, hi)`` (empty ones dropped), and
    consequent = ``[p, p + 1)`` for each posting, plus position 0 when the
    root's ``node_item`` is the queried id (the item -1 of an absent
    query).  The membership kernel reads these members and no other
    position; the main path does not call this."""
    dev = post_lo.device
    plos, phis = plos.long(), phis.long()
    lens = (phis - plos).clamp(min=0)
    qid = torch.repeat_interleave(
        torch.arange(plos.shape[0], device=dev), lens)
    first = torch.repeat_interleave(plos, lens)
    slot0 = torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    j = first + torch.arange(qid.shape[0], device=dev) - slot0
    lo = post_lo[j].long()
    if role == "consequent":
        root = (items.to(torch.int32) == node_item[0]).nonzero()[:, 0] \
            if node_item.shape[0] else qid[:0]
        qid = torch.cat([root, qid])
        lo = torch.cat([torch.zeros_like(root), lo])
        order = torch.sort(qid, stable=True).indices
        return qid[order], lo[order], lo[order] + 1
    prev_end = post_hi[(j - 1).clamp(min=0)].long()
    opens = ((j == first) | (prev_end <= lo)).nonzero()[:, 0]
    qo = qid[opens]
    tail = min(opens.shape[0], 1)
    # the next outermost posting of the same query, else the slice's end
    nxt = torch.cat([opens[1:], opens.new_full((tail,), qid.shape[0])])
    last = torch.cat([qo[1:] != qo[:-1],
                      torch.ones((tail,), dtype=torch.bool, device=dev)])
    end_j = torch.where(last, phis[qo], torch.cat([j, j[:1]])[nxt])
    hi = post_hi[end_j - 1].long()
    lo = lo[opens] + (1 if role == "antecedent" else 0)
    keep = hi > lo
    return qo[keep], lo[keep], hi[keep]


def rules_with_ref(
    support, confidence, lift, depth, node_item, post_lo, post_hi,
    plos, phis, items,
    *, k: int, metric: str = "confidence", min_depth: int = 1,
    role: str = "any", n_transactions: int = 0,
    confidence_scale: float = 1.0, lift_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the rules involving each queried item: membership by
    ``role`` as ``laminar_members`` tests it, nodes at ``depth >=
    min_depth`` only."""
    if role not in ("consequent", "antecedent", "any"):
        raise ValueError(f"unknown role {role!r}")
    n = support.shape[0]
    q = plos.shape[0]
    if n == 0 or k <= 0 or q == 0:
        return _empty_ranked(q, k, support.device)
    score = rank_score(metric, *dequantize_metrics(
        support, confidence, lift,
        n_transactions, confidence_scale, lift_scale))
    live = depth >= min_depth
    plos, phis = plos.cpu(), phis.cpu()  # the slices are read on the host
    return _rank_rows(
        score,
        lambda r0, r1: laminar_members(
            node_item, post_lo, post_hi, plos[r0:r1], phis[r0:r1],
            items[r0:r1], role) & live,
        q, k,
    )


def not_found(q: int, device) -> Dict[str, torch.Tensor]:
    """Rule-search result of Q absent rules (empty trie, width 0)."""
    def z():
        return torch.zeros((q,), dtype=torch.float32, device=device)

    return {
        "found": torch.zeros((q,), dtype=torch.bool, device=device),
        "node": torch.full((q,), -1, dtype=torch.int32, device=device),
        "confidence": z(), "support": z(), "lift": z(), "con_support": z(),
    }


def sweep_not_found(q: int, device) -> Dict[str, torch.Tensor]:
    """Full-sweep result of Q absent rules (no edges, width 0): node
    metrics only, ``node_lift`` in place of lift."""
    out = not_found(q, device)
    out["node_lift"] = out.pop("lift")
    del out["con_support"]
    return out


def rule_search_sweep_ref(
    edge_parent, edge_item, edge_child, edge_conf, edge_sup, edge_lift,
    queries, ant_len,
) -> Dict[str, torch.Tensor]:
    """The seed full-sweep search: each step matches every query row's
    ``(node, item)`` against the whole edge table, takes the max child and
    the max of each edge metric over the matches (0 and -1 when none;
    the canonical quiet NaN when a matched value is NaN), and advances the
    rows that hit.  Node metrics only: found, node,
    confidence (the product over the steps at or past ``ant_len``),
    support and node_lift, each ``[Q]``.  The ``[rows, E]`` match blocks
    are made a bounded chunk of rows at a time; the arithmetic is the
    reference's (``repro.kernels.ref.rule_search_ref``)."""
    queries = queries.to(torch.int32)
    ant_len = ant_len.to(torch.int32)
    q, width = queries.shape
    dev = queries.device
    e = edge_parent.shape[0]
    if e == 0 or width == 0:
        return sweep_not_found(q, dev)
    step = max(1, _SWEEP_ELEMS // e)
    parts = [
        _sweep_rows(edge_parent, edge_item, edge_child, edge_conf, edge_sup,
                    edge_lift, queries[r0:r0 + step], ant_len[r0:r0 + step])
        for r0 in range(0, max(q, 1), step)
    ]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def _sweep_rows(ep, ei, ec, ecf, esp, elf, queries, ant_len):
    """``rule_search_sweep_ref`` over one chunk of rows."""
    q, width = queries.shape
    dev = queries.device
    zf = torch.zeros((q,), dtype=torch.float32, device=dev)
    node = torch.zeros((q,), dtype=torch.int32, device=dev)
    ok = torch.ones((q,), dtype=torch.bool, device=dev)
    conf = torch.ones((q,), dtype=torch.float32, device=dev)
    sup, nlift = zf, zf
    neg1 = torch.full((q,), -1, dtype=torch.int32, device=dev)

    def best(match, col, fill, init):
        picked = torch.where(match, col[None, :], fill)
        return torch.maximum(init, picked.amax(dim=1))

    def best_metric(match, col):
        # the NaN-propagating max over {0.0} and the matches, as the bits
        # metric_key_ref gives it: no device's choice among NaNs or zeros
        # reaches the answer
        return metric_key_ref(best(match, col, 0.0, zf)).view(torch.float32)

    for s in range(width):
        item = queries[:, s]
        active = (item >= 0) & ok
        qp = torch.where(active, node, -9)
        match = (ep[None, :] == qp[:, None]) & (ei[None, :] == item[:, None])
        child = best(match, ec, -1, neg1)
        e_conf = best_metric(match, ecf)
        e_sup = best_metric(match, esp)
        e_lift = best_metric(match, elf)
        adv = active & (child >= 0)
        ok = torch.where(active, child >= 0, ok)
        node = torch.where(adv, child, node)
        conf = torch.where(adv & (s >= ant_len), conf * e_conf, conf)
        sup = torch.where(adv, e_sup, sup)
        nlift = torch.where(adv, e_lift, nlift)

    found = ok & (node > 0)
    return {
        "found": found,
        "node": torch.where(found, node, -1).to(torch.int32),
        "confidence": torch.where(found, conf, 0.0),
        "support": torch.where(found, sup, 0.0),
        "node_lift": torch.where(found, nlift, 0.0),
    }


# ----------------------------------------------------------------------
# the full sweep as csrc/rule_search.cu computes it
# ----------------------------------------------------------------------
SWEEP_ROWS = 32       # rows a warp holds: a tile (SW_R)
SWEEP_CHUNK = 128     # edges a warp reads at once, 4 a lane (SW_CHUNK)
CANON_NAN_BITS = 0x7FC00000
_U32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """``h * c`` mod 2^32 for int64 ``h`` in [0, 2^32), with no int64
    overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def sweep_fingerprint_ref(parent, item):
    """``rule_search.cu::sweep_fp``: the 32-bit fingerprint of each
    ``(parent, item)`` pair (int64 values in [0, 2^32)).  Equal pairs have
    equal fingerprints; the kernel checks the exact pair on a match, so
    two pairs that share one (``parent * 0x9E3779B1 + item`` equal mod
    2^32) never change an answer."""
    h = (_mul32(parent.long() & _U32, 0x9E3779B1) + (item.long() & _U32)) \
        & _U32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def metric_key_ref(values):
    """``rule_search.cu::metric_key``: int32 keys that order as the f32
    values do over {0.0} and the values, one key per answer: the bits of a
    value above 0, ``CANON_NAN_BITS`` for any NaN, else 0 (+0.0).  The
    max of keys is the NaN-propagating max, and its bits, in any order."""
    keys = torch.where(values > 0, values.view(torch.int32), 0)
    return torch.where(torch.isnan(values), CANON_NAN_BITS, keys) \
        .to(torch.int32)


def sweep_active_rows_ref(items, ok):
    """The rows active at a step, ascending: still on the trie (``ok``)
    with an item (``>= 0``) in the step's column.  The kernel's list holds
    the same rows in another order, which no answer depends on."""
    return torch.nonzero(ok & (items >= 0)).flatten()


def sweep_plan_ref(n_active: int, n_chunks: int, warps: int) -> dict:
    """A match launch's split of its step: ``n_tiles`` tiles of
    ``SWEEP_ROWS`` active rows, each against ``n_chunks`` chunks, the
    ``total`` (tile, chunk) units in tile-major order, and ``per`` units a
    warp, every warp of the grid the same share."""
    n_tiles = -(-int(n_active) // SWEEP_ROWS)
    total = n_tiles * int(n_chunks)
    return {"n_tiles": n_tiles, "total": total,
            "per": -(-total // int(warps))}


def sweep_segments_ref(n_active: int, n_chunks: int, warps: int) -> list:
    """Per warp of the match grid, its ``(tile, c0, c1)`` segments: a
    tile's rows against chunks ``[c0, c1)``; one or two, or more when a
    warp's share passes whole tiles."""
    plan = sweep_plan_ref(n_active, n_chunks, warps)
    out = []
    for g in range(int(warps)):
        u = g * plan["per"]
        u_end = min(plan["total"], u + plan["per"])
        segs = []
        while u < u_end:
            t = u // n_chunks
            c0 = u - t * n_chunks
            c1 = min(n_chunks, c0 + u_end - u)
            segs.append((t, c0, c1))
            u += c1 - c0
        out.append(segs)
    return out


def rule_search_sweep_split_ref(
    edge_parent, edge_item, edge_child, edge_conf, edge_sup, edge_lift,
    queries, ant_len, *, warps: int,
) -> Dict[str, torch.Tensor]:
    """``rule_search_sweep`` as ``csrc/rule_search.cu`` computes it on a
    grid of ``warps`` warps, in plain PyTorch: the edge fingerprints, per
    step the active rows (``sweep_active_rows_ref``), each warp's
    segments (``sweep_segments_ref``), the fingerprint compares of a
    segment, the exact pair at each fingerprint hit (padding slots past E
    rejected), the true matches merged into the rows' slots by max (the
    child, and the metrics as ``metric_key_ref`` keys), and the rows
    advanced from their slots.  It equals ``rule_search_sweep_ref``; the
    main path does not call it."""
    queries = queries.to(torch.int32)
    ant_len = ant_len.to(torch.int32)
    q, width = queries.shape
    dev = queries.device
    e = edge_parent.shape[0]
    if e == 0 or width == 0:
        return sweep_not_found(q, dev)
    n_chunks = -(-e // SWEEP_CHUNK)
    fp = torch.zeros((n_chunks * SWEEP_CHUNK,), dtype=torch.int64,
                     device=dev)
    fp[:e] = sweep_fingerprint_ref(edge_parent, edge_item)
    keys = [metric_key_ref(c) for c in (edge_conf, edge_sup, edge_lift)]
    node = torch.zeros((q,), dtype=torch.int32, device=dev)
    ok = torch.ones((q,), dtype=torch.bool, device=dev)
    conf = torch.ones((q,), dtype=torch.float32, device=dev)
    sup = torch.zeros((q,), dtype=torch.float32, device=dev)
    nlift = torch.zeros((q,), dtype=torch.float32, device=dev)
    for s in range(width):
        item = queries[:, s]
        rows = sweep_active_rows_ref(item, ok)
        a_node, a_item = node[rows], item[rows]
        a_fp = sweep_fingerprint_ref(a_node, a_item)
        child = torch.full((q,), -1, dtype=torch.int32, device=dev)
        slots = [torch.zeros((q,), dtype=torch.int32, device=dev)
                 for _ in keys]
        for segs in sweep_segments_ref(rows.numel(), n_chunks, warps):
            for t, c0, c1 in segs:
                tile = torch.arange(t * SWEEP_ROWS,
                                    min((t + 1) * SWEEP_ROWS, rows.numel()),
                                    device=dev)
                x = torch.arange(c0 * SWEEP_CHUNK, c1 * SWEEP_CHUNK,
                                 device=dev)
                ti, xi = torch.nonzero(
                    a_fp[tile][:, None] == fp[x][None, :], as_tuple=True)
                a, xs = tile[ti], x[xi]
                real = xs < e
                a, xs = a[real], xs[real]
                exact = (edge_parent[xs] == a_node[a]) \
                    & (edge_item[xs] == a_item[a])
                a, xs = rows[a[exact]], xs[exact]
                child.scatter_reduce_(0, a, edge_child[xs], "amax")
                for slot, key in zip(slots, keys):
                    slot.scatter_reduce_(0, a, key[xs], "amax")
        active = torch.zeros((q,), dtype=torch.bool, device=dev)
        active[rows] = True
        hit = active & (child >= 0)
        ok = torch.where(active, child >= 0, ok)
        node = torch.where(hit, child, node)
        kc, ks, kl = (slot.view(torch.float32) for slot in slots)
        conf = torch.where(hit & (s >= ant_len), conf * kc, conf)
        sup = torch.where(hit, ks, sup)
        nlift = torch.where(hit, kl, nlift)
    found = ok & (node > 0)
    return {
        "found": found,
        "node": torch.where(found, node, -1).to(torch.int32),
        "confidence": torch.where(found, conf, 0.0),
        "support": torch.where(found, sup, 0.0),
        "node_lift": torch.where(found, nlift, 0.0),
    }


def rule_search_fused_ref(
    child_offsets, edge_item, edge_child, edge_conf, edge_sup, edge_lift,
    queries, ant_len, max_fanout: int,
) -> Dict[str, torch.Tensor]:
    """Full-metric rule search over the CSR buckets: the main walk, the
    root-anchored consequent walk, and the Eq. 1-4 compound lift.
    Returns found, node, support, confidence, lift and con_support."""
    queries = queries.to(torch.int32)
    ant_len = ant_len.to(torch.int32)
    q, width = queries.shape
    dev = queries.device
    if edge_item.shape[0] == 0 or width == 0:
        return not_found(q, dev)
    zf = torch.zeros((q,), dtype=torch.float32, device=dev)

    def step(node, item):
        j = bucket_edge_lookup(
            child_offsets, edge_item, max_fanout, node, item
        )
        return j >= 0, j.clamp(min=0).long()

    node = torch.zeros((q,), dtype=torch.int32, device=dev)
    ok = torch.ones((q,), dtype=torch.bool, device=dev)
    conf = torch.ones((q,), dtype=torch.float32, device=dev)
    sup, nlift = zf, zf
    cnode, cok, csup = node, ok, zf
    for s in range(width):
        item = queries[:, s]
        has_item = item >= 0
        in_cons = s >= ant_len

        active = has_item & ok
        hit, j = step(torch.where(active, node, 0), item)
        adv = active & hit
        ok = torch.where(active, hit, ok)
        node = torch.where(adv, edge_child[j], node)
        conf = torch.where(adv & in_cons, conf * edge_conf[j], conf)
        sup = torch.where(adv, edge_sup[j], sup)
        nlift = torch.where(adv, edge_lift[j], nlift)

        c_active = has_item & in_cons & cok
        chit, cj = step(torch.where(c_active, cnode, 0), item)
        cadv = c_active & chit
        cok = torch.where(c_active, chit, cok)
        cnode = torch.where(cadv, edge_child[cj], cnode)
        csup = torch.where(cadv, edge_sup[cj], csup)

    found = ok & (node > 0)
    conf = torch.where(found, conf, 0.0)
    con_sup = torch.where(cok & (cnode > 0), csup, 0.0)
    seq_len = (queries >= 0).sum(dim=1, dtype=torch.int32)
    single = (seq_len - ant_len) == 1
    return {
        "found": found,
        "node": torch.where(found, node, -1).to(torch.int32),
        "confidence": conf,
        "support": torch.where(found, sup, 0.0),
        "lift": compound_lift(
            found, single, torch.where(found, nlift, 0.0), conf, con_sup
        ),
        "con_support": con_sup,
    }


def rule_search_span_ref(
    child_offsets, edge_item, edge_pos, edge_span, edge_tail,
    node_item, support, confidence, lift, queries, ant_len,
    max_fanout: int = 0, n_transactions: int = 0,
    confidence_scale: float = 1.0, lift_scale: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Rule search on the compressed layout: per query the ``(pos, rem,
    ctail)`` state of the main walk and of the root-anchored consequent
    walk.  Inside a span (``rem > 0``) a step matches the item column at
    ``pos + 1``; at a CSR node it searches the compressed bucket of
    ``ctail`` (the reference's oracle matches the whole compressed edge
    table instead; a bucket holds each item once, so both find the same
    edge).  The metric columns are position-indexed and may be quantized.
    Returns found, ``pos`` (a DFS position, -1 when absent), support,
    confidence, lift and con_support."""
    queries = queries.to(torch.int32)
    ant_len = ant_len.to(torch.int32)
    q, width = queries.shape
    dev = queries.device
    if edge_item.shape[0] == 0 or width == 0:
        out = not_found(q, dev)
        out["pos"] = out.pop("node")
        return out
    sup_col, conf_col, lift_col = dequantize_metrics(
        support, confidence, lift,
        n_transactions, confidence_scale, lift_scale)

    def step(pos, rem, ctail, item):
        return span_step(node_item, child_offsets, edge_item, edge_pos,
                         edge_span, edge_tail, max_fanout, pos, rem, ctail,
                         item)

    z = torch.zeros((q,), dtype=torch.int32, device=dev)
    ok0 = torch.ones((q,), dtype=torch.bool, device=dev)
    pos, rem, ctail, ok = z, z, z, ok0
    cpos, crem, cctail, cok = z, z, z, ok0
    conf = torch.ones((q,), dtype=torch.float32, device=dev)
    for s in range(width):
        item = queries[:, s]
        has_item = item >= 0
        in_cons = s >= ant_len

        active = has_item & ok
        pos2, rem2, ctail2, hit = step(pos, rem, ctail, item)
        adv = active & hit
        ok = torch.where(active, hit, ok)
        conf = torch.where(adv & in_cons, conf * conf_col[pos2.long()], conf)
        pos = torch.where(adv, pos2, pos)
        rem = torch.where(adv, rem2, rem)
        ctail = torch.where(adv, ctail2, ctail)

        c_active = has_item & in_cons & cok
        cp2, cr2, ct2, chit = step(cpos, crem, cctail, item)
        cadv = c_active & chit
        cok = torch.where(c_active, chit, cok)
        cpos = torch.where(cadv, cp2, cpos)
        crem = torch.where(cadv, cr2, crem)
        cctail = torch.where(cadv, ct2, cctail)

    found = ok & (pos > 0)
    conf = torch.where(found, conf, 0.0)
    con_sup = torch.where(cok & (cpos > 0), sup_col[cpos.long()], 0.0)
    seq_len = (queries >= 0).sum(dim=1, dtype=torch.int32)
    single = (seq_len - ant_len) == 1
    pl = pos.long()
    return {
        "found": found,
        "pos": torch.where(found, pos, -1).to(torch.int32),
        "confidence": conf,
        "support": torch.where(found, sup_col[pl], 0.0),
        "lift": compound_lift(
            found, single, torch.where(found, lift_col[pl], 0.0), conf,
            con_sup,
        ),
        "con_support": con_sup,
    }


# ----------------------------------------------------------------------
# the descent searches as csrc/rule_search.cu computes them
# ----------------------------------------------------------------------
SEARCH_GROUP = 8         # lanes of one walk (RS_GROUP)
SEARCH_ROOT_CAP = 256    # root edges each block stages (RS_ROOT_CAP)


def group_probe_ref(edge_item, lo, hi, items, group: int = SEARCH_GROUP):
    """``rule_search.cu::group_find`` over a batch of walks: per walk the
    first index ``j`` in ``[lo, hi)`` with ``edge_item[j] == item`` (-1
    when none), and the rounds of loads the group spends.  While the range
    is wider than ``4 * group - 3`` items, a pivot round reads ``4 * group``
    pivots ``s = ceil(n / (4 * group + 1))`` apart and keeps the ``s``-wide
    slice after the last pivot below the item; then one round reads what
    is left (none for an empty range).  On an item-sorted range the answer
    is the binary search's (``array_trie.bucket_edge_lookup``)."""
    rnd = 4 * group
    a = lo.to(torch.int64).clone()
    b = hi.to(torch.int64).clone()
    items = items.to(torch.int32)
    rounds = torch.zeros_like(a)
    if edge_item.shape[0] == 0:
        return torch.full_like(items, -1), rounds
    pivots = torch.arange(1, rnd + 1, device=a.device)
    while True:
        wide = (b - a) > rnd - 3
        if not bool(wide.any()):
            break
        aw, bw = a[wide], b[wide]
        s = (bw - aw + rnd) // (rnd + 1)
        x = torch.minimum(aw[:, None] + pivots[None] * s[:, None] - 1,
                          bw[:, None] - 1)
        cnt = (edge_item[x] < items[wide][:, None]).sum(1)
        a[wide] = torch.minimum(aw + cnt * s, bw)
        b[wide] = torch.minimum(aw + (cnt + 1) * s, bw)
        rounds[wide] += 1
    idx = a[:, None] + torch.arange(rnd - 3, device=a.device)[None]
    hit = (idx < b[:, None]) & (
        edge_item[idx.clamp(max=edge_item.shape[0] - 1)] == items[:, None])
    first = torch.where(hit.any(1), a + hit.to(torch.int8).argmax(1), -1)
    return first.to(torch.int32), rounds + (b > a).to(torch.int64)


def _root_staged(child_offsets, e: int, root_cap: int) -> bool:
    """Whether the kernels take the root's bucket from the edges each block
    stages: the root's edges start the table and fit the cap."""
    return int(child_offsets[0]) == 0 and \
        int(child_offsets[1]) <= min(e, root_cap)


def _walk_items(queries, ant_len, consequent: bool):
    """The items a walk takes (the valid ones; for the consequent walk
    those at or past ant_len), as a bool ``[Q, L]``."""
    take = queries >= 0
    if consequent:
        cols = torch.arange(queries.shape[1], device=queries.device)
        take = take & (cols[None] >= ant_len[:, None])
    return take


def fused_walk_ref(child_offsets, edge_item, edge_child, edge_conf,
                   edge_sup, edge_lift, queries, ant_len, *,
                   consequent: bool, group: int = SEARCH_GROUP,
                   root_cap: int = SEARCH_ROOT_CAP):
    """One of the fused kernel's two walks over every row: the full path,
    or (``consequent``) the consequent items alone from the root.  Returns
    ``(node, ok, conf, sup, lift, rounds)``: the confidence product over
    the consequent steps and the lift only on the full walk, and per row
    the rounds of device loads on the walk's chain (the row's round, and
    per step the bucket bounds, the probe's rounds and the found edge's
    child and metrics, none at a root the block staged)."""
    q, width = queries.shape
    dev = queries.device
    staged = _root_staged(child_offsets, edge_item.shape[0], root_cap)
    take = _walk_items(queries, ant_len, consequent)
    node = torch.zeros((q,), dtype=torch.int32, device=dev)
    ok = torch.ones((q,), dtype=torch.bool, device=dev)
    conf = torch.ones((q,), dtype=torch.float32, device=dev)
    sup = torch.zeros((q,), dtype=torch.float32, device=dev)
    lift = torch.zeros((q,), dtype=torch.float32, device=dev)
    rounds = torch.ones((q,), dtype=torch.int64, device=dev)
    for s in range(width):
        item = queries[:, s]
        active = take[:, s] & ok
        nl = node.long()
        j, probe = group_probe_ref(edge_item, child_offsets[nl],
                                   child_offsets[nl + 1], item, group)
        hit = j >= 0
        rounds += torch.where(active & ~(staged & (node == 0)),
                              1 + probe + hit.to(torch.int64), 0)
        adv = active & hit
        ok = torch.where(active, hit, ok)
        jc = j.clamp(min=0).long()
        node = torch.where(adv, edge_child[jc], node)
        sup = torch.where(adv, edge_sup[jc], sup)
        if not consequent:
            conf = torch.where(adv & (s >= ant_len), conf * edge_conf[jc],
                               conf)
            lift = torch.where(adv, edge_lift[jc], lift)
    return node, ok, conf, sup, lift, rounds


def rule_search_fused_group_ref(
    child_offsets, edge_item, edge_child, edge_conf, edge_sup, edge_lift,
    queries, ant_len, *, group: int = SEARCH_GROUP,
    root_cap: int = SEARCH_ROOT_CAP,
):
    """``rule_search_fused`` as ``csrc/rule_search.cu`` computes it, in
    plain PyTorch: the two walks apart (``fused_walk_ref``), each bucket
    by ``group_probe_ref``, met at the end for the Eq. 1-4 compound lift.
    Returns ``(out, rounds)``: ``out`` equals ``rule_search_fused_ref``'s,
    ``rounds`` is each row's chain, the longer walk's.  The main path does
    not call it."""
    queries = queries.to(torch.int32)
    ant_len = ant_len.to(torch.int32)
    q, width = queries.shape
    dev = queries.device
    if edge_item.shape[0] == 0 or width == 0:
        return not_found(q, dev), torch.zeros((q,), dtype=torch.int64,
                                              device=dev)
    args = (child_offsets, edge_item, edge_child, edge_conf, edge_sup,
            edge_lift, queries, ant_len)
    kw = dict(group=group, root_cap=root_cap)
    node, ok, conf, sup, lift, rounds = fused_walk_ref(
        *args, consequent=False, **kw)
    cnode, cok, _, csup, _, crounds = fused_walk_ref(
        *args, consequent=True, **kw)
    found = ok & (node > 0)
    conf = torch.where(found, conf, 0.0)
    con_sup = torch.where(cok & (cnode > 0), csup, 0.0)
    single = ((queries >= 0).sum(1, dtype=torch.int32) - ant_len) == 1
    out = {
        "found": found,
        "node": torch.where(found, node, -1).to(torch.int32),
        "confidence": conf,
        "support": torch.where(found, sup, 0.0),
        "lift": compound_lift(found, single, torch.where(found, lift, 0.0),
                              conf, con_sup),
        "con_support": con_sup,
    }
    return out, torch.maximum(rounds, crounds)


def span_walk_ref(child_offsets, edge_item, edge_pos, edge_span, edge_tail,
                  node_item, conf_col, queries, ant_len, *,
                  consequent: bool, group: int = SEARCH_GROUP,
                  root_cap: int = SEARCH_ROOT_CAP):
    """One of the span kernel's two walks over every row on the
    compressed layout, ``conf_col`` the widened confidence column.
    Returns ``(pos, ok, conf, rounds)``.  Inside a span the kernel takes
    the walk's next ``m = min(rem, items left in the row's chunk of
    group columns)`` items in one round (the chunk holds at most ``group``
    of them) and advances by the matching prefix; here they are single
    steps, and a round is counted where such a run starts.  A CSR step
    costs the bucket bounds, the probe's rounds and the found edge's
    columns (none at a root the block staged), and a walk that ends on a
    node gathers its support there (one more round)."""
    q, width = queries.shape
    dev = queries.device
    n = node_item.shape[0]
    staged = _root_staged(child_offsets, edge_item.shape[0], root_cap)
    take = _walk_items(queries, ant_len, consequent)
    # the walk's items left in each chunk of `group` columns, from s on
    left = torch.zeros((q, width), dtype=torch.int64, device=dev)
    for c0 in range(0, width, group):
        part = take[:, c0:c0 + group].to(torch.int64)
        left[:, c0:c0 + group] = part.flip(1).cumsum(1).flip(1)
    z = torch.zeros((q,), dtype=torch.int32, device=dev)
    pos, rem, ctail = z, z, z
    ok = torch.ones((q,), dtype=torch.bool, device=dev)
    conf = torch.ones((q,), dtype=torch.float32, device=dev)
    rounds = torch.ones((q,), dtype=torch.int64, device=dev)
    run_left = torch.zeros((q,), dtype=torch.int64, device=dev)
    for s in range(width):
        item = queries[:, s]
        active = take[:, s] & ok
        in_span = rem > 0
        span_hit = in_span & (node_item[(pos + 1).clamp(max=n - 1).long()]
                              == item)
        starts = active & in_span & (run_left == 0)
        rounds += starts.to(torch.int64)
        run_left = torch.where(
            active & in_span,
            torch.where(starts, torch.minimum(rem.long(), left[:, s]),
                        run_left) - 1,
            run_left)
        tl = ctail.long()
        j, probe = group_probe_ref(edge_item, child_offsets[tl],
                                   child_offsets[tl + 1], item, group)
        edge_hit = ~in_span & (j >= 0)
        csr = active & ~in_span & ~(staged & (ctail == 0))
        rounds += torch.where(csr, 1 + probe + (j >= 0).to(torch.int64), 0)
        hit = span_hit | edge_hit
        adv = active & hit
        jc = j.clamp(min=0).long()
        pos2 = torch.where(span_hit, pos + 1, edge_pos[jc])
        rem2 = torch.where(span_hit, rem - 1, edge_span[jc])
        ok = torch.where(active, hit, ok)
        if not consequent:
            conf = torch.where(adv & (s >= ant_len),
                               conf * conf_col[pos2.long()], conf)
        pos = torch.where(adv, pos2, pos)
        rem = torch.where(adv, rem2, rem)
        ctail = torch.where(adv & edge_hit, edge_tail[jc], ctail)
    rounds += (ok & (pos > 0)).to(torch.int64)
    return pos, ok, conf, rounds


def rule_search_span_group_ref(
    child_offsets, edge_item, edge_pos, edge_span, edge_tail, node_item,
    support, confidence, lift, queries, ant_len, *,
    n_transactions: int = 0, confidence_scale: float = 1.0,
    lift_scale: float = 1.0, group: int = SEARCH_GROUP,
    root_cap: int = SEARCH_ROOT_CAP,
):
    """``rule_search_span`` as ``csrc/rule_search.cu`` computes it, in
    plain PyTorch: the two walks apart (``span_walk_ref``), met at the end.
    Returns ``(out, rounds)``: ``out`` equals ``rule_search_span_ref``'s,
    ``rounds`` is each row's chain, the longer walk's.  The main path does
    not call it."""
    queries = queries.to(torch.int32)
    ant_len = ant_len.to(torch.int32)
    q, width = queries.shape
    dev = queries.device
    if edge_item.shape[0] == 0 or width == 0:
        out = not_found(q, dev)
        out["pos"] = out.pop("node")
        return out, torch.zeros((q,), dtype=torch.int64, device=dev)
    sup_col, conf_col, lift_col = dequantize_metrics(
        support, confidence, lift,
        n_transactions, confidence_scale, lift_scale)
    args = (child_offsets, edge_item, edge_pos, edge_span, edge_tail,
            node_item, conf_col, queries, ant_len)
    kw = dict(group=group, root_cap=root_cap)
    pos, ok, conf, rounds = span_walk_ref(*args, consequent=False, **kw)
    cpos, cok, _, crounds = span_walk_ref(*args, consequent=True, **kw)
    found = ok & (pos > 0)
    conf = torch.where(found, conf, 0.0)
    con_sup = torch.where(cok & (cpos > 0), sup_col[cpos.long()], 0.0)
    single = ((queries >= 0).sum(1, dtype=torch.int32) - ant_len) == 1
    pl = pos.long()
    out = {
        "found": found,
        "pos": torch.where(found, pos, -1).to(torch.int32),
        "confidence": conf,
        "support": torch.where(found, sup_col[pl], 0.0),
        "lift": compound_lift(found, single,
                              torch.where(found, lift_col[pl], 0.0), conf,
                              con_sup),
        "con_support": con_sup,
    }
    return out, torch.maximum(rounds, crounds)


def trie_reduce_ref(support, confidence, depth, n_transactions: int = 0,
                    confidence_scale: float = 1.0):
    """``(n_rules, Σ support, max confidence, Σ confidence)`` as f32
    scalars over the nodes at ``depth > 0``; max is 0 when none is, and
    IEEE 754's maximum otherwise (a NaN propagates, +0.0 above -0.0).
    Quantized columns widen first (lift plays no part)."""
    if support.shape[0] == 0:
        z = torch.zeros((), dtype=torch.float32, device=support.device)
        return z, z.clone(), z.clone(), z.clone()
    support, confidence, _ = dequantize_metrics(
        support, confidence, confidence, n_transactions, confidence_scale,
        confidence_scale)
    mask = depth > 0
    n = mask.sum().to(torch.float32)
    sup_sum = torch.where(mask, support, 0.0).sum()
    conf_max = torch.where(
        n > 0, ieee_amax(torch.where(mask, confidence, -torch.inf)), 0.0)
    conf_sum = torch.where(mask, confidence, 0.0).sum()
    return n, sup_sum, conf_max, conf_sum


_KEY_NONE = -(1 << 31)   # below every max key: no live node


def max_key_ref(x):
    """``csrc/trie_reduce.cu::max_key``: f32 values as int32 keys in IEEE
    754's total order (-0.0 below +0.0), a NaN of either sign made
    positive (above +inf), so that an integer max is the IEEE maximum."""
    b = torch.where(torch.isnan(x), x.abs(), x).view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def from_key_ref(k):
    """The f32 value of a ``max_key_ref`` key."""
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _block_fold_ref(count, sup, kmax, csum, threads: int):
    """``csrc/trie_reduce.cu::block_fold`` over ``[B, threads]`` running
    values, one row a block: the xor butterfly in each warp (lane 0's
    values kept), then the warps added in warp order to the identity."""
    rows = count.shape[0]
    vals = [v.reshape(rows, threads // 32, 32)
            for v in (count, sup, kmax, csum)]
    lanes = torch.arange(32, device=count.device)
    for o in (16, 8, 4, 2, 1):
        vals = _fold(vals, [v[..., lanes ^ o] for v in vals])
    lane0 = [v[..., 0] for v in vals]
    acc = _fold_identity(rows, count.device)
    for w in range(threads // 32):
        acc = _fold(acc, [v[:, w] for v in lane0])
    return acc


def _fold_identity(rows: int, device):
    z = torch.zeros((rows,), dtype=torch.float32, device=device)
    return [torch.zeros((rows,), dtype=torch.int64, device=device), z,
            torch.full((rows,), _KEY_NONE, dtype=torch.int32, device=device),
            z.clone()]


def _fold(a, b):
    return [a[0] + b[0], a[1] + b[1], torch.maximum(a[2], b[2]),
            a[3] + b[3]]


def trie_reduce_split_ref(support, confidence, depth, n_transactions: int = 0,
                          confidence_scale: float = 1.0, *, blocks: int,
                          threads: int, unroll: int, head: int = 0):
    """``csrc/trie_reduce.cu``'s association order in plain PyTorch:
    ``(n_rules, Σ support, max confidence, Σ confidence, mean)`` over
    ``blocks`` blocks of ``threads`` threads, ``unroll`` vectors a thread
    per tile, whole vectors from node ``head`` (a vector is 16 bytes of
    the confidence column, ``trie_reduce.vector_nodes``).  Node ``j <
    head`` goes to global thread ``j`` first; vector ``v`` of tile ``t =
    v // (threads * unroll)`` to thread ``v % threads`` of block ``t %
    blocks``; tail node ``j`` after the last whole vector to global thread
    ``j`` last.  A thread adds its nodes in that order; the blocks fold as
    ``_block_fold_ref`` folds them, then thread ``i`` of the last block
    folds the partials of blocks ``i, i + threads, ...`` in turn, and
    those fold the same way (with one block, the same bits as its own
    fold).  The max is the integer max of ``max_key_ref``: IEEE 754's
    maximum, a NaN max being the largest ``|NaN|`` among the live values.
    Bitwise the kernel's at the same geometry, on the same device."""
    dev = support.device
    n = support.shape[0]
    if n == 0:
        z = torch.zeros((5,), dtype=torch.float32, device=dev)
        return z[0], z[1], z[2], z[3], z[4]
    sup, conf, _ = dequantize_metrics(
        support, confidence, confidence, n_transactions, confidence_scale,
        confidence_scale)
    vec = 16 // confidence.element_size()
    head = min(int(head), n)
    nv = (n - head) // vec
    tail0 = head + nv * vec
    tile = threads * unroll
    tiles = -(-nv // tile)
    rounds = -(-tiles // blocks)
    width = 2 + rounds * unroll * vec    # the head, the vectors, the tail
    # slot[p, k]: the node thread p adds k-th; n (an identity node) pads
    slot = torch.full((blocks * threads, width), n, dtype=torch.long,
                      device=dev)
    ar = torch.arange(nv * vec, device=dev)
    v, e = ar // vec, ar % vec
    t, r = v // tile, v % tile
    thread = (t % blocks) * threads + r % threads
    col = 1 + ((t // blocks) * unroll + r // threads) * vec + e
    slot[thread, col] = head + ar
    edge = torch.arange(head, device=dev)
    slot[edge, 0] = edge
    edge = torch.arange(n - tail0, device=dev)
    slot[edge, width - 1] = tail0 + edge

    def ext(x, pad):
        return torch.cat([x, torch.full((1,), pad, dtype=x.dtype,
                                        device=dev)])

    live = ext(depth, 0)[slot] > 0
    s_vals = torch.where(live, ext(sup, 0.0)[slot], 0.0)
    c_vals = torch.where(live, ext(conf, 0.0)[slot], 0.0)
    acc = _fold_identity(blocks * threads, dev)
    acc[0] = live.sum(1)
    # the max is an integer max of keys: exact in any order
    acc[2] = torch.where(live, max_key_ref(ext(conf, 0.0)[slot]),
                         _KEY_NONE).amax(1)
    for k in range(width):
        acc[1] = acc[1] + s_vals[:, k]
        acc[3] = acc[3] + c_vals[:, k]
    part = _block_fold_ref(*[a.reshape(blocks, threads) for a in acc],
                           threads)
    # the last block: thread i folds blocks i, i + threads, ... in turn
    per = -(-blocks // threads)
    pad = per * threads - blocks
    ident = _fold_identity(pad, dev)
    part = [torch.cat([p, q]).reshape(per, threads)
            for p, q in zip(part, ident)]
    acc = _fold_identity(threads, dev)
    for k in range(per):
        acc = _fold(acc, [p[k] for p in part])
    count, sup_sum, kmax, csum = _block_fold_ref(
        *[a.reshape(1, threads) for a in acc], threads)
    n_rules = count[0].to(torch.float32)
    conf_max = torch.where(count[0] > 0, from_key_ref(kmax[0]), 0.0)
    mean = csum[0] / torch.clamp(n_rules, min=1.0)
    return n_rules, sup_sum[0], conf_max, csum[0], mean
