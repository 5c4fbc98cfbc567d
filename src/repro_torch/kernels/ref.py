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

from repro_torch.core.array_trie import bucket_edge_lookup, span_step

from .metrics_inkernel import compound_lift, dequantize_metrics, rank_score

# masked [rows, N] score block size the plain rankings materialize at once
_BLOCK_ELEMS = 1 << 24
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


def rules_with_ref(
    support, confidence, lift, depth, node_item, post_lo, post_hi,
    plos, phis, items,
    *, k: int, metric: str = "confidence", min_depth: int = 1,
    role: str = "any", n_transactions: int = 0,
    confidence_scale: float = 1.0, lift_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the rules involving each queried item: membership by
    ``role`` (consequent: ``node_item == item``; antecedent/any: the
    laminar count ``#(post_lo <= p) - #(post_hi <= p)`` over the item's
    posting slice ``[plos[q], phis[q])``, minus the node's own entry for
    the antecedent role)."""
    if role not in ("consequent", "antecedent", "any"):
        raise ValueError(f"unknown role {role!r}")
    n = support.shape[0]
    q = plos.shape[0]
    if n == 0 or k <= 0 or q == 0:
        return _empty_ranked(q, k, support.device)
    score = rank_score(metric, *dequantize_metrics(
        support, confidence, lift,
        n_transactions, confidence_scale, lift_scale))
    pos = torch.arange(n, dtype=torch.int32, device=support.device)
    items = items.to(torch.int32)
    live = depth >= min_depth
    slices = list(zip(plos.tolist(), phis.tolist()))

    def member(r0, r1):
        self_hit = node_item[None, :] == items[r0:r1, None]
        if role == "consequent":
            return self_hit & live
        cnt = torch.stack([
            torch.searchsorted(post_lo[a:b], pos, right=True)
            - torch.searchsorted(post_hi[a:b], pos, right=True)
            for a, b in slices[r0:r1]
        ])
        if role == "antecedent":
            cnt = cnt - self_hit.to(cnt.dtype)
        return (cnt > 0) & live

    return _rank_rows(score, member, q, k)


def not_found(q: int, device) -> Dict[str, torch.Tensor]:
    """Rule-search result of Q absent rules (empty trie, width 0)."""
    def z():
        return torch.zeros((q,), dtype=torch.float32, device=device)

    return {
        "found": torch.zeros((q,), dtype=torch.bool, device=device),
        "node": torch.full((q,), -1, dtype=torch.int32, device=device),
        "confidence": z(), "support": z(), "lift": z(), "con_support": z(),
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


def trie_reduce_ref(support, confidence, depth, n_transactions: int = 0,
                    confidence_scale: float = 1.0):
    """``(n_rules, Σ support, max confidence, Σ confidence)`` as f32
    scalars over the nodes at ``depth > 0``; max is 0 when none is.
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
    conf_max = torch.where(n > 0, torch.where(mask, confidence, -torch.inf)
                           .amax(), 0.0)
    conf_sum = torch.where(mask, confidence, 0.0).sum()
    return n, sup_sum, conf_max, conf_sum
