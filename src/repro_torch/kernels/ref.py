"""Plain PyTorch versions of the port's kernels.

Each function computes what its kernel computes, with ordinary tensor
operations, on any device.  A kernel wrapper runs its plain version only
for tensors that lie on the CPU; the tests hold these against the
reference's jnp oracles, and ``chip_smoke.py`` holds every kernel against
them on the card.

Ranked results follow ``jax.lax.top_k`` order: value descending, ties by
ascending position (a stable descending sort over ascending positions),
with ``(-inf, -1)`` in slots past the live count.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.array_trie import bucket_edge_lookup

from .metrics_inkernel import compound_lift, rank_score

# masked [rows, N] score block size the plain rankings materialize at once
_BLOCK_ELEMS = 1 << 24


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``rank_score(metric)`` over each DFS range ``[los[q],
    his[q])``, nodes at ``depth >= min_depth`` only: ``(f32[Q, k],
    int32[Q, k])``."""
    n = support.shape[0]
    q = los.shape[0]
    if n == 0 or k <= 0 or q == 0:
        return _empty_ranked(q, k, support.device)
    score = rank_score(metric, support, confidence, lift)
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
                  metric: str = "confidence", min_depth: int = 1):
    """The single-range slice of ``topk_rank_batch_ref``."""
    dev = support.device
    vals, pos = topk_rank_batch_ref(
        support, confidence, lift, depth,
        torch.as_tensor(lo, dtype=torch.int32, device=dev).reshape(1),
        torch.as_tensor(hi, dtype=torch.int32, device=dev).reshape(1),
        k=k, metric=metric, min_depth=min_depth,
    )
    return vals[0], pos[0]


def rules_with_ref(
    support, confidence, lift, depth, node_item, post_lo, post_hi,
    plos, phis, items,
    *, k: int, metric: str = "confidence", min_depth: int = 1,
    role: str = "any",
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
    score = rank_score(metric, support, confidence, lift)
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


def trie_reduce_ref(support, confidence, depth):
    """``(n_rules, Σ support, max confidence, Σ confidence)`` as f32
    scalars over the nodes at ``depth > 0``; max is 0 when none is."""
    if support.shape[0] == 0:
        z = torch.zeros((), dtype=torch.float32, device=support.device)
        return z, z.clone(), z.clone(), z.clone()
    mask = depth > 0
    n = mask.sum().to(torch.float32)
    sup_sum = torch.where(mask, support, 0.0).sum()
    conf_max = torch.where(n > 0, torch.where(mask, confidence, -torch.inf)
                           .amax(), 0.0)
    conf_sum = torch.where(mask, confidence, 0.0).sum()
    return n, sup_sum, conf_max, conf_sum
