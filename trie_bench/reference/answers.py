"""The reference's answers to the three served query ops, from its own trie.

Each op's semantics, as the paper and the port's README define them:

* ``rule_search(A, C)``: A and C each sorted by frequency rank and walked
  as one path from the root; found when the path is a rule of the trie.
  Support is the rule node's, Confidence is Support(A + C) / Support(A)
  (the product of the edge confidences along C), Lift is the node's Lift
  for a one-item C and Confidence / Support(C) otherwise (C walked from the
  root).  An absent rule answers found False and zeros.
* ``top_k(prefix, k, metric, min_depth)``: the k best nodes by ``metric``
  in the prefix node's subtree (the node itself included), at depth >=
  min_depth; nothing for an absent prefix.
* ``rules_with(item, role, k, metric, min_depth)``: the k best nodes whose
  path holds the item: anywhere (``any``), as the last item
  (``consequent``) or before the last (``antecedent``).

Rankings are returned as candidate sets and the sorted top-k values; the
comparison in ``check.py`` judges a served ranking by them, so that ties
may fall in either order.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .mine import RefTrie

ROLES = ("consequent", "antecedent", "any")


def canonical(ref: RefTrie, items: Sequence[int]) -> List[int]:
    """The items' ranks, sorted (an item no node has sorts last)."""
    return sorted(int(r) for r in ref.ranks(list(items)))


def rule_search(ref: RefTrie, pairs: Sequence[Tuple[Sequence[int],
                                                      Sequence[int]]]
                ) -> Dict[str, np.ndarray]:
    """found, node, support, confidence, lift (float64) for each pair."""
    ants = [canonical(ref, a) for a, _ in pairs]
    cons = [canonical(ref, c) for _, c in pairs]
    node = ref.walk([a + c for a, c in zip(ants, cons)])
    ant_node = ref.walk(ants)
    con_node = ref.walk(cons)
    found = node > 0
    sup = ref.columns["support"]
    nid = np.maximum(node, 0)
    ant_sup = np.where(np.array([len(a) for a in ants]) == 0, 1.0,
                       sup[np.maximum(ant_node, 0)])
    conf = np.where(found & (ant_sup > 0),
                    sup[nid] / np.where(ant_sup > 0, ant_sup, 1.0), 0.0)
    single = np.array([len(c) for c in cons]) == 1
    csup = np.where(con_node > 0, sup[np.maximum(con_node, 0)], 0.0)
    lift = np.where(single, ref.columns["lift"][nid],
                    np.where(csup > 0, conf / np.where(csup > 0, csup, 1.0),
                             0.0))
    return {
        "found": found,
        "node": np.where(found, node, -1),
        "support": np.where(found, sup[nid], 0.0),
        "confidence": conf,
        "lift": np.where(found, lift, 0.0),
    }


def prefix_ranges(ref: RefTrie, prefixes: Sequence[Sequence[int]]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """DFS range ``[lo, hi)`` of each prefix's subtree; ``[0, 0)`` when the
    prefix is no node, ``[0, N)`` when it is empty."""
    node = ref.walk([canonical(ref, p) for p in prefixes])
    ok = node >= 0
    nid = np.maximum(node, 0)
    lo = np.where(ok, ref.pos[nid], 0)
    hi = np.where(ok, lo + ref.size[nid], 0)
    return lo, hi


def member_ranges(ref: RefTrie, items: Sequence[int], role: str
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(query, lo, hi)``: the DFS ranges of the nodes whose path holds
    each item in ``role``, one row per range, disjoint within a query (a
    path holds an item once, so two of its nodes never nest)."""
    if role not in ROLES:
        raise ValueError(f"unknown role {role!r}")
    r = ref.ranks(items)
    ok = r < ref.n_frequent
    rr = np.where(ok, r, 0)
    a = np.where(ok, ref.post_offsets[rr], 0)
    b = np.where(ok, ref.post_offsets[np.minimum(rr + 1, ref.n_frequent)], 0)
    lens = b - a
    qid = np.repeat(np.arange(len(r)), lens)
    j = np.repeat(a - np.cumsum(lens) + lens, lens) + np.arange(lens.sum())
    nodes = ref.post_node[j]
    lo = ref.pos[nodes]
    if role == "consequent":
        return qid, lo, lo + 1
    hi = lo + ref.size[nodes]
    if role == "antecedent":
        lo = lo + 1
    keep = hi > lo
    return qid[keep], lo[keep], hi[keep]


def topk_values(score_pos: np.ndarray, depth_pos: np.ndarray,
                qid: np.ndarray, lo: np.ndarray, hi: np.ndarray, q: int,
                k: int, min_depth: int) -> np.ndarray:
    """``float64 [q, k]``: the k best scores over each query's ranges (at
    depth >= min_depth), descending, ``-inf`` past the candidates."""
    out = np.full((q, k), -np.inf)
    lens = np.maximum(hi - lo, 0)
    pos = (np.repeat(lo - np.cumsum(lens) + lens, lens)
           + np.arange(lens.sum()))
    owner = np.repeat(qid, lens)
    live = depth_pos[pos] >= min_depth
    pos, owner = pos[live], owner[live]
    if pos.size == 0:
        return out
    # sort by (query, score descending); take each query's first k
    order = np.lexsort((-score_pos[pos], owner))
    owner, vals = owner[order], score_pos[pos][order]
    start = np.searchsorted(owner, np.arange(q))
    rank = np.arange(owner.shape[0]) - start[owner]
    take = rank < k
    out[owner[take], rank[take]] = vals[take]
    return out
