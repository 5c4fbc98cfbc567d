"""Apriori frequent-itemset miner over the packed-bitmap layout.

Level-wise candidate generation with prefix joins; support counting is
AND+popcount over the vertical bitmaps — the same inner loop the CUDA
``support_count`` kernel runs on the GPU (``use_kernel=True`` routes each
level's counting through it, one launch per level, which is how the mining
Step 1 hot spot runs on the card).  A copy of ``repro.arm.apriori`` with a
``device`` for the kernel path.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np

from .transactions import TransactionDB

Item = int
ItemSet = FrozenSet[Item]


def _count_batch(
    db: TransactionDB,
    candidates: Sequence[Tuple[Item, ...]],
    use_kernel: bool,
    device=None,
) -> np.ndarray:
    """One ``support_batch`` call per level: vectorized bitmap AND+popcount
    on host, or a single ``support_count`` kernel launch on ``device`` with
    ``use_kernel=True`` (the mining Step 1 hot spot on the GPU)."""
    max_len = max(len(c) for c in candidates)
    mat, lens = db.candidate_matrix(candidates, max_len)
    return db.support_batch(mat, lens, use_kernel=use_kernel, device=device)


def _generate_candidates(
    prev_level: List[Tuple[Item, ...]],
) -> List[Tuple[Item, ...]]:
    """Join step: merge k-itemsets sharing a (k-1)-prefix, then prune by
    requiring every (k-1)-subset frequent (downward closure)."""
    prev_set = set(prev_level)
    out: List[Tuple[Item, ...]] = []
    n = len(prev_level)
    # prev_level is sorted; group by prefix.
    i = 0
    while i < n:
        j = i
        prefix = prev_level[i][:-1]
        while j < n and prev_level[j][:-1] == prefix:
            j += 1
        for a in range(i, j):
            for b in range(a + 1, j):
                cand = prev_level[a] + (prev_level[b][-1],)
                # prune: all (k-1)-subsets must be frequent
                ok = True
                for drop in range(len(cand) - 2):
                    sub = cand[:drop] + cand[drop + 1 :]
                    if sub not in prev_set:
                        ok = False
                        break
                if ok:
                    out.append(cand)
        i = j
    return out


def apriori(
    db: TransactionDB,
    min_support: float,
    max_len: int = 12,
    use_kernel: bool = False,
    device=None,
) -> Dict[ItemSet, int]:
    """All frequent itemsets with support ≥ ``min_support``;
    ``use_kernel=True`` counts each level with one kernel launch on
    ``device`` (CUDA unless named)."""
    min_count = max(1, int(min_support * db.n_transactions + 0.9999999))

    item_counts = db.item_counts()
    level: List[Tuple[Item, ...]] = sorted(
        (it,) for it in range(db.n_items) if item_counts[it] >= min_count
    )
    out: Dict[ItemSet, int] = {
        frozenset(c): int(item_counts[c[0]]) for c in level
    }
    k = 1
    while level and k < max_len:
        candidates = _generate_candidates(level)
        if not candidates:
            break
        counts = _count_batch(db, candidates, use_kernel, device)
        count_of = dict(zip(candidates, counts))
        level = sorted(
            c for c, cnt in zip(candidates, counts) if cnt >= min_count
        )
        for c in level:
            out[frozenset(c)] = int(count_of[c])
        k += 1
    return out
