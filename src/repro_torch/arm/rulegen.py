"""Rule generation: frequent itemsets → association rules (prefix splits).

The Trie of rules stores each frequent sequence in global frequency order;
a rule A→C is representable iff the items of A all precede the items of C in
that order (paper §3.3 — this "avoids false Confidence situations" and keeps
the most valuable rules).  The canonical ruleset of this repo is therefore:

    for every distinct frequency-ordered prefix path p (|p| ≥ 2) reachable
    from the mined sequences, and every split point i: rule p[:i] → p[i:].

Both representations (trie and flat table) store exactly this set, so the
Fig. 8-13 comparisons are apples-to-apples.  A copy of ``repro.arm.rulegen``;
host only.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.metrics import Item, Rule, RuleMetrics
from .transactions import TransactionDB

ItemSet = FrozenSet[Item]


def canonical_sequences(
    itemsets: Iterable[ItemSet], db: TransactionDB
) -> List[Tuple[Item, ...]]:
    """Frequency-order every mined itemset (Step 2 pre-sort)."""
    order = db.frequency_order()
    rank = {it: r for r, it in enumerate(order)}
    return [
        tuple(sorted(s, key=lambda it: (rank[it], it))) for s in itemsets
    ]


def canonical_matrix(
    itemsets: Iterable[ItemSet],
    db: TransactionDB,
    max_len: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mined itemsets → the padded canonical int32 ``[S, L]`` matrix + lens.

    The matrix emission API for feeding trie construction (or any other
    array consumer) directly at the matrix level: rows are -1-padded and
    re-sorted to frequency order vectorized, the exact canonical form
    ``core.build_arrays.build_frozen_trie`` produces internally from raw
    sequence tuples.
    """
    from repro_torch.core.array_trie import item_tables
    from repro_torch.core.build_arrays import canonicalize_matrix, pack_sequences

    mat, lens = pack_sequences(
        [tuple(s) for s in itemsets], max_len=max_len
    )
    _, item_rank = item_tables(db.frequency_order())
    if mat.size:
        mat = canonicalize_matrix(mat, item_rank)
        lens = (mat >= 0).sum(axis=1).astype(np.int32)
    return mat, lens


def sample_rule_sequences(
    db: TransactionDB, n: int, max_len: int = 8, seed: int = 0
) -> List[Tuple[Item, ...]]:
    """``n`` random frequency-ordered sequences drawn from real
    transactions (construction-benchmark workload: supports are genuine,
    prefix sharing mirrors mined rulesets without paying a full mine)."""
    rng = np.random.RandomState(seed)
    order = db.frequency_order()
    rank = {it: r for r, it in enumerate(order)}
    non_empty = [sorted(t) for t in db.transactions if t]
    if not non_empty:
        return []
    out: List[Tuple[Item, ...]] = []
    picks = rng.randint(0, len(non_empty), size=n)
    for tid in picks:
        t = non_empty[tid]
        k = rng.randint(1, min(max_len, len(t)) + 1)
        idx = rng.choice(len(t), size=k, replace=False)
        items = [t[i] for i in idx]
        out.append(
            tuple(sorted(items, key=lambda it: (rank[it], it)))
        )
    return out


def distinct_paths(
    sequences: Iterable[Sequence[Item]],
) -> List[Tuple[Item, ...]]:
    """All distinct non-empty prefixes of the canonical sequences — exactly
    the node set of the Trie of rules."""
    paths: Set[Tuple[Item, ...]] = set()
    for seq in sequences:
        for i in range(1, len(seq) + 1):
            paths.add(tuple(seq[:i]))
    return sorted(paths, key=lambda p: (len(p), p))


def prefix_split_rules(
    itemsets: Dict[ItemSet, int],
    db: TransactionDB,
    min_confidence: float = 0.0,
) -> List[Rule]:
    """The canonical ruleset with exact metrics from the transaction DB."""
    sequences = canonical_sequences(itemsets.keys(), db)
    paths = distinct_paths(sequences)
    support_of: Dict[Tuple[Item, ...], float] = {(): 1.0}
    for p in paths:
        support_of[p] = db.support(p)

    rules: List[Rule] = []
    for p in paths:
        if len(p) < 2:
            continue
        sup_full = support_of[p]
        for i in range(1, len(p)):
            ant, con = p[:i], p[i:]
            sup_ant = support_of[ant]
            conf = sup_full / sup_ant if sup_ant > 0 else 0.0
            if conf < min_confidence:
                continue
            sup_con = db.support(con)
            lift = conf / sup_con if sup_con > 0 else 0.0
            rules.append(
                Rule(
                    antecedent=ant,
                    consequent=con,
                    metrics=RuleMetrics(
                        support=sup_full, confidence=conf, lift=lift
                    ),
                )
            )
    return rules
