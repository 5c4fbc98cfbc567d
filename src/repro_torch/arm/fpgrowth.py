"""FP-growth and FP-max frequent-itemset miners (paper Step 1).

Classic Han et al. FP-growth over an FP-tree with conditional pattern bases;
``fpmax`` post-filters to maximal itemsets (the paper uses FP-max in its
illustrative example "because it usually produces a smaller output volume").

Returns ``{frozenset(items): absolute_count}``.  A copy of
``repro.arm.fpgrowth``; host only.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

from .transactions import TransactionDB

Item = int
ItemSet = FrozenSet[Item]


@dataclass
class _FPNode:
    item: Item
    count: int = 0
    parent: Optional["_FPNode"] = None
    children: Dict[Item, "_FPNode"] = field(default_factory=dict)
    link: Optional["_FPNode"] = None  # header-table chain


class _FPTree:
    def __init__(self) -> None:
        self.root = _FPNode(item=-1)
        self.header: Dict[Item, _FPNode] = {}
        self._tails: Dict[Item, _FPNode] = {}

    def insert(self, items: Sequence[Item], count: int) -> None:
        node = self.root
        for it in items:
            child = node.children.get(it)
            if child is None:
                child = _FPNode(item=it, parent=node)
                node.children[it] = child
                if it in self._tails:
                    self._tails[it].link = child
                else:
                    self.header[it] = child
                self._tails[it] = child
            child.count += count
            node = child

    def prefix_paths(self, item: Item) -> List[Tuple[List[Item], int]]:
        """Conditional pattern base of ``item``."""
        paths: List[Tuple[List[Item], int]] = []
        node = self.header.get(item)
        while node is not None:
            path: List[Item] = []
            parent = node.parent
            while parent is not None and parent.item != -1:
                path.append(parent.item)
                parent = parent.parent
            if path:
                paths.append((list(reversed(path)), node.count))
            node = node.link
        return paths


def _build_tree(
    weighted_transactions: Iterable[Tuple[Sequence[Item], int]],
    min_count: int,
) -> Tuple[_FPTree, Dict[Item, int]]:
    counts: Dict[Item, int] = defaultdict(int)
    cached = []
    for items, w in weighted_transactions:
        cached.append((items, w))
        for it in items:
            counts[it] += w
    frequent = {it: c for it, c in counts.items() if c >= min_count}
    order = sorted(frequent, key=lambda it: (-frequent[it], it))
    rank = {it: r for r, it in enumerate(order)}
    tree = _FPTree()
    for items, w in cached:
        filtered = sorted(
            (it for it in set(items) if it in rank), key=lambda it: rank[it]
        )
        if filtered:
            tree.insert(filtered, w)
    return tree, frequent


def _mine(
    tree: _FPTree,
    frequent: Dict[Item, int],
    suffix: ItemSet,
    min_count: int,
    out: Dict[ItemSet, int],
    max_len: int,
) -> None:
    # Iterate items least-frequent first (standard FP-growth order).
    for item in sorted(frequent, key=lambda it: (frequent[it], -it)):
        new_set = suffix | {item}
        out[frozenset(new_set)] = frequent[item]
        if len(new_set) >= max_len:
            continue
        cond = tree.prefix_paths(item)
        if not cond:
            continue
        subtree, sub_frequent = _build_tree(cond, min_count)
        if sub_frequent:
            _mine(subtree, sub_frequent, new_set, min_count, out, max_len)


def fpgrowth(
    db: TransactionDB,
    min_support: float,
    max_len: int = 12,
) -> Dict[ItemSet, int]:
    """All frequent itemsets with support ≥ ``min_support``."""
    min_count = max(1, int(min_support * db.n_transactions + 0.9999999))
    tree, frequent = _build_tree(
        ((list(t), 1) for t in db.transactions), min_count
    )
    out: Dict[ItemSet, int] = {}
    if frequent:
        _mine(tree, frequent, frozenset(), min_count, out, max_len)
    return out


def fpmax(
    db: TransactionDB,
    min_support: float,
    max_len: int = 12,
) -> Dict[ItemSet, int]:
    """Maximal frequent itemsets (no frequent proper superset) — FP-max.

    Downward closure makes the maximality check local: an itemset has a
    frequent proper superset iff it has a frequent superset of size+1, so
    marking every (k-1)-subset of every frequent k-itemset identifies all
    non-maximal sets in O(Σ|s|) instead of a quadratic subset sweep.
    """
    all_frequent = fpgrowth(db, min_support, max_len=max_len)
    non_maximal: set = set()
    for s in all_frequent:
        if len(s) < 2:
            continue
        for it in s:
            non_maximal.add(s - {it})
    return {
        s: c for s, c in all_frequent.items() if s not in non_maximal
    }
