"""Trie of Rules — paper-faithful pointer implementation (Methodology §3).

Step 2 of the paper: insert frequency-ordered frequent sequences into an
FP-tree-like prefix trie.  *Every node represents a rule*: the node item is
the (single-item) consequent and the path root→parent is the antecedent.
Step 3 annotates every node with Support / Confidence / Lift.

This module is deliberately plain CPython with pointer nodes and dict
children — it is the reproduction BASELINE that the benchmarks compare
against ``flat_table.FlatRuleTable`` (the dataframe stand-in), exactly like
the paper's Fig. 8-13.  The flat array encoding lives in ``array_trie.py``;
production construction no longer freezes this pointer trie but builds the
arrays directly (``core.build_arrays``), so this implementation survives
primarily as the parity ORACLE the array engine is tested field-for-field
against.  A copy of ``repro.core.trie``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import (
    Callable,
    Dict,
    FrozenSet,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

from .metrics import (
    Item,
    RuleMetrics,
    compound_confidence,
    confidence,
    lift,
)

SupportFn = Callable[[FrozenSet[Item]], float]


@dataclass
class TrieNode:
    """One node = one rule (consequent = ``item``, antecedent = path above)."""

    item: Item
    parent: Optional["TrieNode"] = None
    children: Dict[Item, "TrieNode"] = field(default_factory=dict)
    # Step 3 annotations (filled by ``annotate``):
    support: float = 0.0       # Support of the full path itemset
    confidence: float = 0.0    # Support(path) / Support(path[:-1])
    lift: float = 0.0          # confidence / Support({item})
    depth: int = 0

    def path(self) -> Tuple[Item, ...]:
        """Root→this-node item sequence (the rule's full sequence)."""
        items: List[Item] = []
        node: Optional[TrieNode] = self
        while node is not None and node.parent is not None:
            items.append(node.item)
            node = node.parent
        return tuple(reversed(items))

    def rule_metrics(self) -> RuleMetrics:
        return RuleMetrics(self.support, self.confidence, self.lift)


class TrieOfRules:
    """The paper's data structure: a prefix trie whose nodes are rules."""

    ROOT_ITEM: Item = -1

    def __init__(self, item_order: Optional[Sequence[Item]] = None):
        self.root = TrieNode(item=self.ROOT_ITEM, parent=None, depth=0)
        self.n_nodes = 0
        # Global frequency order used to canonicalize sequences before
        # insertion/search (paper: "items in each frequent sequence are
        # sorted according to their frequency in the original dataset").
        self._rank: Dict[Item, int] = {}
        if item_order is not None:
            self.set_item_order(item_order)

    # ------------------------------------------------------------------
    # construction (Step 2)
    # ------------------------------------------------------------------
    def set_item_order(self, item_order: Sequence[Item]) -> None:
        self._rank = {it: r for r, it in enumerate(item_order)}

    def canonical(self, items: Sequence[Item]) -> Tuple[Item, ...]:
        """Sort items by global frequency rank (ties by item id)."""
        if not self._rank:
            return tuple(items)
        return tuple(
            sorted(items, key=lambda it: (self._rank.get(it, 1 << 30), it))
        )

    def insert(self, sequence: Sequence[Item]) -> TrieNode:
        """Insert one frequency-ordered frequent sequence; returns leaf."""
        node = self.root
        for it in self.canonical(sequence):
            child = node.children.get(it)
            if child is None:
                child = TrieNode(item=it, parent=node, depth=node.depth + 1)
                node.children[it] = child
                self.n_nodes += 1
            node = child
        return node

    def build(self, sequences: Sequence[Sequence[Item]]) -> "TrieOfRules":
        for seq in sequences:
            self.insert(seq)
        return self

    # ------------------------------------------------------------------
    # annotation (Step 3)
    # ------------------------------------------------------------------
    def annotate(self, support_fn: SupportFn) -> None:
        """Label every node with Support/Confidence/Lift of its rule.

        ``support_fn`` returns the exact Support of an itemset (queried
        against the transaction DB — in this repo the bitmap-encoded DB in
        ``arm.transactions``).
        """
        single: Dict[Item, float] = {}

        def item_support(it: Item) -> float:
            if it not in single:
                single[it] = support_fn(frozenset((it,)))
            return single[it]

        stack: List[Tuple[TrieNode, float, Tuple[Item, ...]]] = [
            (self.root, 1.0, ())
        ]
        while stack:
            node, parent_support, path = stack.pop()
            if node is not self.root:
                full = path + (node.item,)
                node.support = support_fn(frozenset(full))
                node.confidence = confidence(node.support, parent_support)
                node.lift = lift(node.confidence, item_support(node.item))
                child_path = full
                child_parent_support = node.support
            else:
                child_path = ()
                child_parent_support = 1.0
            for child in node.children.values():
                stack.append((child, child_parent_support, child_path))

    # ------------------------------------------------------------------
    # queries (the paper's evaluated operations)
    # ------------------------------------------------------------------
    def find_path(self, sequence: Sequence[Item]) -> Optional[TrieNode]:
        """Walk root→down along ``sequence`` (canonicalized); None if absent."""
        node = self.root
        for it in self.canonical(sequence):
            node = node.children.get(it)
            if node is None:
                return None
        return node if node is not self.root else None

    def search_rule(
        self,
        antecedent: Sequence[Item],
        consequent: Sequence[Item],
    ) -> Optional[RuleMetrics]:
        """Find rule A→C; supports compound consequents via Eq. 1-4.

        The rule is present iff canonical(A) + canonical(C) is a path whose
        antecedent part is a prefix (paper §3.3: rules are stored in
        frequency order; A must precede C in that order).
        """
        ant = self.canonical(antecedent)
        cons = self.canonical(consequent)
        node = self.root
        for it in ant:
            node = node.children.get(it)
            if node is None:
                return None
        ant_support = node.support if node is not self.root else 1.0
        confs: List[float] = []
        for it in cons:
            node = node.children.get(it)
            if node is None:
                return None
        # ``node`` is now the final consequent node; walk confidences.
        final = node
        confs = []
        walk: List[TrieNode] = []
        cur: Optional[TrieNode] = final
        for _ in range(len(cons)):
            assert cur is not None
            walk.append(cur)
            cur = cur.parent
        for n in reversed(walk):
            confs.append(n.confidence)
        conf = compound_confidence(confs)
        sup = final.support
        if len(cons) == 1:
            # Single-item consequent: the node's Step-3 lift IS the rule lift.
            lift_val = final.lift
        else:
            con_sup = self._consequent_support(cons)
            lift_val = conf / con_sup if con_sup > 0 else 0.0
        return RuleMetrics(support=sup, confidence=conf, lift=lift_val)

    def _consequent_support(self, cons: Tuple[Item, ...]) -> float:
        """Support of the joint consequent itemset.

        For single-item consequents this is the item Support; for compound
        consequents we answer from the trie via a root-anchored walk (the
        consequent is frequency-ordered so its path, when frequent, exists
        as a prefix).  Falls back to +inf-safe 0 → lift 0 when unknown.
        """
        node = self.root
        for it in cons:
            node = node.children.get(it)
            if node is None:
                return 0.0
        return node.support

    def traverse(self) -> Iterator[TrieNode]:
        """DFS over every node (= every stored rule), the Fig-traversal op."""
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def rules_with_item(
        self, item: Item, role: str = "any"
    ) -> Iterator[TrieNode]:
        """Every stored rule involving ``item`` in the given role.

        ``role="consequent"``: the node's own item is ``item`` (the rule's
        single-item consequent).  ``role="antecedent"``: some STRICT
        ancestor carries ``item`` (it sits in the rule's antecedent path).
        ``role="any"``: either.  This is the per-node path-walk the
        item-inverted index (``array_trie.item_index_arrays``) replaces;
        it survives as the parity oracle for the batched ``rules_with``
        op, exactly like ``search_rule`` oracles the search kernels.
        """
        if role not in ("consequent", "antecedent", "any"):
            raise ValueError(f"unknown role {role!r}")
        for node in self.traverse():
            if role == "consequent":
                hit = node.item == item
            else:
                in_ant = any(it == item for it in node.path()[:-1])
                if role == "antecedent":
                    hit = in_ant
                else:
                    hit = in_ant or node.item == item
            if hit:
                yield node

    def depth1_subtree_sizes(self) -> List[Tuple[Item, int]]:
        """Per-(root-child) subtree sizes, item-sorted — the shard oracle.

        Returns ``[(item, |subtree|), ...]`` over the root's children in
        item order (the order ``FrozenTrie.freeze`` numbers them, which is
        also their DFS-range order).  This recursive walk is the pointer
        parity oracle for ``FrozenTrie.depth1_subtrees`` — the metadata
        the multi-device partitioner bin-packs into shard ranges.
        """
        def size(node: TrieNode) -> int:
            return 1 + sum(size(c) for c in node.children.values())

        return [
            (child.item, size(child))
            for child in sorted(
                self.root.children.values(), key=lambda c: c.item
            )
        ]

    def top_n(
        self, n: int, metric: str = "support", min_depth: int = 2
    ) -> List[TrieNode]:
        """Top-N rules by a metric column (paper Fig 12/13).

        Depth-1 nodes have an empty antecedent (not a valid association
        rule), so they are excluded by default.
        """
        key = {
            "support": lambda nd: nd.support,
            "confidence": lambda nd: nd.confidence,
            "lift": lambda nd: nd.lift,
        }[metric]
        pool = (nd for nd in self.traverse() if nd.depth >= min_depth)
        return heapq.nlargest(n, pool, key=key)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self.n_nodes

    def all_paths(self) -> Iterator[Tuple[Tuple[Item, ...], TrieNode]]:
        stack: List[Tuple[TrieNode, Tuple[Item, ...]]] = [
            (c, (c.item,)) for c in self.root.children.values()
        ]
        while stack:
            node, path = stack.pop()
            yield path, node
            for child in node.children.values():
                stack.append((child, path + (child.item,)))
