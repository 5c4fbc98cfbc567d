"""ARM over tokenized corpora — the paper's structure as a data feature.

Two integrations (DESIGN.md §4):

1. ``mine_corpus_rules``: token co-occurrence windows are transactions
   (items = token ids); the resulting Trie of rules answers corpus
   analytics — high-confidence long paths are boilerplate/template
   detectors used for curation.

2. ``NgramTrie``: the SAME prefix-trie structure over *ordered* n-grams
   (identity item order instead of frequency order).  Node confidence is
   exactly P(next-token | prefix), and the paper's compound-consequent
   product (Eq. 1-4) is the probability of a multi-token draft — which is
   what ``repro_torch.serve.spec_decode`` uses as a speculative-decoding
   proposer.

A copy of ``repro.data.corpus_rules`` over the port's ``arm`` and
``core.builder``; ``mine_corpus_rules`` passes ``device`` on to
``build_trie_of_rules`` (it matters only for the apriori miner's kernel).
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.arm.transactions import TransactionDB
from repro_torch.core.builder import BuildResult, build_trie_of_rules
from repro_torch.core.trie import TrieOfRules


def windows_to_db(
    token_rows: np.ndarray, window: int = 8, stride: int = 4,
    vocab_size: Optional[int] = None,
) -> TransactionDB:
    """Sliding windows over token rows → transaction DB (items=token ids)."""
    txs: List[set] = []
    vmax = 0
    for row in token_rows:
        row = [int(t) for t in row if int(t) >= 0]
        for start in range(0, max(1, len(row) - window + 1), stride):
            w = row[start : start + window]
            if w:
                txs.append(set(w))
                vmax = max(vmax, max(w))
    n_items = vocab_size if vocab_size is not None else vmax + 1
    return TransactionDB(txs, n_items=n_items)


def mine_corpus_rules(
    token_rows: np.ndarray,
    min_support: float = 0.01,
    window: int = 8,
    stride: int = 4,
    vocab_size: Optional[int] = None,
    miner: str = "fpgrowth",
    device=None,
) -> Tuple[BuildResult, TransactionDB]:
    db = windows_to_db(token_rows, window, stride, vocab_size)
    return build_trie_of_rules(db, min_support, miner=miner,
                               device=device), db


def boilerplate_paths(
    result: BuildResult, min_depth: int = 4, min_confidence: float = 0.8
) -> List[Tuple[Tuple[int, ...], float]]:
    """High-confidence long paths = template/boilerplate detectors."""
    out = []
    for path, node in result.trie.all_paths():
        if node.depth >= min_depth and node.confidence >= min_confidence:
            out.append((path, node.confidence))
    return sorted(out, key=lambda x: (-len(x[0]), -x[1]))


class NgramTrie:
    """Trie of rules over ORDERED token n-grams (identity item order).

    Construction annotates Support/Confidence directly from prefix counts
    (Step 3 of the paper, with the transaction-DB oracle replaced by the
    n-gram count oracle — counts are exact for ordered prefixes).
    """

    def __init__(self, n: int = 4):
        self.n = n
        self.trie = TrieOfRules(item_order=None)  # identity order
        self.total = 0

    def fit(self, token_rows: Iterable[Sequence[int]]) -> "NgramTrie":
        counts: Counter = Counter()
        for row in token_rows:
            row = [int(t) for t in row]
            self.total += max(0, len(row) - self.n + 1)
            for i in range(len(row) - self.n + 1):
                gram = tuple(row[i : i + self.n])
                counts[gram] += 1
        # insert and annotate from prefix counts
        prefix_counts: Counter = Counter()
        for gram, c in counts.items():
            for k in range(1, self.n + 1):
                prefix_counts[gram[:k]] += c
        for gram in counts:
            node = self.trie.insert(gram)
        for path, node in self.trie.all_paths():
            c = prefix_counts[path]
            parent_c = (
                prefix_counts[path[:-1]] if len(path) > 1 else self.total
            )
            node.support = c / max(self.total, 1)
            node.confidence = c / max(parent_c, 1)
            item_c = prefix_counts[(path[-1],)]
            node.lift = (
                node.confidence / (item_c / max(self.total, 1))
                if item_c else 0.0
            )
        return self

    def propose(
        self,
        context_tail: Sequence[int],
        max_tokens: int = 4,
        min_confidence: float = 0.3,
    ) -> Tuple[List[int], float]:
        """Greedy highest-confidence walk from the (n-1)-token context:
        returns (draft tokens, compound confidence = Eq. 1 product)."""
        node = self.trie.find_path(tuple(context_tail))
        if node is None:
            return [], 0.0
        draft: List[int] = []
        conf = 1.0
        for _ in range(max_tokens):
            if not node.children:
                break
            child = max(node.children.values(), key=lambda c: c.confidence)
            if conf * child.confidence < min_confidence:
                break
            conf *= child.confidence
            draft.append(child.item)
            node = child
        return draft, conf
