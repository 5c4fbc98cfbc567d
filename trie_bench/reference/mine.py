"""Frequent itemsets by exact dense counting, and the Trie of Rules over
them, in plain PyTorch and NumPy.

The miner is not Apriori's candidate join: level ``k + 1`` is every
frequent itemset ``X + (j,)`` with ``X`` frequent at level ``k`` and ``j``
a frequent item ranked after ``X``'s last, counted for all ``(X, j)`` at
once as a product of 0/1 matrices, ``TX^T @ D``, in float64, where ``TX``
holds each ``X``'s transaction indicator and ``D`` the frequent items'
columns.  Counts below 2**53 are exact in float64 whatever the summation
order, so the counts, and with them the itemsets, are exact.

Items are handled by frequency rank (count descending, ties by ascending
id), the order in which the paper sorts every rule path; so a node's path
is its itemset in increasing rank, and a node's children are the
extensions by higher-ranked items.  The metric columns follow the paper's
definitions in float64: Support = count / |D|, Confidence = Support /
Support(parent) (the root's Support is 1), Lift = Confidence /
Support(last item).
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Sequence

import numpy as np
import torch

# itemsets per block of the counting product: TX is [|D|, BLOCK] float64
BLOCK = 4096


def min_count(minsup: float, n_tx: int) -> int:
    """The least transaction count with Support >= ``minsup``."""
    return max(1, math.ceil(Fraction(str(minsup)) * n_tx))


class RefTrie:
    """The reference's Trie of Rules: node arrays in rank space, depth-major
    ids (the root is 0), float64 metric columns, a pre-order (DFS) layout
    and a sorted child-key table for descents."""

    def __init__(self, parent, rank, count, level_sizes, n_tx,
                 item_of_rank, n_frequent):
        self.parent = np.asarray(parent, np.int64)
        self.rank = np.asarray(rank, np.int64)
        self.count = np.asarray(count, np.int64)
        self.n_tx = int(n_tx)
        self.item_of_rank = np.asarray(item_of_rank, np.int64)
        self.n_items = int(self.item_of_rank.shape[0])
        self.rank_of_item = np.empty(self.n_items, np.int64)
        self.rank_of_item[self.item_of_rank] = np.arange(self.n_items)
        self.n_frequent = int(n_frequent)
        n = self.parent.shape[0]
        self.n_nodes = n
        # depth-major ids: level d holds ids [bounds[d-1], bounds[d])
        self.bounds = np.cumsum([1, *level_sizes]).astype(np.int64)
        if int(self.bounds[-1]) != n:
            raise ValueError("level sizes do not add up to the nodes")
        depth = np.zeros(n, np.int64)
        for d, (lo, hi) in enumerate(self._levels(), start=1):
            depth[lo:hi] = d
        self.depth = depth
        self.max_depth = len(level_sizes)

        path = np.full((n, max(self.max_depth, 1)), -1, np.int64)
        for lo, hi in self._levels():
            d = int(depth[lo])
            path[lo:hi, : d - 1] = path[self.parent[lo:hi], : d - 1]
            path[lo:hi, d - 1] = self.rank[lo:hi]
        self.path = path

        # metric columns, float64, the root's zero as the program keeps it
        sup = self.count / float(max(self.n_tx, 1))
        # the root's count is |D|: its Support is 1
        psup = np.where(self.parent >= 0, sup[np.maximum(self.parent, 0)],
                        1.0)
        conf = np.where(psup > 0, sup / np.where(psup > 0, psup, 1.0), 0.0)
        item_sup = np.zeros(max(self.n_frequent, 1))
        first = (depth == 1)
        item_sup[self.rank[first]] = sup[first]
        isup = item_sup[np.maximum(self.rank, 0)]
        lift = np.where(isup > 0, conf / np.where(isup > 0, isup, 1.0), 0.0)
        sup[0] = conf[0] = lift[0] = 0.0
        self.columns = {"support": sup, "confidence": conf, "lift": lift}

        # pre-order: paths sorted lexicographically, -1 (end) first
        keys = tuple(path[:, c] for c in range(path.shape[1] - 1, -1, -1))
        self.dfs_node = np.lexsort(keys).astype(np.int64)
        self.pos = np.empty(n, np.int64)
        self.pos[self.dfs_node] = np.arange(n)
        size = np.ones(n, np.int64)
        for lo, hi in reversed(list(self._levels())):
            np.add.at(size, self.parent[lo:hi], size[lo:hi])
        self.size = size

        # child table: key = parent * stride + rank
        self.stride = self.n_frequent + 2
        ck = self.parent[1:] * self.stride + self.rank[1:]
        order = np.argsort(ck, kind="stable")
        self.child_keys = ck[order]
        self.child_ids = np.arange(1, n, dtype=np.int64)[order]
        # postings: the nodes of each rank, by DFS position
        by_rank = np.lexsort((self.pos[1:], self.rank[1:]))
        self.post_node = np.arange(1, n, dtype=np.int64)[by_rank]
        self.post_offsets = np.searchsorted(
            self.rank[1:][by_rank], np.arange(self.n_frequent + 1))

    def _levels(self):
        """``(lo, hi)`` node-id range of every depth from 1 on."""
        for d in range(1, self.bounds.shape[0]):
            yield int(self.bounds[d - 1]), int(self.bounds[d])

    # ------------------------------------------------------------------
    def ranks(self, items) -> np.ndarray:
        """Ranks of item ids; an id outside the vocabulary, or of an item
        that is not frequent, gets a rank no node has."""
        items = np.asarray(items, np.int64)
        ok = (items >= 0) & (items < self.n_items)
        r = self.rank_of_item[np.clip(items, 0, self.n_items - 1)]
        return np.where(ok & (r < self.n_frequent), r, self.n_frequent + 1)

    def child(self, nodes: np.ndarray, ranks: np.ndarray) -> np.ndarray:
        """The child of each node by the edge of each rank, -1 if none."""
        key = np.asarray(nodes, np.int64) * self.stride + ranks
        i = np.searchsorted(self.child_keys, key)
        i = np.minimum(i, max(self.child_keys.shape[0] - 1, 0))
        hit = (self.child_keys.shape[0] > 0) & (self.child_keys[i] == key)
        return np.where(hit & (nodes >= 0), self.child_ids[i], -1)

    def walk(self, rows: Sequence[Sequence[int]]) -> np.ndarray:
        """The node at the end of each rank sequence (walked as given, from
        the root), -1 where a step has no edge."""
        q = len(rows)
        width = max((len(r) for r in rows), default=0)
        mat = np.full((q, max(width, 1)), -1, np.int64)
        for i, r in enumerate(rows):
            mat[i, : len(r)] = r
        node = np.zeros(q, np.int64)
        for c in range(width):
            col = mat[:, c]
            live = col >= 0
            step = self.child(node, np.where(live, col, 0))
            node = np.where(live, step, node)
        return node

    def score_by_pos(self, metric: str) -> np.ndarray:
        """A metric column in DFS order."""
        return self.columns[metric][self.dfs_node]


def dense_columns(transactions: Sequence[Sequence[int]], n_items: int,
                  device) -> torch.Tensor:
    """``uint8 [|D|, n_items]``: which transaction holds which item."""
    lens = np.fromiter((len(t) for t in transactions), np.int64,
                       count=len(transactions))
    cols = np.fromiter((it for t in transactions for it in t), np.int64,
                       count=int(lens.sum()))
    rows = np.repeat(np.arange(len(transactions), dtype=np.int64), lens)
    d = torch.zeros((len(transactions), n_items), dtype=torch.uint8,
                    device=device)
    d[torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)] = 1
    return d


def mine(transactions: Sequence[Sequence[int]], n_items: int, minsup: float,
         max_len: int, device="cpu") -> RefTrie:
    """Every itemset of at most ``max_len`` items with Support >= minsup,
    as the reference's trie."""
    n_tx = len(transactions)
    mc = min_count(minsup, n_tx)
    d = dense_columns(transactions, n_items, device)
    counts = d.sum(dim=0, dtype=torch.int64).cpu().numpy()
    item_of_rank = np.lexsort((np.arange(n_items), -counts))
    f1 = int(np.count_nonzero(counts >= mc))
    freq = torch.from_numpy(item_of_rank[:f1]).to(device)
    dr = d[:, freq].to(torch.float64)       # frequent columns, rank order
    del d

    parents: List[np.ndarray] = [np.array([-1], np.int64),
                                 np.zeros(f1, np.int64)]
    ranks: List[np.ndarray] = [np.array([-1], np.int64),
                               np.arange(f1, dtype=np.int64)]
    cnts: List[np.ndarray] = [np.array([n_tx], np.int64),
                              counts[item_of_rank[:f1]].astype(np.int64)]
    level = torch.arange(f1, device=device)[:, None]
    level_ids = np.arange(1, f1 + 1, dtype=np.int64)
    next_id = f1 + 1
    col_rank = torch.arange(f1, device=device)[None, :]
    k = 1
    while level.shape[0] and k < max_len:
        new_sets, new_par, new_rank, new_cnt = [], [], [], []
        for b0 in range(0, level.shape[0], BLOCK):
            xb = level[b0:b0 + BLOCK]
            tx = dr[:, xb[:, 0]].clone()
            for c in range(1, xb.shape[1]):
                tx *= dr[:, xb[:, c]]
            cnt = tx.T @ dr                                  # [b, f1]
            ok = (cnt >= mc) & (col_rank > xb[:, -1:])
            bi, j = ok.nonzero(as_tuple=True)                # row-major
            new_sets.append(torch.cat([xb[bi], j[:, None]], dim=1))
            new_par.append(level_ids[b0 + bi.cpu().numpy()])
            new_rank.append(j.cpu().numpy().astype(np.int64))
            new_cnt.append(cnt[bi, j].cpu().numpy().astype(np.int64))
            del tx, cnt, ok
        level = torch.cat(new_sets) if new_sets else level[:0]
        n_new = level.shape[0]
        if n_new == 0:
            break
        parents.append(np.concatenate(new_par))
        ranks.append(np.concatenate(new_rank))
        cnts.append(np.concatenate(new_cnt))
        level_ids = np.arange(next_id, next_id + n_new, dtype=np.int64)
        next_id += n_new
        k += 1
    return RefTrie(np.concatenate(parents), np.concatenate(ranks),
                   np.concatenate(cnts), [len(r) for r in ranks[1:]], n_tx,
                   item_of_rank, f1)
