"""Frozen Trie of Rules as flat arrays: host layout and device tensors.

PyTorch port of the plain layout in ``repro.core.array_trie``:

    node_item / node_parent / node_depth          int32[N]
    support / confidence / lift                   float32[N]
    edge_parent / edge_item / edge_child          int32[E]     (sorted lex)
    child_offsets                                 int32[N+1]   (CSR buckets)
    dfs_order / subtree_size / dfs_to_node        int32[N]     (DFS layout)
    item_offsets / item_nodes                     int32[I+1]/[E] (item index)

Node ``p``'s outgoing edges are ``edge_*[child_offsets[p]:child_offsets[p+1]]``,
item-sorted, so each descent step is a binary search inside one bucket.
Node ``v``'s subtree is the DFS position range
``[dfs_order[v], dfs_order[v] + subtree_size[v])``, and item ``i``'s posting
list ``item_nodes[item_offsets[i]:item_offsets[i+1]]`` holds every node whose
consequent is ``i``, in DFS order.

The host helpers are numpy copies of the reference's, so both packages
freeze a trie to the same integers.  ``FrozenTrie.from_arrays`` takes any
frozen trie's fields as numpy arrays, and ``freeze`` numbers a pointer
``TrieOfRules`` into them; the compressed layout is a later slice of the
port.
``DeviceTrie`` holds the same columns as torch tensors on one device;
the tensor functions at the bottom are the oracles the ops use outside
any kernel (the prefix descent) and the tests compare against.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .trie import TrieNode, TrieOfRules

NO_NODE = np.int32(-1)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA on a host without a usable GPU raises: the
    port never carries on on the CPU in its place."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


# ----------------------------------------------------------------------
# host layout helpers (numpy)
# ----------------------------------------------------------------------
def canonical_prefix_rows(prefixes, item_rank=None) -> List[List[int]]:
    """Normalize Q antecedent prefixes into frequency-sorted item rows.

    In an already-padded ``[Q, P]`` matrix ``-1`` entries are padding and
    are dropped per row; in ragged sequences every element is a literal
    item, so ``-1`` there is remapped to ``-9`` and reads as "not in the
    trie".  Items sort by ``(frequency rank, item)`` when ``item_rank`` is
    given; unknown items rank last.
    """
    as_matrix = isinstance(prefixes, np.ndarray) and prefixes.ndim == 2
    rows: List[List[int]] = []
    for p in prefixes:
        if as_matrix:
            its = [int(it) for it in np.asarray(p).reshape(-1) if it != -1]
        else:
            its = [
                int(it) if int(it) != -1 else -9
                for it in np.asarray(p).reshape(-1)
            ]
        if item_rank is not None:
            nr = int(np.asarray(item_rank).shape[0])
            its.sort(
                key=lambda it: (
                    int(item_rank[it]) if 0 <= it < nr else 1 << 30, it
                )
            )
        rows.append(its)
    return rows


def sanitize_query_items(
    items, n_items: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(valid bool[Q], safe int64[Q], qitems int32[Q])``: items outside
    ``[0, n_items)`` are invalid, ``safe`` is the clipped index, and
    ``qitems`` carries ``-1`` (matched by no node) for invalid entries."""
    items = np.asarray(list(items), np.int64).reshape(-1)
    valid = (items >= 0) & (items < n_items)
    safe = np.clip(items, 0, max(n_items - 1, 0))
    qitems = np.where(valid, items, -1).astype(np.int32)
    return valid, safe, qitems


def item_tables(item_order) -> Tuple[np.ndarray, np.ndarray]:
    """``(item_order int32[n], item_rank int32[max_item+1])``; unknown
    items map to a huge rank."""
    item_order = np.asarray(list(item_order), dtype=np.int32)
    max_item = int(item_order.max()) if item_order.size else 0
    item_rank = np.full(
        (max_item + 1,), np.iinfo(np.int32).max // 2, dtype=np.int32
    )
    item_rank[item_order] = np.arange(item_order.size, dtype=np.int32)
    return item_order, item_rank


def csr_offsets_from_edges(
    edge_parent: np.ndarray, n_nodes: int
) -> Tuple[np.ndarray, int]:
    """``(child_offsets int32[N+1], max_fanout)`` over a (parent,
    item)-sorted edge table."""
    counts = np.bincount(
        np.asarray(edge_parent, dtype=np.int64), minlength=n_nodes
    )
    offsets = np.zeros((n_nodes + 1,), dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    max_fanout = int(counts.max()) if counts.size else 0
    return offsets, max_fanout


def item_index_arrays(
    node_item: np.ndarray,
    dfs_order: np.ndarray,
    n_items: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Item-inverted index: ``(item_offsets int32[I+1], item_nodes
    int32[E], max_postings)``, every non-root node grouped by its
    consequent item and sorted by DFS position within the group."""
    node_item = np.asarray(node_item, np.int64)
    dfs_order = np.asarray(dfs_order, np.int64)
    nids = np.nonzero(node_item >= 0)[0]
    items = node_item[nids]
    order = np.lexsort((dfs_order[nids], items))
    item_nodes = nids[order].astype(np.int32)
    counts = np.bincount(items, minlength=max(n_items, 0))
    offsets = np.zeros((counts.shape[0] + 1,), np.int32)
    np.cumsum(counts, out=offsets[1:])
    max_postings = int(counts.max()) if counts.size else 0
    return offsets, item_nodes, max_postings


def dfs_layout(
    node_parent: np.ndarray,
    node_depth: np.ndarray,
    edge_parent: np.ndarray,
    edge_child: np.ndarray,
    child_offsets: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DFS pre-order relabeling, children in CSR bucket order:
    ``(dfs_order, subtree_size, dfs_to_node)``, all int32[N].

    Vectorized per depth level: subtree sizes accumulate bottom-up, and a
    node's position is its parent's plus one plus the subtree sizes of
    its earlier siblings (an exclusive segmented cumsum over the bucket).
    """
    node_parent = np.asarray(node_parent, np.int64)
    node_depth = np.asarray(node_depth, np.int64)
    edge_parent = np.asarray(edge_parent, np.int64)
    edge_child = np.asarray(edge_child, np.int64)
    child_offsets = np.asarray(child_offsets, np.int64)
    n = node_parent.shape[0]
    empty = np.zeros((0,), np.int32)
    if n == 0:
        return empty, empty, empty

    max_depth = int(node_depth.max())
    by_depth = np.argsort(node_depth, kind="stable")
    bounds = np.searchsorted(node_depth[by_depth], np.arange(max_depth + 2))

    subtree_size = np.ones((n,), np.int64)
    for d in range(max_depth, 0, -1):
        nids = by_depth[bounds[d]:bounds[d + 1]]
        np.add.at(subtree_size, node_parent[nids], subtree_size[nids])

    sizes = subtree_size[edge_child]
    cum = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    earlier_siblings = cum - cum[child_offsets[edge_parent]]

    e_depth = node_depth[edge_child]
    e_by_depth = np.argsort(e_depth, kind="stable")
    e_bounds = np.searchsorted(e_depth[e_by_depth], np.arange(max_depth + 2))
    pos = np.zeros((n,), np.int64)
    for d in range(1, max_depth + 1):
        eids = e_by_depth[e_bounds[d]:e_bounds[d + 1]]
        pos[edge_child[eids]] = (
            pos[edge_parent[eids]] + 1 + earlier_siblings[eids]
        )
    dfs_to_node = np.zeros((n,), np.int32)
    dfs_to_node[pos] = np.arange(n, dtype=np.int32)
    return pos.astype(np.int32), subtree_size.astype(np.int32), dfs_to_node


# ----------------------------------------------------------------------
# frozen layout (host) and its device view
# ----------------------------------------------------------------------
@dataclass
class FrozenTrie:
    """Immutable plain-layout trie; numpy arrays on the host."""

    node_item: np.ndarray      # int32[N], root = -1
    node_parent: np.ndarray    # int32[N], root = -1
    node_depth: np.ndarray     # int32[N]
    support: np.ndarray        # float32[N]
    confidence: np.ndarray     # float32[N]
    lift: np.ndarray           # float32[N]
    edge_parent: np.ndarray    # int32[E] sorted by (parent, item)
    edge_item: np.ndarray      # int32[E]
    edge_child: np.ndarray     # int32[E]
    item_order: np.ndarray     # int32[n_items] frequency rank -> item
    item_rank: np.ndarray      # int32[max_item+1] item -> frequency rank
    child_offsets: Optional[np.ndarray] = None  # int32[N+1] CSR buckets
    max_fanout: int = 0
    dfs_order: Optional[np.ndarray] = None
    subtree_size: Optional[np.ndarray] = None
    dfs_to_node: Optional[np.ndarray] = None
    item_offsets: Optional[np.ndarray] = None
    item_nodes: Optional[np.ndarray] = None
    max_postings: int = 0

    def __post_init__(self):
        if self.child_offsets is None:
            self.child_offsets, self.max_fanout = csr_offsets_from_edges(
                self.edge_parent, self.node_item.shape[0]
            )
        if self.dfs_order is None:
            self.dfs_order, self.subtree_size, self.dfs_to_node = dfs_layout(
                self.node_parent, self.node_depth,
                self.edge_parent, self.edge_child, self.child_offsets,
            )
        if self.item_offsets is None:
            n_items = max(
                int(self.item_rank.shape[0]),
                int(self.node_item.max(initial=-1)) + 1,
            )
            self.item_offsets, self.item_nodes, self.max_postings = (
                item_index_arrays(self.node_item, self.dfs_order, n_items)
            )

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]) -> "FrozenTrie":
        """A frozen trie from its fields as numpy arrays, e.g. another
        package's ``FrozenTrie`` read field by field with ``np.asarray``.
        Fields left out are derived as ``__post_init__`` does."""
        kw = {}
        for f in fields(cls):
            if f.name not in arrays or arrays[f.name] is None:
                continue
            v = arrays[f.name]
            if f.name in ("max_fanout", "max_postings"):
                kw[f.name] = int(v)
            else:
                kw[f.name] = np.asarray(v)
        return cls(**kw)

    @classmethod
    def freeze(cls, trie: TrieOfRules) -> "FrozenTrie":
        """BFS-number the pointer trie into flat arrays."""
        nodes: List[TrieNode] = [trie.root]
        ids = {id(trie.root): 0}
        q = deque([trie.root])
        while q:
            node = q.popleft()
            for child in sorted(node.children.values(), key=lambda c: c.item):
                ids[id(child)] = len(nodes)
                nodes.append(child)
                q.append(child)
        n = len(nodes)
        node_item = np.full((n,), -1, dtype=np.int32)
        node_parent = np.full((n,), -1, dtype=np.int32)
        node_depth = np.zeros((n,), dtype=np.int32)
        support = np.zeros((n,), dtype=np.float32)
        confidence = np.zeros((n,), dtype=np.float32)
        lift = np.zeros((n,), dtype=np.float32)
        edges: List[Tuple[int, int, int]] = []
        for i, node in enumerate(nodes):
            node_item[i] = node.item
            node_depth[i] = node.depth
            support[i] = node.support
            confidence[i] = node.confidence
            lift[i] = node.lift
            if node.parent is not None:
                node_parent[i] = ids[id(node.parent)]
            for child in node.children.values():
                edges.append((i, child.item, ids[id(child)]))
        edges.sort()
        e = np.array(edges, dtype=np.int32).reshape(-1, 3)
        rank_pairs = sorted(trie._rank.items(), key=lambda kv: kv[1])
        item_order, item_rank = item_tables([it for it, _ in rank_pairs])
        return cls(
            node_item=node_item,
            node_parent=node_parent,
            node_depth=node_depth,
            support=support,
            confidence=confidence,
            lift=lift,
            edge_parent=e[:, 0].copy() if e.size else np.zeros(0, np.int32),
            edge_item=e[:, 1].copy() if e.size else np.zeros(0, np.int32),
            edge_child=e[:, 2].copy() if e.size else np.zeros(0, np.int32),
            item_order=item_order,
            item_rank=item_rank,
        )

    @property
    def n_nodes(self) -> int:
        return int(self.node_item.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edge_parent.shape[0])

    @property
    def max_depth(self) -> int:
        return int(self.node_depth.max()) if self.n_nodes > 1 else 0

    def canonicalize_queries(
        self,
        antecedents: Sequence[Sequence[int]],
        consequents: Sequence[Sequence[int]],
        max_len: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pack (A, C) query pairs into the padded item matrix + antecedent
        lengths; A and C are frequency-sorted independently."""
        def rank(it: int) -> int:
            if 0 <= it < self.item_rank.shape[0]:
                return int(self.item_rank[it])
            return 1 << 30

        rows: List[List[int]] = []
        ant_lens: List[int] = []
        for a, c in zip(antecedents, consequents):
            sa = sorted(a, key=lambda it: (rank(it), it))
            sc = sorted(c, key=lambda it: (rank(it), it))
            rows.append(list(sa) + list(sc))
            ant_lens.append(len(sa))
        width = max_len or max((len(r) for r in rows), default=1)
        mat = np.full((len(rows), width), -1, dtype=np.int32)
        for i, r in enumerate(rows):
            if len(r) > width:
                raise ValueError("query longer than max_len")
            mat[i, : len(r)] = r
        return mat, np.array(ant_lens, dtype=np.int32)

    def device_arrays(self, device=None) -> "DeviceTrie":
        """Upload the layout to ``device`` (CUDA unless named)."""
        dev = resolve_device(device)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return DeviceTrie(
            node_item=t(self.node_item),
            node_parent=t(self.node_parent),
            node_depth=t(self.node_depth),
            support=t(self.support),
            confidence=t(self.confidence),
            lift=t(self.lift),
            edge_parent=t(self.edge_parent),
            edge_item=t(self.edge_item),
            edge_child=t(self.edge_child),
            child_offsets=t(self.child_offsets),
            max_fanout=int(self.max_fanout),
            dfs_order=t(self.dfs_order),
            subtree_size=t(self.subtree_size),
            dfs_to_node=t(self.dfs_to_node),
            item_offsets=t(self.item_offsets),
            item_nodes=t(self.item_nodes),
            max_postings=int(self.max_postings),
        )

    def path_items(self, node_id: int) -> Tuple[int, ...]:
        items: List[int] = []
        nid = int(node_id)
        while nid > 0:
            items.append(int(self.node_item[nid]))
            nid = int(self.node_parent[nid])
        return tuple(reversed(items))


@dataclass
class DeviceTrie:
    """The frozen layout as torch tensors on one device.  ``max_fanout``
    and ``max_postings`` stay host ints; ``child_offsets=None`` marks the
    seed full-sweep layout, which this package does not run yet."""

    node_item: torch.Tensor
    node_parent: torch.Tensor
    node_depth: torch.Tensor
    support: torch.Tensor
    confidence: torch.Tensor
    lift: torch.Tensor
    edge_parent: torch.Tensor
    edge_item: torch.Tensor
    edge_child: torch.Tensor
    child_offsets: Optional[torch.Tensor] = None
    max_fanout: int = 0
    dfs_order: Optional[torch.Tensor] = None
    subtree_size: Optional[torch.Tensor] = None
    dfs_to_node: Optional[torch.Tensor] = None
    item_offsets: Optional[torch.Tensor] = None
    item_nodes: Optional[torch.Tensor] = None
    max_postings: int = 0
    layout: str = "plain"

    @property
    def device(self) -> torch.device:
        return self.support.device

    def nbytes(self) -> int:
        """Device-resident bytes across all present tensors."""
        return sum(
            int(v.numel()) * v.element_size()
            for v in vars(self).values() if isinstance(v, torch.Tensor)
        )


# ----------------------------------------------------------------------
# tensor oracles
# ----------------------------------------------------------------------
def _n_search_steps(n_edges: int) -> int:
    n = max(int(n_edges), 1)
    return int(np.ceil(np.log2(n + 1))) + 1


def bucket_edge_lookup(
    child_offsets: torch.Tensor,
    edge_item: torch.Tensor,
    max_fanout: int,
    parents: torch.Tensor,
    items: torch.Tensor,
) -> torch.Tensor:
    """Batched CSR-bucket lower bound: the edge index of ``(parents,
    items)``, -1 where there is no such edge (int32, shape of
    ``parents``)."""
    e = edge_item.shape[0]
    parents = parents.to(torch.int32)
    if e == 0:
        return torch.full_like(parents, -1)
    items = items.to(torch.int32)
    n = child_offsets.shape[0] - 1
    p_ok = (parents >= 0) & (parents < n)
    p = parents.clamp(0, n - 1).long()
    lo = child_offsets[p]
    bucket_hi = child_offsets[p + 1]
    hi = bucket_hi
    for _ in range(_n_search_steps(max(max_fanout, 1))):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        midc = mid.clamp(max=e - 1).long()
        less = edge_item[midc] < items
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    loc = lo.clamp(max=e - 1)
    found = p_ok & (lo < bucket_hi) & (edge_item[loc.long()] == items)
    return torch.where(found, loc, -1).to(torch.int32)


def child_lookup(
    trie: DeviceTrie, parents: torch.Tensor, items: torch.Tensor
) -> torch.Tensor:
    """Batched child id for (parent, item); -1 where there is no edge."""
    if trie.edge_parent.shape[0] == 0:
        return torch.full_like(parents.to(torch.int32), -1)
    if trie.child_offsets is None:
        raise NotImplementedError(
            "the seed full-sweep layout (child_offsets is None) is not "
            "ported yet: ROADMAP Queue 2 row 7"
        )
    j = bucket_edge_lookup(
        trie.child_offsets, trie.edge_item, trie.max_fanout, parents, items
    )
    return torch.where(
        j >= 0, trie.edge_child[j.clamp(min=0).long()], -1
    ).to(torch.int32)


def batched_rule_search(
    trie: DeviceTrie, queries: torch.Tensor, ant_len: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Search Q canonical rule rows (int32[Q, L], -1 padded) node-column
    style: one ``child_lookup`` per column for the full path and one for
    the root-anchored consequent walk, then the Eq. 1-4 lift."""
    queries = queries.to(torch.int32)
    ant_len = ant_len.to(torch.int32)
    q, width = queries.shape
    dev = queries.device
    node = torch.zeros((q,), dtype=torch.int32, device=dev)
    conf = torch.ones((q,), dtype=torch.float32, device=dev)
    ok = torch.ones((q,), dtype=torch.bool, device=dev)
    cnode = node.clone()
    cok = ok.clone()
    for s in range(width):
        item = queries[:, s]
        active = (item >= 0) & ok
        child = child_lookup(trie, node, item)
        hit = child >= 0
        ok = torch.where(active, hit, ok)
        in_cons = s >= ant_len
        child_conf = torch.where(
            hit, trie.confidence[child.clamp(min=0).long()], 0.0
        )
        conf = torch.where(active & in_cons & hit, conf * child_conf, conf)
        node = torch.where(active & hit, child, node)

        c_active = (item >= 0) & in_cons & cok
        cchild = child_lookup(trie, cnode, item)
        cok = torch.where(c_active, cchild >= 0, cok)
        cnode = torch.where(c_active & (cchild >= 0), cchild, cnode)
    con_support = torch.where(
        cok & (cnode > 0), trie.support[cnode.clamp(min=0).long()], 0.0
    )
    found = ok & (node > 0)
    nid = node.clamp(min=0).long()
    sup = torch.where(found, trie.support[nid], 0.0)
    conf = torch.where(found, conf, 0.0)
    seq_len = (queries >= 0).sum(dim=1, dtype=torch.int32)
    single = (seq_len - ant_len) == 1
    node_lift = torch.where(found, trie.lift[nid], 0.0)
    has_c = con_support > 0
    lift = torch.where(
        single, node_lift,
        torch.where(
            has_c, conf / torch.where(has_c, con_support, 1.0), 0.0
        ),
    )
    return {
        "found": found,
        "support": sup,
        "confidence": conf,
        "lift": torch.where(found, lift, 0.0),
        "node": torch.where(found, node, -1).to(torch.int32),
    }


def top_n_nodes(trie: DeviceTrie, metric: torch.Tensor, n: int,
                min_depth: int = 1):
    """Top-n node ids by a metric column, nodes at ``depth >= min_depth``
    only: ``(values f32[n], ids int32[n])`` by (value desc, id asc)."""
    masked = torch.where(trie.node_depth >= min_depth, metric, -torch.inf)
    vals, ids = torch.sort(masked, descending=True, stable=True)
    return vals[:n], ids[:n].to(torch.int32)


def traverse_reduce(trie: DeviceTrie) -> Dict[str, torch.Tensor]:
    """Visit every rule once: count, Σ support, max confidence (0 when no
    rule is live), and mean confidence."""
    mask = trie.node_depth > 0
    n = mask.sum(dtype=torch.int32)
    masked_conf = torch.where(mask, trie.confidence, -torch.inf)
    conf_max = masked_conf.amax() if mask.numel() else masked_conf.sum()
    return {
        "n_rules": n,
        "support_sum": torch.where(mask, trie.support, 0.0).sum(),
        "confidence_max": torch.where(n > 0, conf_max, 0.0),
        "mean_conf": torch.where(mask, trie.confidence, 0.0).sum()
        / n.clamp(min=1),
    }
