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
``TrieOfRules`` into them.

``FrozenTrie.compress`` builds the path-compressed layout
(``CompressedTrie``): in DFS-position space every maximal single-child run
is a contiguous interval, so only run heads, tails and branching nodes
keep CSR rows; a kept edge carries ``(item, child position, interior
steps, tail id)``, and the metric columns are position-indexed and may be
quantized (int32 support counts, bf16 or int8 confidence and lift).
``FrozenTrie.device_arrays(layout="plain" | "compressed" | "auto")``
uploads either layout.

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
# path compression (Patricia spans) and quantized metric columns
# ----------------------------------------------------------------------
# layout="auto" compresses when at least this fraction of the edges sit on
# single-child chains
AUTO_COMPRESS_SPAN_FRACTION = 0.5


def chain_spans(child_counts_pos: np.ndarray):
    """Chain-run detector in DFS-position space: ``(is_span bool[N],
    run_end int64[N])``.

    A position is a span position when its node has exactly one child and
    is not the root; its child is the next pre-order position, so each
    maximal single-child run is a contiguous interval and detection is one
    boolean scan.  ``run_end[p]`` is the first non-span position at or
    after ``p``: the run's tail for any span position.
    """
    cc = np.asarray(child_counts_pos, np.int64)
    n = cc.shape[0]
    is_span = cc == 1
    if n:
        is_span[0] = False  # the root always keeps its CSR row
    idx = np.arange(n, dtype=np.int64)
    nonspan = np.where(~is_span, idx, n)
    run_end = np.minimum.accumulate(nonspan[::-1])[::-1] if n else nonspan
    return is_span, run_end


def compress_pos_space(
    child_counts_pos: np.ndarray,
    edge_parent_pos: np.ndarray,
    edge_item: np.ndarray,
    edge_child_pos: np.ndarray,
) -> Dict[str, object]:
    """The compressed encoding, everything in DFS-position space.

    Only edges whose parent keeps a CSR row survive; each records its
    child's position, the number of span steps after it and the compressed
    id of the run's tail, whose bucket continues the descent.  Returns
    ``is_span``, ``cnode_of_pos``, ``child_offsets`` (int32[Nc+1]),
    ``edge_parent`` (compressed ids), ``edge_item``, ``edge_pos``,
    ``edge_span``, ``edge_tail`` and ``max_fanout``.
    """
    cc = np.asarray(child_counts_pos, np.int64)
    ep = np.asarray(edge_parent_pos, np.int64)
    ei = np.asarray(edge_item, np.int64)
    ec = np.asarray(edge_child_pos, np.int64)
    is_span, run_end = chain_spans(cc)
    cnode_of_pos = np.cumsum(~is_span) - 1
    n_cnodes = int(cnode_of_pos[-1]) + 1 if cc.shape[0] else 0

    keep = ~is_span[ep] if ep.size else np.zeros((0,), bool)
    kp = cnode_of_pos[ep[keep]]
    ki = ei[keep]
    kc = ec[keep]
    order = np.lexsort((ki, kp))  # bucket-major, item-sorted inside
    kp, ki, kc = kp[order], ki[order], kc[order]
    span = np.where(is_span[kc], run_end[kc] - kc, 0)
    tail = cnode_of_pos[kc + span]

    counts = np.bincount(kp, minlength=max(n_cnodes, 0))
    offsets = np.zeros((n_cnodes + 1,), np.int32)
    np.cumsum(counts, out=offsets[1:])
    return {
        "is_span": is_span,
        "cnode_of_pos": cnode_of_pos.astype(np.int32),
        "child_offsets": offsets,
        "edge_parent": kp.astype(np.int32),
        "edge_item": ki.astype(np.int32),
        "edge_pos": kc.astype(np.int32),
        "edge_span": span.astype(np.int32),
        "edge_tail": tail.astype(np.int32),
        "max_fanout": int(counts.max()) if counts.size else 0,
    }


def quantize_metric_columns(
    support: np.ndarray,
    confidence: np.ndarray,
    lift: np.ndarray,
    n_transactions: int = 0,
    columns: str = "bf16",
):
    """Narrow the three metric columns of the compressed layout.

    * ``support`` becomes exact int32 transaction counts when
      ``n_transactions`` is known (``dequantize_metrics`` rebuilds the
      ratio), else bf16;
    * ``confidence`` and ``lift`` become bf16 (default) or int8 codes of
      ``distributed.compression.quantize_int8`` with a per-column f32
      scale.

    numpy has no bf16, so a bf16 column is a CPU ``torch.bfloat16``
    tensor; the others are numpy.  Returns ``(support_q, confidence_q,
    lift_q, n_transactions, confidence_scale, lift_scale)``.
    """
    if columns not in ("bf16", "int8"):
        raise ValueError(f"unknown quantized column dtype {columns!r}")

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    if n_transactions and n_transactions > 0:
        sup_q = np.rint(
            np.asarray(support, np.float64) * float(n_transactions)
        ).astype(np.int32)
    else:
        n_transactions = 0
        sup_q = bf16(support)
    conf_scale = lift_scale = 1.0
    if columns == "int8":
        from repro_torch.distributed.compression import quantize_int8

        cq, cs = quantize_int8(torch.from_numpy(np.asarray(confidence,
                                                           np.float32)))
        lq, ls = quantize_int8(torch.from_numpy(np.asarray(lift, np.float32)))
        conf_q, lift_q = cq.numpy(), lq.numpy()
        conf_scale, lift_scale = float(cs), float(ls)
    else:
        conf_q, lift_q = bf16(confidence), bf16(lift)
    return sup_q, conf_q, lift_q, int(n_transactions), conf_scale, lift_scale


def _sorted_posting_bounds(
    item_offsets: np.ndarray,
    item_nodes: np.ndarray,
    dfs_order: np.ndarray,
    subtree_size: np.ndarray,
):
    """Posting subtree ranges in DFS coordinates: ``post_lo`` in posting
    order (ascending per item), ``post_hi`` re-sorted ascending within each
    item's segment: the two sorted sides of the membership count."""
    nodes = np.asarray(item_nodes, np.int64)
    dfs = np.asarray(dfs_order, np.int64)
    sub = np.asarray(subtree_size, np.int64)
    n = int(dfs.shape[0])
    lo = dfs[nodes]
    hi = lo + sub[nodes]
    seg = np.repeat(
        np.arange(item_offsets.shape[0] - 1, dtype=np.int64),
        np.diff(item_offsets),
    )
    order = np.argsort(seg * (n + 1) + hi, kind="stable")
    return lo.astype(np.int32), hi[order].astype(np.int32)


def _host_nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return int(a.numel()) * a.element_size()
    return int(np.asarray(a).nbytes)


@dataclass
class CompressedTrie:
    """Path-compressed frozen layout on the host, in DFS-position space.

    Node-axis columns (``*_pos``) are indexed by DFS position; structural
    rows exist only in the compressed CSR (``child_offsets``/``edge_*``)
    over run heads, tails and branching nodes.  The metric columns are
    numpy f32/int32/int8, or CPU ``torch.bfloat16`` tensors.
    ``device_arrays`` reuses ``DeviceTrie`` with ``layout="compressed"``:
    the node columns carry the position-space arrays, ``edge_child`` the
    child positions, ``edge_span``/``edge_tail`` the spans.
    """

    item_pos: np.ndarray        # int32[N]  DFS-ordered consequent items
    depth_pos: np.ndarray       # int32[N]
    subtree_pos: np.ndarray     # int32[N]  subtree sizes, DFS order
    dfs_to_node: np.ndarray     # int32[N]  position -> original node id
    support_pos: object         # f32|int32|bf16[N]
    confidence_pos: object      # f32|bf16|int8[N]
    lift_pos: object            # f32|bf16|int8[N]
    child_offsets: np.ndarray   # int32[Nc+1] compressed CSR
    edge_parent: np.ndarray     # int32[Ec]  compressed parent ids
    edge_item: np.ndarray       # int32[Ec]  first item of the edge
    edge_pos: np.ndarray        # int32[Ec]  child DFS position
    edge_span: np.ndarray       # int32[Ec]  interior steps after the child
    edge_tail: np.ndarray       # int32[Ec]  compressed id of the run tail
    max_fanout: int
    item_offsets: np.ndarray    # int32[I+1] posting buckets
    post_lo: np.ndarray         # int32[E]   posting DFS starts
    post_hi: np.ndarray         # int32[E]   posting DFS ends (sorted/item)
    max_postings: int
    n_transactions: int = 0     # 0: support is not count-encoded
    confidence_scale: float = 1.0
    lift_scale: float = 1.0

    @property
    def n_nodes(self) -> int:
        return int(self.item_pos.shape[0])

    @property
    def n_edges(self) -> int:
        """Logical (uncompressed) edge count."""
        return self.n_nodes - 1 if self.n_nodes else 0

    @property
    def n_compressed_edges(self) -> int:
        return int(self.edge_item.shape[0])

    @property
    def span_fraction(self) -> float:
        """Fraction of logical edges absorbed into spans."""
        e = self.n_edges
        return 1.0 - self.n_compressed_edges / e if e else 0.0

    def nbytes(self) -> int:
        """Bytes of the device-resident layout."""
        return sum(
            _host_nbytes(a)
            for a in (
                self.item_pos, self.depth_pos, self.subtree_pos,
                self.dfs_to_node, self.support_pos, self.confidence_pos,
                self.lift_pos, self.child_offsets, self.edge_parent,
                self.edge_item, self.edge_pos, self.edge_span,
                self.edge_tail, self.item_offsets, self.post_lo,
                self.post_hi,
            )
        )

    def expand_edges(self):
        """Re-expand the spans into every logical edge: ``(parent_pos,
        item, child_pos)`` in child-position order.  Inside a span each
        position is the child of the one before it; run heads attach to
        their compressed parent's position."""
        n = self.n_nodes
        parents = np.full((n,), -1, np.int64)
        ec = np.asarray(self.edge_pos, np.int64)
        es = np.asarray(self.edge_span, np.int64)
        is_cnode = np.ones((n,), bool)
        for c, s in zip(ec, es):
            parents[c + 1:c + s + 1] = np.arange(c, c + s)
            is_cnode[c:c + s] = False
        cpos = np.nonzero(is_cnode)[0]
        parents[ec] = cpos[np.asarray(self.edge_parent, np.int64)]
        child = np.arange(1, n, dtype=np.int64)
        return parents[1:], np.asarray(self.item_pos, np.int64)[1:], child

    def device_arrays(self, device=None) -> "DeviceTrie":
        """Upload to ``device`` (CUDA unless named) as a compressed
        ``DeviceTrie``; quantized columns keep their storage dtype."""
        dev = resolve_device(device)

        def t(a):
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return DeviceTrie(
            node_item=t(self.item_pos),
            node_parent=torch.zeros((0,), dtype=torch.int32, device=dev),
            node_depth=t(self.depth_pos),
            support=t(self.support_pos),
            confidence=t(self.confidence_pos),
            lift=t(self.lift_pos),
            edge_parent=t(self.edge_parent),
            edge_item=t(self.edge_item),
            edge_child=t(self.edge_pos),
            child_offsets=t(self.child_offsets),
            max_fanout=int(self.max_fanout),
            dfs_order=None,
            subtree_size=t(self.subtree_pos),
            dfs_to_node=t(self.dfs_to_node),
            item_offsets=t(self.item_offsets),
            item_nodes=None,
            max_postings=int(self.max_postings),
            edge_span=t(self.edge_span),
            edge_tail=t(self.edge_tail),
            post_lo=t(self.post_lo),
            post_hi=t(self.post_hi),
            layout="compressed",
            n_transactions=int(self.n_transactions),
            confidence_scale=float(self.confidence_scale),
            lift_scale=float(self.lift_scale),
        )


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

    def device_arrays(
        self,
        device=None,
        layout: str = "plain",
        quantize: bool = False,
        n_transactions: int = 0,
        columns: str = "bf16",
    ) -> "DeviceTrie":
        """Upload the layout to ``device`` (CUDA unless named).

        ``layout`` is ``"plain"``, ``"compressed"`` (``compress``) or
        ``"auto"``: compressed when at least
        ``AUTO_COMPRESS_SPAN_FRACTION`` of the edges sit on single-child
        chains.  The quantization arguments apply to the compressed
        layout only.
        """
        if layout not in ("plain", "compressed", "auto"):
            raise ValueError(f"unknown layout {layout!r}")
        if layout == "auto":
            layout = (
                "compressed"
                if self.span_fraction() >= AUTO_COMPRESS_SPAN_FRACTION
                else "plain"
            )
        if layout == "compressed":
            return self.compress(
                quantize=quantize, n_transactions=n_transactions,
                columns=columns,
            ).device_arrays(device)
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

    def span_fraction(self) -> float:
        """Fraction of edges path compression absorbs: non-root nodes with
        exactly one child, over all edges."""
        if self.n_edges == 0:
            return 0.0
        cc = np.diff(np.asarray(self.child_offsets, np.int64))
        return int(np.count_nonzero(cc[1:] == 1)) / self.n_edges

    def compress(
        self,
        quantize: bool = False,
        n_transactions: int = 0,
        columns: str = "bf16",
    ) -> CompressedTrie:
        """The path-compressed layout.  ``quantize=True`` narrows the
        metric columns (``quantize_metric_columns``): pass the mining DB's
        ``n_transactions`` for exact int32 support counts, and ``columns``
        ``"bf16"`` or ``"int8"`` for confidence and lift."""
        dfs = np.asarray(self.dfs_order, np.int64)
        d2n = np.asarray(self.dfs_to_node, np.int64)
        cc = np.diff(np.asarray(self.child_offsets, np.int64))
        comp = compress_pos_space(
            cc[d2n] if d2n.size else cc,
            dfs[self.edge_parent] if self.n_edges else self.edge_parent,
            self.edge_item,
            dfs[self.edge_child] if self.n_edges else self.edge_child,
        )
        sup = np.asarray(self.support, np.float32)[d2n]
        conf = np.asarray(self.confidence, np.float32)[d2n]
        lift = np.asarray(self.lift, np.float32)[d2n]
        conf_scale = lift_scale = 1.0
        n_tx = 0
        if quantize:
            sup, conf, lift, n_tx, conf_scale, lift_scale = (
                quantize_metric_columns(
                    sup, conf, lift, n_transactions, columns
                )
            )
        post_lo, post_hi = _sorted_posting_bounds(
            self.item_offsets, self.item_nodes,
            self.dfs_order, self.subtree_size,
        )
        return CompressedTrie(
            item_pos=np.asarray(self.node_item, np.int32)[d2n],
            depth_pos=np.asarray(self.node_depth, np.int32)[d2n],
            subtree_pos=np.asarray(self.subtree_size, np.int32)[d2n],
            dfs_to_node=np.asarray(self.dfs_to_node, np.int32),
            support_pos=sup,
            confidence_pos=conf,
            lift_pos=lift,
            child_offsets=comp["child_offsets"],
            edge_parent=comp["edge_parent"],
            edge_item=comp["edge_item"],
            edge_pos=comp["edge_pos"],
            edge_span=comp["edge_span"],
            edge_tail=comp["edge_tail"],
            max_fanout=comp["max_fanout"],
            item_offsets=np.asarray(self.item_offsets, np.int32),
            post_lo=post_lo,
            post_hi=post_hi,
            max_postings=self.max_postings,
            n_transactions=n_tx,
            confidence_scale=conf_scale,
            lift_scale=lift_scale,
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
    seed full-sweep layout, which this package does not run yet.

    ``layout="compressed"`` (``CompressedTrie.device_arrays``): the node
    columns are DFS-position-indexed, ``edge_child`` holds child
    positions, ``edge_span``/``edge_tail`` drive the span-aware descent,
    ``post_lo``/``post_hi`` are the posting subtree ranges (``item_nodes``
    and ``dfs_order`` are None, ``node_parent`` is empty), and the metric
    columns may be quantized: ``n_transactions``, ``confidence_scale`` and
    ``lift_scale`` parameterize their widening to f32.
    """

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
    edge_span: Optional[torch.Tensor] = None   # int32[Ec] compressed only
    edge_tail: Optional[torch.Tensor] = None   # int32[Ec] compressed only
    post_lo: Optional[torch.Tensor] = None     # int32[E]  compressed only
    post_hi: Optional[torch.Tensor] = None     # int32[E]  compressed only
    layout: str = "plain"
    n_transactions: int = 0
    confidence_scale: float = 1.0
    lift_scale: float = 1.0

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


def count_reciprocal(n_transactions: int) -> float:
    """``f32(1 / max(n, 1))``: the factor an int32 support count is
    multiplied by, taken in f64 and rounded to f32 once."""
    return float(np.float32(1.0 / max(int(n_transactions), 1)))


def _widen_column(col: torch.Tensor, scale: float) -> torch.Tensor:
    """One confidence or lift column of ``dequantize_metrics``."""
    if col.dtype == torch.float32:
        return col
    if col.dtype == torch.int8:
        # inverse of distributed.compression.quantize_int8 (q * scale)
        return col.to(torch.float32) * torch.tensor(
            np.float32(scale), device=col.device)
    return col.to(torch.float32)


def dequantize_metrics(
    support, confidence, lift,
    n_transactions: int = 0,
    confidence_scale: float = 1.0,
    lift_scale: float = 1.0,
):
    """f32 ``(support, confidence, lift)`` from possibly quantized storage
    columns (``kernels.metrics_inkernel`` re-exports it; its kernels'
    twin is ``csrc/metrics.cuh::dequantize``).  An int32 support count is
    multiplied by ``count_reciprocal(n_transactions)``: one correctly
    rounded f32 multiply.  (The reference's ``_dequantized_columns``
    writes a divide, which its jitted callers compile to this multiply
    and an eager call does not: ROADMAP Queue 3.)  f32 columns come back
    as they are (no copy)."""
    if support.dtype == torch.int32:
        support = support.to(torch.float32) * torch.tensor(
            np.float32(count_reciprocal(n_transactions)),
            device=support.device)
    elif support.dtype != torch.float32:
        support = support.to(torch.float32)
    return (
        support,
        _widen_column(confidence, confidence_scale),
        _widen_column(lift, lift_scale),
    )


def _dequantized_columns(trie: DeviceTrie):
    """f32 views of a trie's three metric columns (``dequantize_metrics``
    with the trie's own scalars)."""
    return dequantize_metrics(
        trie.support, trie.confidence, trie.lift, trie.n_transactions,
        trie.confidence_scale, trie.lift_scale)


def span_step(node_item, child_offsets, edge_item, edge_pos, edge_span,
              edge_tail, max_fanout: int, pos, rem, ctail, items):
    """One item of the span-aware descent over the compressed layout's
    arrays: ``compressed_step`` on a ``DeviceTrie``, and the span search's
    plain version (``kernels.ref.rule_search_span_ref``) on the arrays a
    kernel takes."""
    n = node_item.shape[0]
    items = items.to(torch.int32)
    in_span = rem > 0
    nxt = (pos + 1).clamp(max=n - 1).long()
    span_hit = in_span & (node_item[nxt] == items)
    j = bucket_edge_lookup(child_offsets, edge_item, max_fanout, ctail,
                           items)
    edge_hit = (~in_span) & (j >= 0)
    if edge_pos.shape[0]:
        jc = j.clamp(min=0).long()
        e_pos, e_span, e_tail = edge_pos[jc], edge_span[jc], edge_tail[jc]
    else:  # single-node trie: no edges to gather from
        e_pos = e_span = e_tail = torch.zeros_like(pos)
    pos = torch.where(span_hit, pos + 1, torch.where(edge_hit, e_pos, pos))
    rem = torch.where(span_hit, rem - 1, torch.where(edge_hit, e_span, rem))
    ctail = torch.where(edge_hit, e_tail, ctail)
    return pos, rem, ctail, span_hit | edge_hit


def compressed_step(
    trie: DeviceTrie,
    pos: torch.Tensor,
    rem: torch.Tensor,
    ctail: torch.Tensor,
    items: torch.Tensor,
):
    """One item of the span-aware descent on a compressed trie.

    State per query: ``pos`` (DFS position), ``rem`` (span steps left
    before the next CSR node) and ``ctail`` (compressed id of the run's
    tail, whose bucket continues the descent).  Inside a span the next
    position is the only child, so the probe is one gather of the item
    column; at a CSR node it is a bucket binary search.  Returns the
    advanced ``(pos, rem, ctail, hit)``; callers gate the update on their
    own activity mask.
    """
    return span_step(
        trie.node_item, trie.child_offsets, trie.edge_item, trie.edge_child,
        trie.edge_span, trie.edge_tail, trie.max_fanout, pos, rem, ctail,
        items,
    )


def compressed_descend(trie: DeviceTrie, queries: torch.Tensor,
                       pad: Optional[int] = None):
    """Padded item rows (int32[Q, L]) to DFS positions on a compressed
    trie: ``(pos int32[Q], found bool[Q])``, the root for all-padding
    rows.  Every negative item is padding (the reference's rule), or with
    ``pad`` only that value is, and another negative item is a live one
    that no edge carries (``ops.prefix_ranges``)."""
    queries = queries.to(torch.int32)
    q = queries.shape[0]
    z = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    pos, rem, ctail = z, z, z
    ok = torch.ones((q,), dtype=torch.bool, device=queries.device)
    for s in range(queries.shape[1]):
        items = queries[:, s]
        live = items >= 0 if pad is None else items != pad
        active = live & ok
        pos2, rem2, ctail2, hit = compressed_step(trie, pos, rem, ctail,
                                                  items)
        ok = torch.where(active, hit, ok)
        adv = active & hit
        pos = torch.where(adv, pos2, pos)
        rem = torch.where(adv, rem2, rem)
        ctail = torch.where(adv, ctail2, ctail)
    return pos, ok


def _batched_rule_search_compressed(
    trie: DeviceTrie, queries: torch.Tensor, ant_len: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Span-aware twin of the plain search below: the same per-column
    confidence product and Eq. 1-4 select, so unquantized answers equal
    the plain layout's bitwise; ``node`` maps back through
    ``dfs_to_node``."""
    q, width = queries.shape
    dev = queries.device
    sup_col, conf_col, lift_col = _dequantized_columns(trie)
    z = torch.zeros((q,), dtype=torch.int32, device=dev)
    ok0 = torch.ones((q,), dtype=torch.bool, device=dev)

    pos, rem, ctail, ok = z, z, z, ok0
    conf = torch.ones((q,), dtype=torch.float32, device=dev)
    for s in range(width):
        item = queries[:, s]
        active = (item >= 0) & ok
        pos2, rem2, ctail2, hit = compressed_step(trie, pos, rem, ctail,
                                                  item)
        ok = torch.where(active, hit, ok)
        adv = active & hit
        conf = torch.where(adv & (s >= ant_len),
                           conf * conf_col[pos2.long()], conf)
        pos = torch.where(adv, pos2, pos)
        rem = torch.where(adv, rem2, rem)
        ctail = torch.where(adv, ctail2, ctail)

    cp, crem, cctail, cok = z, z, z, ok0
    for s in range(width):
        item = queries[:, s]
        active = (item >= 0) & (s >= ant_len) & cok
        p2, r2, t2, hit = compressed_step(trie, cp, crem, cctail, item)
        cok = torch.where(active, hit, cok)
        adv = active & hit
        cp = torch.where(adv, p2, cp)
        crem = torch.where(adv, r2, crem)
        cctail = torch.where(adv, t2, cctail)
    con_support = torch.where(cok & (cp > 0), sup_col[cp.long()], 0.0)

    found = ok & (pos > 0)
    pl = pos.long()
    sup = torch.where(found, sup_col[pl], 0.0)
    conf = torch.where(found, conf, 0.0)
    seq_len = (queries >= 0).sum(dim=1, dtype=torch.int32)
    single = (seq_len - ant_len) == 1
    node_lift = torch.where(found, lift_col[pl], 0.0)
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
        "node": torch.where(found, trie.dfs_to_node[pl], -1).to(torch.int32),
    }


def batched_rule_search(
    trie: DeviceTrie, queries: torch.Tensor, ant_len: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Search Q canonical rule rows (int32[Q, L], -1 padded) node-column
    style: one ``child_lookup`` per column for the full path and one for
    the root-anchored consequent walk, then the Eq. 1-4 lift.  A
    compressed trie descends span-aware (``compressed_step``)."""
    if trie.layout == "compressed":
        return _batched_rule_search_compressed(
            trie, queries.to(torch.int32), ant_len.to(torch.int32))
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
    rule is live), and mean confidence.  Layout-agnostic: quantized
    columns widen to f32 first (``_dequantized_columns``)."""
    sup_col, conf_col, _ = _dequantized_columns(trie)
    mask = trie.node_depth > 0
    n = mask.sum(dtype=torch.int32)
    masked_conf = torch.where(mask, conf_col, -torch.inf)
    conf_max = masked_conf.amax() if mask.numel() else masked_conf.sum()
    return {
        "n_rules": n,
        "support_sum": torch.where(mask, sup_col, 0.0).sum(),
        "confidence_max": torch.where(n > 0, conf_max, 0.0),
        "mean_conf": torch.where(mask, conf_col, 0.0).sum()
        / n.clamp(min=1),
    }
