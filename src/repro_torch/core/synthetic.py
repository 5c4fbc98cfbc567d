"""Deterministic synthetic tries and query mixes (numpy, host-side).

Copies of ``repro.core.synthetic``'s generators: from the same seed they
give the same integers and floats, so the port's tests and
``chip_smoke.py`` can build the tries the reference's benches use without
importing the reference.  The dicts mirror ``FrozenTrie``'s fields.  The
hypothesis strategies ``transaction_dbs`` / ``db_and_minsup`` at the
bottom exist where hypothesis is installed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .array_trie import (
    FrozenTrie,
    csr_offsets_from_edges,
    dfs_layout,
    item_index_arrays,
    item_tables,
)


def _layout_fields(parent, item, depth, edge_parent, edge_item, edge_child,
                   conf, sup, lift, n_items) -> Dict[str, np.ndarray]:
    n_nodes = parent.shape[0]
    offsets, max_fanout = csr_offsets_from_edges(edge_parent, n_nodes)
    dfs_order, subtree_size, dfs_to_node = dfs_layout(
        parent, depth, edge_parent, edge_child, offsets
    )
    item_offsets, item_nodes, max_postings = item_index_arrays(
        item, dfs_order, n_items
    )
    return {
        "node_parent": parent, "node_item": item, "node_depth": depth,
        "confidence": conf, "support": sup, "lift": lift,
        "edge_parent": edge_parent, "edge_item": edge_item,
        "edge_child": edge_child,
        "child_offsets": offsets, "max_fanout": max_fanout,
        "dfs_order": dfs_order, "subtree_size": subtree_size,
        "dfs_to_node": dfs_to_node,
        "item_offsets": item_offsets, "item_nodes": item_nodes,
        "max_postings": max_postings,
    }


def synthetic_csr_trie(
    n_edges: int, root_fanout: int = 0, fanout: int = 8, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Trie at a target edge count: a hub root with ``root_fanout``
    children (default ``min(256, max(16, n_edges // 16))``) over a
    ``fanout``-ary body, metrics drawn from ``seed``."""
    n_nodes = n_edges + 1
    parent = np.full(n_nodes, -1, np.int32)
    item = np.full(n_nodes, -1, np.int32)
    if root_fanout <= 0:
        root_fanout = min(256, max(16, n_edges // 16))
    r = min(root_fanout, n_edges)
    first = np.arange(1, r + 1)
    parent[first] = 0
    item[first] = (first - 1).astype(np.int32)
    rest = np.arange(r + 1, n_nodes)
    parent[rest] = ((rest - r - 1) // fanout + 1).astype(np.int32)
    item[rest] = ((rest - r - 1) % fanout).astype(np.int32)
    # body node ids are monotone in their parents' ids, so each level's
    # children form one contiguous id range
    depth = np.zeros(n_nodes, np.int32)
    depth[1:r + 1] = 1
    lo, hi, d = 1, r + 1, 1
    while True:
        clo = max(r + 1 + (lo - 1) * fanout, r + 1)
        chi = min(r + 1 + (hi - 1) * fanout, n_nodes)
        if clo >= chi:
            break
        d += 1
        depth[clo:chi] = d
        lo, hi = clo, chi
    rng = np.random.RandomState(seed)
    conf = (rng.rand(n_nodes) * 0.9 + 0.05).astype(np.float32)
    sup = (rng.rand(n_nodes) * 0.9 + 0.05).astype(np.float32)
    lift = (rng.rand(n_nodes) * 2).astype(np.float32)
    n_items = int(item.max()) + 1 if n_nodes > 1 else 0
    return _layout_fields(
        parent, item, depth, parent[1:].copy(), item[1:].copy(),
        np.arange(1, n_nodes, dtype=np.int32), conf, sup, lift, n_items,
    )


def synthetic_search_queries(
    arrs: Dict[str, np.ndarray], q: int, width: int, seed: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Half real root->node paths (random antecedent split), half junk."""
    rng = np.random.RandomState(seed)
    n_nodes = arrs["node_parent"].shape[0]
    n_items = int(arrs["edge_item"].max()) + 1
    queries = np.full((q, width), -1, np.int32)
    ant_len = np.zeros((q,), np.int32)
    for row in range(q):
        if row % 2 == 0 and n_nodes > 1:
            nid = rng.randint(1, n_nodes)
            path = []
            while nid > 0 and len(path) < width:
                path.append(int(arrs["node_item"][nid]))
                nid = int(arrs["node_parent"][nid])
            path = path[::-1]
            queries[row, : len(path)] = path
            ant_len[row] = rng.randint(0, len(path) + 1)
        else:
            k = rng.randint(1, width + 1)
            queries[row, :k] = rng.randint(0, n_items, size=k)
            ant_len[row] = rng.randint(0, k + 1)
    return queries, ant_len


def random_csr_trie(
    rng, n_nodes: int, n_items: int, max_children: int = 6
) -> Dict[str, np.ndarray]:
    """Random IRREGULAR well-formed trie (random parents, random child
    item sets), with edge-gathered metric columns as well."""
    parent = np.full((n_nodes,), -1, np.int32)
    item = np.full((n_nodes,), -1, np.int32)
    depth = np.zeros((n_nodes,), np.int32)
    edges = []
    used = {0: set()}
    for nid in range(1, n_nodes):
        p = rng.randint(0, nid)
        tries = 0
        while len(used.setdefault(p, set())) >= min(max_children, n_items):
            p = rng.randint(0, nid)
            tries += 1
            if tries > 50:
                break
        avail = [x for x in range(n_items) if x not in used[p]]
        if not avail:
            continue
        it = int(rng.choice(avail))
        used[p].add(it)
        used[nid] = set()
        parent[nid] = p
        item[nid] = it
        depth[nid] = depth[p] + 1
        edges.append((p, it, nid))
    edges.sort()
    e = np.array(edges, np.int32).reshape(-1, 3)
    conf = rng.rand(n_nodes).astype(np.float32) * 0.9 + 0.05
    sup = rng.rand(n_nodes).astype(np.float32) * 0.9 + 0.05
    lift = rng.rand(n_nodes).astype(np.float32) * 2
    edge_child = e[:, 2].copy() if e.size else np.zeros(0, np.int32)
    out = _layout_fields(
        parent, item, depth,
        e[:, 0].copy() if e.size else np.zeros(0, np.int32),
        e[:, 1].copy() if e.size else np.zeros(0, np.int32),
        edge_child, conf, sup, lift, n_items,
    )
    out["edge_conf"] = conf[edge_child]
    out["edge_sup"] = sup[edge_child]
    out["edge_lift"] = lift[edge_child]
    return out


def synthetic_chain_trie(
    n_edges: int,
    chain_fraction: float = 0.75,
    chain_len: int = 16,
    root_fanout: int = 0,
    fanout: int = 4,
    n_items: int = 0,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Chain-heavy trie, the shape the path-compressed layout targets: a
    ``root_fanout``-child hub (default ``min(128, max(8, n_edges // 64))``),
    then each frontier node grows either a single-child chain of
    ``chain_len // 2 + 1 .. chain_len + 1`` steps (probability
    ``chain_fraction``) or a ``fanout``-way branch.  The draws follow the
    reference generator's order, so a seed gives the same trie."""
    from collections import deque

    rng = np.random.RandomState(seed)
    if root_fanout <= 0:
        root_fanout = min(128, max(8, n_edges // 64))
    if n_items <= 0:
        n_items = max(root_fanout, 2 * fanout)
    parent_l = [-1]
    item_l = [-1]
    depth_l = [0]
    nid = 1
    frontier: deque = deque()
    for i in range(min(root_fanout, n_edges, n_items)):
        parent_l.append(0)
        item_l.append(i)
        depth_l.append(1)
        frontier.append(nid)
        nid += 1
    while nid <= n_edges and frontier:
        p = frontier.popleft()
        if rng.rand() < chain_fraction:
            run = 1 + rng.randint(max(chain_len // 2, 1), chain_len + 1)
            for _ in range(run):
                if nid > n_edges:
                    break
                parent_l.append(p)
                item_l.append(int(rng.randint(n_items)))
                depth_l.append(depth_l[p] + 1)
                p = nid
                nid += 1
            frontier.append(p)   # the tail keeps growing later
        else:
            k = min(fanout, n_items)
            for it in rng.choice(n_items, size=k, replace=False):
                if nid > n_edges:
                    break
                parent_l.append(p)
                item_l.append(int(it))
                depth_l.append(depth_l[p] + 1)
                frontier.append(nid)
                nid += 1
    n_nodes = nid
    parent = np.asarray(parent_l, np.int32)
    item = np.asarray(item_l, np.int32)
    depth = np.asarray(depth_l, np.int32)
    edge_parent = parent[1:]
    edge_item = item[1:]
    edge_child = np.arange(1, n_nodes, dtype=np.int32)
    order = np.lexsort((edge_item, edge_parent))
    conf = rng.rand(n_nodes).astype(np.float32) * 0.9 + 0.05
    sup = rng.rand(n_nodes).astype(np.float32) * 0.9 + 0.05
    lift = rng.rand(n_nodes).astype(np.float32) * 2
    return _layout_fields(
        parent, item, depth, edge_parent[order].copy(),
        edge_item[order].copy(), edge_child[order].copy(),
        conf, sup, lift, n_items,
    )


def mixed_queries(
    rng, arrs: Dict[str, np.ndarray], q: int, width: int
) -> Tuple[np.ndarray, np.ndarray]:
    """1/3 real paths (random split, so compound consequents), 1/3 junk
    (absent rules), 1/3 all-padding rows."""
    n_nodes = arrs["node_item"].shape[0]
    edge_item = arrs.get("edge_item")
    n_items = (
        int(edge_item.max()) + 1
        if edge_item is not None and edge_item.size else 1
    )
    queries = np.full((q, width), -1, np.int32)
    ant_len = np.zeros((q,), np.int32)
    for row in range(q):
        kind = row % 3
        if kind == 0 and n_nodes > 1:
            nid = rng.randint(1, n_nodes)
            path = []
            while nid > 0:
                path.append(int(arrs["node_item"][nid]))
                nid = int(arrs["node_parent"][nid])
            path = path[::-1][:width]
            queries[row, : len(path)] = path
            ant_len[row] = rng.randint(0, len(path) + 1)
        elif kind == 1:
            k = rng.randint(1, width + 1)
            queries[row, :k] = rng.randint(0, n_items, size=k)
            ant_len[row] = rng.randint(0, k + 1)
    return queries, ant_len


def frozen_from_arrays(arrs: Dict[str, np.ndarray]) -> FrozenTrie:
    """``FrozenTrie`` over one of this module's dicts.  The synthetic
    items are already canonical ids, so identity frequency tables stand
    in and query canonicalization is a no-op."""
    edge_item = arrs.get("edge_item")
    n_items = (
        int(edge_item.max()) + 1
        if edge_item is not None and edge_item.size else 0
    )
    item_order, item_rank = item_tables(np.arange(n_items, dtype=np.int32))
    return FrozenTrie.from_arrays(
        {**arrs, "item_order": item_order, "item_rank": item_rank}
    )


# ----------------------------------------------------------------------
# hypothesis strategies (importing this module never requires hypothesis)
# ----------------------------------------------------------------------
try:  # pragma: no cover - trivial import guard
    from hypothesis import strategies as _st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    _st = None
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @_st.composite
    def transaction_dbs(draw, max_items: int = 14, max_tx: int = 40):
        """Random small ``TransactionDB``: the same draws as
        ``repro.core.synthetic.transaction_dbs``."""
        from repro_torch.arm.transactions import TransactionDB  # lazy: core↔arm

        n_items = draw(_st.integers(min_value=3, max_value=max_items))
        n_tx = draw(_st.integers(min_value=4, max_value=max_tx))
        txs = []
        for _ in range(n_tx):
            size = draw(_st.integers(min_value=1, max_value=min(6, n_items)))
            tx = draw(
                _st.sets(
                    _st.integers(min_value=0, max_value=n_items - 1),
                    min_size=1,
                    max_size=size,
                )
            )
            txs.append(tx)
        return TransactionDB(txs, n_items=n_items)

    @_st.composite
    def db_and_minsup(draw, max_items: int = 14, max_tx: int = 40):
        db = draw(transaction_dbs(max_items=max_items, max_tx=max_tx))
        minsup = draw(_st.sampled_from([0.1, 0.2, 0.3, 0.5]))
        return db, minsup
