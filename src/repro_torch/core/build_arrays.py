"""Array-native trie construction — Steps 2+3 without per-node Python.

The pointer pipeline (``trie.TrieOfRules.build`` → ``annotate`` →
``FrozenTrie.freeze``) walks one Python object per node three times: dict
inserts, a ``support_fn(frozenset(path))`` call per node, and an
``id()``-dict BFS.  At 1e5+ rules that build cost dominates end-to-end time
(the paper's own Fig. 11 limitation).  This module replaces it with an
array program that emits the ``FrozenTrie`` encoding directly:

Step 2 (structure), vectorized over all sequences at once:

1. canonical sequences arrive as a padded int32 ``[S, L]`` matrix
   (``pack_sequences`` / ``arm.rulegen.canonical_matrix``), re-sorted to
   frequency order by one ``argsort`` over ``rank*K+item`` composite keys;
2. one lexicographic row sort (``np.lexsort``) groups equal prefixes into
   contiguous runs, so the distinct length-``d+1`` prefixes — exactly the
   depth-``d+1`` trie nodes — are run boundaries (``pfx[i] != pfx[i-1]``);
3. node ids are assigned depth-major in sorted-row order, which IS the
   BFS-with-item-sorted-children numbering ``FrozenTrie.freeze`` produces
   (within a level, lexicographic prefix order = (parent id, item) order),
   so the edge table ``(node_parent[1:], node_item[1:], 1..N-1)`` comes out
   (parent, item)-sorted for free — no edge sort, CSR offsets and the DFS
   relabeling reuse the existing vectorized ``array_trie`` helpers.

Step 3 (annotation) is ONE batched support pass instead of N per-node
``support_fn(frozenset(path))`` calls.  On the kernel path
(``use_kernel=True``, the default) every node's root-path items form one
candidate-matrix row, counted by the CUDA ``support_count`` bitmap kernel
in a single launch and annotated in f32 on the same device
(``kernels.ops.annotate_candidates``).  The host path does the same
batch as a level-wise vertical-bitmap sweep (``incremental_path_counts``:
each node ANDs one item row onto its parent's accumulated bitmap — O(N)
ANDs, exploiting support anti-monotonicity).  Confidence and lift columns
are then array ops against parent support via ``node_parent`` gathers,
replicating the pointer ``annotate`` float64 math bit-for-bit before the
float32 cast.

The pointer trie survives as the parity oracle:
``build_frozen_trie(db, seqs)`` must equal
``FrozenTrie.freeze(pointer trie)`` field-for-field (tests enforce it) —
including the derived layout both engines emit through the shared
``FrozenTrie`` constructor: CSR child buckets, the DFS-contiguous
relabeling, and the item-inverted index (``item_offsets``/``item_nodes``,
DFS-sorted posting lists per consequent item; the index sort key needs
the DFS relabeling, so it is computed with it at construction, not in
``trie_arrays``).

A copy of ``repro.core.build_arrays``; ``build_frozen_trie`` takes a
``device`` for the kernel path.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .array_trie import FrozenTrie, item_tables
from .metrics import Item

if TYPE_CHECKING:  # avoid the core <-> arm import cycle at runtime
    from repro_torch.arm.transactions import TransactionDB


def pack_sequences(
    sequences: Iterable[Sequence[Item]], max_len: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Sequences → padded int32 ``[S, L]`` matrix (-1 pad) + lengths."""
    rows = [tuple(s) for s in sequences]
    width = max((len(r) for r in rows), default=0)
    if max_len is not None:
        if width > max_len:
            raise ValueError(f"sequence longer than max_len={max_len}")
        width = max_len
    mat = np.full((len(rows), width), -1, dtype=np.int32)
    lens = np.zeros((len(rows),), dtype=np.int32)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
        lens[i] = len(r)
    return mat, lens


def canonicalize_matrix(
    mat: np.ndarray, item_rank: np.ndarray
) -> np.ndarray:
    """Vectorized canonical form of every row: items sorted by
    (frequency rank, item id), -1 padding pushed right.

    Matches ``TrieOfRules.canonical`` (rank dict sort with item-id ties)
    for every in-universe item; unknown items keep a huge rank.  Duplicate
    items are kept, exactly like the pointer insert (which walks a
    ``2/2/5`` path for the sequence ``(2, 2, 5)``).
    """
    mat = np.asarray(mat, np.int64)
    if mat.size == 0:
        return mat.astype(np.int32)
    n_ranked = item_rank.shape[0]
    valid = mat >= 0
    known = valid & (mat < n_ranked)
    rank = np.where(
        known,
        item_rank[np.clip(mat, 0, max(n_ranked - 1, 0))].astype(np.int64),
        np.int64(1) << 31,
    )
    # composite (rank, item) sort key; -1 padding sorts to the end
    mult = np.int64(max(int(mat.max()), 0) + 2)
    pad_key = np.iinfo(np.int64).max
    key = np.where(valid, rank * mult + np.where(valid, mat, 0), pad_key)
    order = np.argsort(key, axis=1, kind="stable")
    return np.take_along_axis(mat, order, axis=1).astype(np.int32)


def trie_arrays(
    mat: np.ndarray, lens: np.ndarray
) -> Dict[str, np.ndarray]:
    """Vectorized Step 2: distinct-prefix dedup → BFS node/edge arrays.

    ``mat`` rows must already be canonical (frequency-ordered, -1 padded).
    Returns the ``FrozenTrie`` structural arrays plus ``cand`` — the
    ``[N-1, max_depth]`` per-node root-path item matrix that Step 3
    annotates in one batch (row ``i`` is node ``i+1``'s path).
    """
    mat = np.asarray(mat, np.int32)
    lens = np.asarray(lens, np.int64)
    keep = lens > 0
    mat, lens = mat[keep], lens[keep]
    s, width = mat.shape

    if s == 0 or width == 0:
        return {
            "node_item": np.full(1, -1, np.int32),
            "node_parent": np.full(1, -1, np.int32),
            "node_depth": np.zeros(1, np.int32),
            "edge_parent": np.zeros(0, np.int32),
            "edge_item": np.zeros(0, np.int32),
            "edge_child": np.zeros(0, np.int32),
            "cand": np.zeros((0, 1), np.int32),
        }

    order = np.lexsort(tuple(mat[:, c] for c in range(width - 1, -1, -1)))
    sm = mat[order]
    sl = lens[order]

    # Per depth level: valid rows, run starts (= new nodes), parent ids.
    # Equal prefixes are contiguous among the rows valid at depth d because
    # -1 padding sorts before items: any row lexicographically between two
    # equal length-(d+1) prefixes shares those d+1 columns.
    level_items = []    # [depth] item of each new node
    level_parents = []  # [depth] parent node id of each new node
    level_rows = []     # [depth] first sorted-row index of each new node
    row_nid = np.zeros(s, np.int64)   # node id of each row at prev depth
    next_id = 1
    for d in range(width):
        vi = np.nonzero(sl > d)[0]
        if vi.size == 0:
            break
        sub = sm[vi, : d + 1]
        new = np.empty(vi.size, dtype=bool)
        new[0] = True
        if vi.size > 1:
            new[1:] = (sub[1:] != sub[:-1]).any(axis=1)
        nids = next_id + np.cumsum(new) - 1
        new_rows = vi[new]
        level_items.append(sm[new_rows, d])
        level_parents.append(row_nid[new_rows])   # depth d-1 id (root = 0)
        level_rows.append(new_rows)
        row_nid[vi] = nids
        next_id += int(new.sum())

    n = next_id
    max_depth = len(level_items)
    node_item = np.full(n, -1, np.int32)
    node_parent = np.full(n, -1, np.int32)
    node_depth = np.zeros(n, np.int32)
    cand = np.full((n - 1, max_depth), -1, np.int32)
    pos = 1
    for d in range(max_depth):
        cnt = level_items[d].size
        node_item[pos:pos + cnt] = level_items[d]
        node_parent[pos:pos + cnt] = level_parents[d]
        node_depth[pos:pos + cnt] = d + 1
        cand[pos - 1:pos - 1 + cnt, : d + 1] = sm[level_rows[d], : d + 1]
        pos += cnt

    # Depth-major ids in sorted-row order == BFS with item-sorted children,
    # so the implicit edge list is already (parent, item)-sorted.
    return {
        "node_item": node_item,
        "node_parent": node_parent,
        "node_depth": node_depth,
        "edge_parent": node_parent[1:].copy(),
        "edge_item": node_item[1:].copy(),
        "edge_child": np.arange(1, n, dtype=np.int32),
        "cand": cand,
    }


def incremental_path_counts(
    db: "TransactionDB",
    node_item: np.ndarray,
    node_parent: np.ndarray,
    node_depth: np.ndarray,
) -> np.ndarray:
    """Exact transaction counts of every node path, one level per AND.

    The host-side Step-3 counting pass: instead of re-ANDing each node's
    whole path from scratch (O(Σ depth) bitmap ANDs), walk the depth-major
    node arrays level by level and AND each node's single consequent item
    row onto its parent's accumulated transaction bitmap — O(N) ANDs
    total, the vertical-bitmap mirror of support anti-monotonicity along
    trie paths.  Returns int64 counts for nodes ``1..N-1``.
    """
    from repro_torch.arm.transactions import popcount_u32  # lazy: core <-> arm

    n = node_item.shape[0]
    counts = np.zeros((max(n - 1, 0),), np.int64)
    if n <= 1:
        return counts
    w = db.n_words
    w2 = w + (w & 1)   # even word count → uint64-view popcount
    bm = np.zeros((max(db.n_items, 1), w2), np.uint32)
    bm[:, :w] = db.item_bitmaps
    root = np.zeros((w2,), np.uint32)
    root[:w] = db.all_transactions()
    max_depth = int(node_depth[-1])
    bounds = np.searchsorted(node_depth, np.arange(max_depth + 2))
    max_level = int(np.max(np.diff(bounds)))
    # double-buffered level bitmaps + cache-sized row blocks: the popcount
    # reads each freshly ANDed block while it is still resident, instead
    # of a second full-level pass through RAM
    buf_a = np.empty((max_level, w2), np.uint32)
    buf_b = np.empty((max_level, w2), np.uint32)
    block = max(1, (1 << 20) // max(w2 * 4, 1))
    if hasattr(np, "bitwise_count"):
        # halve the element count through the native ufunc (w2 is even)
        def pcount(a: np.ndarray) -> np.ndarray:
            return np.bitwise_count(a.view(np.uint64))
    else:   # 32-bit SWAR fallback
        pcount = popcount_u32
    prev = root[None, :]
    prev_lo = 0
    for d in range(1, max_depth + 1):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        m = hi - lo
        acc = buf_a[:m]
        par = node_parent[lo:hi] - prev_lo
        items = node_item[lo:hi]
        for b in range(0, m, block):
            e = min(b + block, m)
            blk = acc[b:e]
            np.take(prev, par[b:e], axis=0, out=blk)
            np.bitwise_and(blk, bm[items[b:e]], out=blk)
            counts[lo - 1 + b:lo - 1 + e] = pcount(blk).sum(
                axis=1, dtype=np.int64
            )
        prev, prev_lo = acc, lo
        buf_a, buf_b = buf_b, buf_a
    return counts


def annotate_columns(
    counts: np.ndarray,
    node_parent: np.ndarray,
    node_item: np.ndarray,
    n_transactions: int,
    item_counts: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Step-3 metric columns from batched counts (float64 → float32).

    Replicates the pointer ``annotate`` float64 op order exactly
    (count/n → conf = sup/parent_sup → lift = conf/item_sup, zero guards
    included), so the float32 cast lands on identical bits.
    Returns full ``[N]`` columns with the root slot zeroed, as ``freeze``
    emits them.
    """
    n = node_parent.shape[0]
    n_tx = float(max(int(n_transactions), 1))
    sup = np.asarray(counts, np.float64) / n_tx
    # parent-support gather; virtual root support = 1.0 (Support(∅))
    sup_full = np.concatenate([[1.0], sup])
    psup = sup_full[node_parent[1:]]
    conf = np.where(psup > 0.0, sup / np.where(psup > 0.0, psup, 1.0), 0.0)
    isup = (
        np.asarray(item_counts, np.float64)[node_item[1:]] / n_tx
    )
    lift = np.where(isup > 0.0, conf / np.where(isup > 0.0, isup, 1.0), 0.0)

    def full(col: np.ndarray) -> np.ndarray:
        out = np.zeros(n, np.float32)
        out[1:] = col.astype(np.float32)
        return out

    return full(sup), full(conf), full(lift)


def build_frozen_trie(
    db: "TransactionDB",
    sequences: Iterable[Sequence[Item]],
    max_len: Optional[int] = None,
    use_kernel: Optional[bool] = None,
    device=None,
) -> Tuple[FrozenTrie, float, float]:
    """Array-native Step 2 + Step 3: sequences → annotated ``FrozenTrie``.

    ``use_kernel`` routes the one batched support pass through the
    ``support_count`` kernel on ``device`` (CUDA unless named;
    ``kernels.ops.annotate_candidates``, one launch for the whole trie,
    f32 columns); ``None`` means the kernel path.  ``use_kernel=False``
    runs the incremental host bitmap sweep and the f64 host columns.
    Returns ``(trie, build_seconds, annotate_seconds)`` — the Fig. 11
    Step 2 / Step 3 split.
    """
    if use_kernel is None:
        use_kernel = True
    if use_kernel:
        # resolve BEFORE the timers start: a missing card raises here
        from repro_torch.core.array_trie import resolve_device

        device = resolve_device(device)
    t0 = time.perf_counter()
    mat, lens = pack_sequences(sequences, max_len)
    item_order, item_rank = item_tables(db.frequency_order())
    if mat.size:
        mat = canonicalize_matrix(mat, item_rank)
        lens = (mat >= 0).sum(axis=1)
    arrs = trie_arrays(mat, lens)
    t1 = time.perf_counter()

    cand = arrs["cand"]
    clens = arrs["node_depth"][1:].astype(np.int32)
    if cand.shape[0] == 0:
        n = arrs["node_item"].shape[0]
        sup = conf = lift = np.zeros(n, np.float32)
        sup, conf, lift = sup.copy(), conf.copy(), lift.copy()
    elif use_kernel:
        from repro_torch.kernels.ops import annotate_candidates

        out = annotate_candidates(
            cand, clens, arrs["node_parent"][1:], arrs["node_item"][1:],
            db.item_counts(), db.n_transactions,
            item_bitmaps=db.device_bitmaps(device), device=device,
        )
        zero = np.zeros(1, np.float32)
        sup = np.concatenate([zero, out["support"].cpu().numpy()])
        conf = np.concatenate([zero, out["confidence"].cpu().numpy()])
        lift = np.concatenate([zero, out["lift"].cpu().numpy()])
    else:
        counts = incremental_path_counts(
            db, arrs["node_item"], arrs["node_parent"], arrs["node_depth"]
        )
        sup, conf, lift = annotate_columns(
            counts, arrs["node_parent"], arrs["node_item"],
            db.n_transactions, db.item_counts(),
        )
    trie = FrozenTrie(
        node_item=arrs["node_item"],
        node_parent=arrs["node_parent"],
        node_depth=arrs["node_depth"],
        support=sup,
        confidence=conf,
        lift=lift,
        edge_parent=arrs["edge_parent"],
        edge_item=arrs["edge_item"],
        edge_child=arrs["edge_child"],
        item_order=item_order,
        item_rank=item_rank,
    )
    t2 = time.perf_counter()
    return trie, t1 - t0, t2 - t1
