"""Log-structured streaming overlay over the frozen Trie of Rules.

PyTorch port of ``repro.core.delta_trie``.  The overlay bookkeeping is
numpy on the host, as in the reference; the stream names the device its
queries run on (``device``, CUDA unless named), and ``kernels.streaming``
keeps the frozen base's upload and each epoch's overlay columns there.
With a ``mesh`` (a ``launch.mesh.TrieMesh``) the frozen side of every
merge is a ``ShardPlan`` over it (``shard_plan``), and its answers come
to the stream's device for the merge.

The frozen layout (``array_trie.FrozenTrie``) is immutable by design —
every query kernel leans on its DFS-contiguous relabeling and its
(parent, item)-sorted edge table.  Real rulesets drift, so this module
adds the mutable half of a hybrid trie (the frozen-core/mutable-frontier
split of memory-efficient trie mining, arXiv:2202.06834): a
``StreamingTrie`` wraps a frozen base plus a log of inserted/updated
rules, and the batched ops in ``kernels.ops`` answer queries by merging
the frozen k-best with the delta k-best through the same public
``rank.rank_merge`` the sharded engine folds with — so streamed results
stay bit-identical (tie order included) to a from-scratch rebuild.

The bit-parity contract rests on one coordinate system: the REBUILT
trie's DFS pre-order.  Because pre-order position order equals
lexicographic root-path order in any trie with item-sorted siblings,
the rebuilt positions of both sides are computable without building the
rebuilt trie:

* every *novel* path's insertion point ``ins`` — the old-DFS position of
  the first frozen node that follows it in the rebuilt pre-order — comes
  from one host CSR descent (first missing item's bucket lower bound);
* novel entries sorted by padded path-lex get positions
  ``ins[j] + j`` (``ins`` is non-decreasing in lex order);
* a frozen node at old position ``p`` moves to ``p + shift[p]`` where
  ``shift[p] = |{j : ins[j] <= p}|`` — monotone, so frozen k-best lists
  keep their (value desc, pos asc) order under the remap;
* rebuilt BFS node ids are the ranks of ``(depth, rebuilt position)``
  over the union — which is exactly the depth-major numbering both
  construction engines emit, so even the ``node`` outputs match a
  rebuild bit-for-bit.

*Updated* rules (path already frozen) are served from the delta too: the
frozen copy is suppressed by masking its depth column to ``-1`` (the
rank kernels' ``depth >= min_depth`` filter with ``min_depth >= 1``
drops it; rule-search rows touching modified paths are recomputed
host-side from the union instead).

``refreeze`` folds delta entries back into a new ``FrozenTrie`` —
optionally one depth-1 subtree group at a time (the staggered per-shard
schedule; shards are whole depth-1 subtrees, so a group fold only
rewrites its owners) — by materializing the union arrays directly in
rebuilt BFS order and letting the ``FrozenTrie`` constructor re-derive
CSR/DFS/posting layouts, which makes the fold bit-identical to a
from-scratch build of the same ruleset.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .array_trie import FrozenTrie, canonical_prefix_rows, resolve_device

_UNKNOWN_RANK = np.iinfo(np.int32).max // 2


@dataclass
class DeltaOverlay:
    """Immutable per-epoch view of the delta in REBUILT coordinates.

    The entry columns (one row per inserted/updated rule, updates and
    novel rules together) are sorted by rebuilt DFS position — the order
    every (value desc, pos asc) tie rule downstream needs.  ``cache`` is
    scratch space for the batched ops (patched rank columns, per-metric
    score columns); it dies with the overlay on the next epoch.
    """

    epoch: int
    n_frozen: int              # node count of the frozen base
    n_total: int               # node count of the rebuilt trie
    d: int                     # delta entries (updates + novel)
    pos: np.ndarray            # int64[d] rebuilt DFS positions, ascending
    node: np.ndarray           # int32[d] REBUILT node ids
    depth: np.ndarray          # int32[d]
    support: np.ndarray        # f32[d]
    confidence: np.ndarray     # f32[d]
    lift: np.ndarray           # f32[d]
    paths: np.ndarray          # int32[d, W] canonical item rows, -1 padded
    path_len: np.ndarray       # int32[d]
    is_novel: np.ndarray       # bool[d]
    ins_sorted: np.ndarray     # int64[n_novel] insertion points (old DFS)
    shift: np.ndarray          # int32[n_frozen] old DFS pos -> novel before
    old2new: np.ndarray        # int32[n_frozen] old node id -> rebuilt id
    masked_nodes: np.ndarray   # int32[u] frozen node ids with stale metrics
    r2n: np.ndarray            # int32[n_total] rebuilt pos -> rebuilt id
    post_index: np.ndarray     # int32[n_total] rebuilt id -> posting index
    post_nodes: np.ndarray     # int32[n_total-1] posting index -> rebuilt id
    modified: Dict[Tuple[int, ...], int]  # canonical path -> entry row
    cache: dict = field(default_factory=dict)


class StreamingTrie:
    """A frozen Trie of Rules plus a log-structured delta overlay.

    ``insert`` absorbs new or updated rules (canonical full paths with
    their metric columns); the batched ops accept a ``StreamingTrie``
    anywhere they accept a ``FrozenTrie`` and merge frozen+delta k-best
    so results match a from-scratch rebuild bit-for-bit.  ``refreeze``
    (or the threshold-gated ``maybe_refreeze``) folds the delta back
    into a new frozen base, whole or one depth-1 subtree group at a
    time.  ``epoch`` increments on every mutation — serve-side caches
    key on it.

    ``device`` (CUDA unless named) is where the batched ops answer: the
    frozen side runs the port's kernels there, and the delta side and the
    merge are tensor ops on the same device.  ``mesh`` (optional) shards
    the frozen side: ``shard_plan()`` builds (and caches per frozen base
    and masked-node set) a ``ShardPlan`` over it, with the depth of
    updated nodes set to -1 so the sharded rank kernels skip their stale
    copies.
    """

    def __init__(
        self,
        frozen: FrozenTrie,
        mesh=None,
        *,
        layout: str = "plain",
        refreeze_max_delta: int = 1024,
        refreeze_max_age: int = 64,
        rebalance_drift: float = 0.25,
        device=None,
    ):
        if layout != "plain":
            raise ValueError(
                "StreamingTrie shards on the plain layout only for now "
                "(compressed spans would need delta-aware span splits; "
                "recorded as a ROADMAP follow-on)"
            )
        self.device = resolve_device(device)
        self.frozen = frozen
        self.mesh = mesh
        self.layout = layout
        self.refreeze_max_delta = int(refreeze_max_delta)
        self.refreeze_max_age = int(refreeze_max_age)
        self.rebalance_drift = float(rebalance_drift)
        self._entries: Dict[Tuple[int, ...], Tuple[float, float, float]] = {}
        self._epoch = 0
        self._age = 0            # insert batches since the last refreeze
        self._overlay: Optional[DeltaOverlay] = None
        self._plan_cache: Optional[tuple] = None
        self._last_ranges: Optional[tuple] = None
        self._host: Optional[dict] = None
        # the frozen base's device residency (kernels.streaming), per base
        self._resident: Optional[dict] = None

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    @property
    def epoch(self) -> int:
        """Monotone version counter: bumps on insert AND refreeze."""
        return self._epoch

    @property
    def n_delta(self) -> int:
        return len(self._entries)

    @property
    def is_identity(self) -> bool:
        """True when the overlay is empty — queries can take the plain
        frozen path unchanged (positions and node ids need no remap)."""
        return not self._entries

    @property
    def n_nodes(self) -> int:
        """Node count of the rebuilt (frozen + novel) trie."""
        if self.is_identity:
            return self.frozen.n_nodes
        return self.overlay().n_total

    # the ops-level validators and canonicalizers read these off the
    # trie argument, so the streaming wrapper must answer for its base
    @property
    def item_rank(self):
        return self.frozen.item_rank

    @property
    def item_order(self):
        return self.frozen.item_order

    def canonicalize_queries(self, antecedents, consequents):
        return self.frozen.canonicalize_queries(antecedents, consequents)

    def delta_by_group(self) -> Dict[int, int]:
        """Delta entry counts per depth-1 subtree (canonical first item)
        — the staggered re-freeze picks its next fold target from this."""
        groups: Dict[int, int] = {}
        for p in self._entries:
            groups[p[0]] = groups.get(p[0], 0) + 1
        return groups

    def _host_arrays(self) -> dict:
        if self._host is None:
            fz = self.frozen
            self._host = {
                "co": np.asarray(fz.child_offsets, np.int64),
                "ei": np.asarray(fz.edge_item, np.int64),
                "ec": np.asarray(fz.edge_child, np.int64),
                "dfs": np.asarray(fz.dfs_order, np.int64),
                "sub": np.asarray(fz.subtree_size, np.int64),
            }
        return self._host

    def _frozen_node(self, path: Tuple[int, ...]) -> Optional[int]:
        """CSR descent: the frozen node spelling ``path``, else None."""
        h = self._host_arrays()
        node = 0
        for it in path:
            lo, hi = int(h["co"][node]), int(h["co"][node + 1])
            j = lo + int(np.searchsorted(h["ei"][lo:hi], it))
            if j < hi and h["ei"][j] == it:
                node = int(h["ec"][j])
            else:
                return None
        return node

    def _insertion_point(self, path: Tuple[int, ...]) -> int:
        """Old-DFS position of the first frozen node following ``path``
        in the rebuilt pre-order (valid for paths absent from frozen)."""
        h = self._host_arrays()
        node = 0
        for it in path:
            lo, hi = int(h["co"][node]), int(h["co"][node + 1])
            j = lo + int(np.searchsorted(h["ei"][lo:hi], it))
            if j < hi and h["ei"][j] == it:
                node = int(h["ec"][j])
            else:
                if j < hi:
                    return int(h["dfs"][h["ec"][j]])
                return int(h["dfs"][node] + h["sub"][node])
        raise AssertionError("insertion point asked for a frozen path")

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def insert(
        self,
        sequences: Sequence[Sequence[int]],
        support,
        confidence,
        lift,
    ) -> int:
        """Insert (or update) rules with their metric columns.

        ``sequences`` are full rule paths (item sequences, canonicalized
        here to frequency order exactly like every query path); the three
        metric vectors carry the FINAL node's Support/Confidence/Lift per
        sequence.  Re-inserting an existing path (frozen or delta)
        updates its metrics in place — never appends a duplicate.

        The union must stay prefix-closed: a novel path's parent must
        already exist (in frozen, in the delta, or earlier in this same
        batch — batches are applied shortest-path-first), since every
        trie node carries its own metric tuple.  Items outside the
        frozen vocabulary are rejected (out-of-vocab streaming needs a
        frequency-table rebuild, a recorded follow-on).

        Returns the number of entries applied and bumps ``epoch``.
        """
        seqs = list(sequences)
        sup = np.asarray(support, np.float32).reshape(-1)
        conf = np.asarray(confidence, np.float32).reshape(-1)
        lif = np.asarray(lift, np.float32).reshape(-1)
        if not (len(seqs) == sup.size == conf.size == lif.size):
            raise ValueError(
                f"insert: {len(seqs)} sequences but metric columns of "
                f"sizes {sup.size}/{conf.size}/{lif.size}"
            )
        rows = canonical_prefix_rows(seqs, self.frozen.item_rank)
        rank = np.asarray(self.frozen.item_rank)
        nr = int(rank.shape[0])
        for qi, row in enumerate(rows):
            if not row:
                raise ValueError(f"insert: sequence {qi} is empty")
            for it in row:
                if not (0 <= it < nr) or int(rank[it]) >= _UNKNOWN_RANK:
                    raise ValueError(
                        f"insert: item id {it} in sequence {qi} is not in "
                        f"the frozen trie's vocabulary"
                    )
        staged: Dict[Tuple[int, ...], Tuple[float, float, float]] = {}
        order = sorted(range(len(rows)), key=lambda i: len(rows[i]))
        for i in order:
            path = tuple(rows[i])
            parent = path[:-1]
            if (
                parent
                and parent not in self._entries
                and parent not in staged
                and self._frozen_node(parent) is None
            ):
                raise ValueError(
                    f"insert: parent path {parent} of inserted rule "
                    f"{path} exists neither in the frozen trie nor in "
                    f"the delta — inserts must be prefix-closed"
                )
            staged[path] = (float(sup[i]), float(conf[i]), float(lif[i]))
        # later rows win within a batch (dict order above is length-major,
        # but equal paths collapse to the LAST metrics given for them)
        for i in range(len(rows)):
            path = tuple(rows[i])
            staged[path] = (float(sup[i]), float(conf[i]), float(lif[i]))
        self._entries.update(staged)
        self._bump()
        self._age += 1
        return len(staged)

    def _bump(self):
        self._epoch += 1
        self._overlay = None

    # ------------------------------------------------------------------
    # the overlay (per-epoch, lazily built)
    # ------------------------------------------------------------------
    def overlay(self) -> DeltaOverlay:
        if self._overlay is None or self._overlay.epoch != self._epoch:
            self._overlay = self._build_overlay(self._entries)
        return self._overlay

    def _build_overlay(
        self, entries: Dict[Tuple[int, ...], Tuple[float, float, float]]
    ) -> DeltaOverlay:
        fz = self.frozen
        n = fz.n_nodes
        dfs = np.asarray(fz.dfs_order, np.int64)
        depth_fz = np.asarray(fz.node_depth, np.int64)

        paths = list(entries.keys())
        d = len(paths)
        w = max((len(p) for p in paths), default=1)
        mat = np.full((d, w), -1, np.int32)
        for i, p in enumerate(paths):
            mat[i, : len(p)] = p
        plen = np.array([len(p) for p in paths], np.int32)
        metrics = np.array(
            [entries[p] for p in paths], np.float32
        ).reshape(d, 3)

        fnode = np.full((d,), -1, np.int64)
        for i, p in enumerate(paths):
            nd = self._frozen_node(p)
            if nd is not None:
                fnode[i] = nd
        novel = fnode < 0

        # --- novel ordering + insertion points --------------------------
        nov_idx = np.nonzero(novel)[0]
        ins = np.array(
            [self._insertion_point(paths[i]) for i in nov_idx], np.int64
        )
        # padded path-lex = rebuilt DFS pre-order among the novel nodes
        # (-1 pad < any item id, so a prefix precedes its extensions and
        # siblings order by raw item id — the CSR bucket order)
        if nov_idx.size:
            sub = mat[nov_idx]
            lex = np.lexsort(tuple(sub[:, c] for c in range(w - 1, -1, -1)))
        else:
            lex = np.zeros((0,), np.int64)
        nov_idx = nov_idx[lex]
        ins = ins[lex]
        if np.any(np.diff(ins) < 0):
            raise AssertionError(
                "novel insertion points must be non-decreasing in "
                "path-lex order"
            )
        dn = int(nov_idx.size)
        nov_pos = ins + np.arange(dn, dtype=np.int64)

        # frozen old DFS position p -> p + shift[p]
        shift = np.searchsorted(ins, np.arange(n, dtype=np.int64), "right")

        pos_all = np.concatenate([dfs + shift[dfs], nov_pos])
        depth_all = np.concatenate([depth_fz, plen[nov_idx].astype(np.int64)])
        m = n + dn
        # rebuilt BFS id = rank of (depth, rebuilt position)
        order = np.lexsort((pos_all, depth_all))
        new_of = np.empty((m,), np.int64)
        new_of[order] = np.arange(m, dtype=np.int64)
        old2new = new_of[:n].astype(np.int32)
        nov_new = new_of[n:]

        r2n = np.empty((m,), np.int32)
        r2n[pos_all] = new_of.astype(np.int32)

        # rebuilt posting index (item-major, DFS-sorted inside the item)
        new_item = np.empty((m,), np.int64)
        new_pos = np.empty((m,), np.int64)
        new_item[old2new] = np.asarray(fz.node_item, np.int64)
        new_pos[new_of] = pos_all
        if dn:
            new_item[nov_new] = mat[nov_idx, plen[nov_idx] - 1]
        nids = np.nonzero(new_item >= 0)[0]
        porder = np.lexsort((new_pos[nids], new_item[nids]))
        post_nodes = nids[porder].astype(np.int32)
        post_index = np.full((m,), -1, np.int32)
        post_index[post_nodes] = np.arange(post_nodes.size, dtype=np.int32)

        # --- entry columns, sorted by rebuilt position ------------------
        e_pos = np.empty((d,), np.int64)
        e_node = np.empty((d,), np.int32)
        upd = ~novel
        upd_nodes = fnode[upd]
        e_pos[upd] = (dfs + shift[dfs])[upd_nodes]
        e_node[upd] = old2new[upd_nodes]
        e_pos[nov_idx] = nov_pos
        e_node[nov_idx] = nov_new.astype(np.int32)
        eorder = np.argsort(e_pos, kind="stable")
        modified = {
            paths[int(i)]: int(r) for r, i in enumerate(eorder)
        }
        return DeltaOverlay(
            epoch=self._epoch,
            n_frozen=n,
            n_total=m,
            d=d,
            pos=e_pos[eorder],
            node=e_node[eorder],
            depth=plen[eorder],
            support=metrics[eorder, 0],
            confidence=metrics[eorder, 1],
            lift=metrics[eorder, 2],
            paths=mat[eorder],
            path_len=plen[eorder],
            is_novel=novel[eorder],
            ins_sorted=ins,
            shift=shift.astype(np.int32),
            old2new=old2new,
            masked_nodes=np.sort(fnode[upd]).astype(np.int32),
            r2n=r2n,
            post_index=post_index,
            post_nodes=post_nodes,
            modified=modified,
        )

    # ------------------------------------------------------------------
    # union lookups (rule-search recompute path)
    # ------------------------------------------------------------------
    def lookup(
        self, path: Tuple[int, ...]
    ) -> Optional[Tuple[float, float, float]]:
        """(support, confidence, lift) of the union node spelling the
        canonical ``path`` — delta metrics win over stale frozen copies;
        None when the path exists nowhere."""
        if path in self._entries:
            return self._entries[path]
        node = self._frozen_node(path)
        if node is None or node == 0:
            return None
        fz = self.frozen
        return (
            float(fz.support[node]),
            float(fz.confidence[node]),
            float(fz.lift[node]),
        )

    def node_of(self, path: Tuple[int, ...]) -> int:
        """REBUILT node id spelling ``path``; -1 when absent."""
        if not path:
            return 0
        ov = self.overlay() if self._entries else None
        if ov is not None and path in ov.modified:
            return int(ov.node[ov.modified[path]])
        node = self._frozen_node(path)
        if node is None:
            return -1
        if ov is None:
            return int(node)
        return int(ov.old2new[node])

    # ------------------------------------------------------------------
    # re-freeze (delta -> frozen fold)
    # ------------------------------------------------------------------
    def refreeze(self, first_items: Optional[Sequence[int]] = None) -> int:
        """Fold delta entries back into a new frozen base.

        ``first_items`` restricts the fold to the depth-1 subtree groups
        of those canonical first items (the staggered per-shard
        schedule; each group is prefix-closed by construction since a
        path and all its prefixes share a first item).  ``None`` folds
        everything.  Returns the number of entries folded; the new
        ``frozen`` is bit-identical to a from-scratch build of the same
        ruleset, so queries before and after a fold agree bit-for-bit.
        """
        if first_items is None:
            folded = dict(self._entries)
        else:
            allow = {int(i) for i in first_items}
            folded = {
                p: mtr for p, mtr in self._entries.items()
                if p[0] in allow
            }
        if not folded:
            return 0
        self.frozen = self._union_frozen(folded)
        for p in folded:
            del self._entries[p]
        self._host = None
        self._plan_cache = None
        self._resident = None
        self._bump()
        if not self._entries:
            self._age = 0
        return len(folded)

    def maybe_refreeze(self) -> Optional[int]:
        """Threshold-gated staggered fold: when the delta exceeds the
        size (``refreeze_max_delta``) or staleness (``refreeze_max_age``
        insert batches) threshold, fold the ONE depth-1 group holding
        the most delta entries and return its first item; None when no
        fold ran.  Repeated calls drain group after group — the
        staggered schedule that keeps any single fold bounded by its
        subtree instead of the whole trie."""
        if not self._entries:
            return None
        if (
            len(self._entries) < self.refreeze_max_delta
            and self._age < self.refreeze_max_age
        ):
            return None
        groups = self.delta_by_group()
        item = min(groups, key=lambda it: (-groups[it], it))
        self.refreeze(first_items=[item])
        return item

    def _union_frozen(
        self, entries: Dict[Tuple[int, ...], Tuple[float, float, float]]
    ) -> FrozenTrie:
        """The union trie (frozen + ``entries``) as a FrozenTrie in
        rebuilt BFS numbering; derived layouts re-derive in the
        constructor exactly as a from-scratch build would."""
        fz = self.frozen
        ov = self._build_overlay(entries)
        n, m = ov.n_frozen, ov.n_total
        o2n = ov.old2new.astype(np.int64)

        node_item = np.full((m,), -1, np.int32)
        node_parent = np.full((m,), -1, np.int32)
        node_depth = np.zeros((m,), np.int32)
        support = np.zeros((m,), np.float32)
        confidence = np.zeros((m,), np.float32)
        lift = np.zeros((m,), np.float32)

        node_item[o2n] = np.asarray(fz.node_item, np.int32)
        node_depth[o2n] = np.asarray(fz.node_depth, np.int32)
        support[o2n] = np.asarray(fz.support, np.float32)
        confidence[o2n] = np.asarray(fz.confidence, np.float32)
        lift[o2n] = np.asarray(fz.lift, np.float32)
        op = np.asarray(fz.node_parent, np.int64)
        nonroot = np.nonzero(op >= 0)[0]
        node_parent[o2n[nonroot]] = o2n[op[nonroot]].astype(np.int32)

        # delta entries: novel rows create nodes, updates patch metrics
        path_new = {
            p: int(ov.node[r]) for p, r in ov.modified.items()
        }
        for r in range(ov.d):
            nid = int(ov.node[r])
            support[nid] = ov.support[r]
            confidence[nid] = ov.confidence[r]
            lift[nid] = ov.lift[r]
            if not ov.is_novel[r]:
                continue
            pl = int(ov.path_len[r])
            path = tuple(int(x) for x in ov.paths[r, :pl])
            node_item[nid] = path[-1]
            node_depth[nid] = pl
            parent = path[:-1]
            if not parent:
                node_parent[nid] = 0
            elif parent in path_new:
                node_parent[nid] = path_new[parent]
            else:
                pn = self._frozen_node(parent)
                assert pn is not None, "prefix closure violated"
                node_parent[nid] = int(o2n[pn])

        # BFS numbering lists children in (parent, item) order, so the
        # edge table is sorted for free — assert rather than re-sort.
        ep = node_parent[1:].astype(np.int64)
        ei = node_item[1:].astype(np.int64)
        key = ep * (int(ei.max(initial=0)) + 2) + ei
        if np.any(np.diff(key) < 0):
            raise AssertionError("union edge table not (parent, item)-sorted")
        return FrozenTrie(
            node_item=node_item,
            node_parent=node_parent,
            node_depth=node_depth,
            support=support,
            confidence=confidence,
            lift=lift,
            edge_parent=node_parent[1:].astype(np.int32).copy(),
            edge_item=node_item[1:].astype(np.int32).copy(),
            edge_child=np.arange(1, m, dtype=np.int32),
            item_order=np.asarray(fz.item_order, np.int32).copy(),
            item_rank=np.asarray(fz.item_rank, np.int32).copy(),
        )

    # ------------------------------------------------------------------
    # sharded frozen side
    # ------------------------------------------------------------------
    def shard_plan(self):
        """The ShardPlan answering the frozen side of every merge when a
        ``mesh`` is attached (None otherwise).  Cached per (frozen base,
        masked-node set): novel-only epochs reuse the resident plan; only
        a metric update (whose stale frozen copy must stop ranking)
        re-uploads.  The cuts move only on load drift (``prev_ranges``
        with ``rebalance_drift``)."""
        if self.mesh is None:
            return None
        masked = (
            tuple(self.overlay().masked_nodes.tolist())
            if self._entries else ()
        )
        key = (id(self.frozen), masked)
        if self._plan_cache is not None and self._plan_cache[0] == key:
            return self._plan_cache[1]
        from repro_torch.distributed.trie_sharding import shard_device_trie

        fz = self.frozen
        if masked:
            nd = np.asarray(fz.node_depth, np.int32).copy()
            nd[list(masked)] = -1
            fz = dataclasses.replace(fz, node_depth=nd)
        plan = shard_device_trie(
            fz, self.mesh, layout=self.layout,
            prev_ranges=self._last_ranges, drift=self.rebalance_drift,
        )
        self._last_ranges = tuple(plan.ranges)
        self._plan_cache = (key, plan)
        return plan

    def owner_shard(self, sequence: Sequence[int]) -> Optional[int]:
        """The shard owning a rule's depth-1 subtree (None without a
        mesh): the insert-routing map; every path of the canonical first
        item lands in one owner's DFS range, frozen or novel."""
        plan = self.shard_plan()
        if plan is None:
            return None
        row = canonical_prefix_rows([list(sequence)], self.frozen.item_rank)[0]
        if not row:
            raise ValueError("owner_shard: empty sequence")
        head = (row[0],)
        node = self._frozen_node(head)
        pos = (
            int(np.asarray(self.frozen.dfs_order)[node])
            if node is not None else self._insertion_point(head)
        )
        for s, (lo, hi) in enumerate(plan.ranges):
            if lo <= pos < hi or (s == len(plan.ranges) - 1 and pos >= hi):
                return s
        return len(plan.ranges) - 1
