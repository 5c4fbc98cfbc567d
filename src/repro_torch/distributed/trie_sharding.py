"""Sharded residency of a frozen trie over a mesh of devices, its three
batched ops, and the degraded plans that answer around dead shards.

PyTorch port of ``repro.distributed.trie_sharding``.  Every depth-1
subtree of the DFS-contiguous layout (``array_trie.dfs_layout``) is one
contiguous DFS range, and those ranges tile ``[1, N)`` in order, so they
are the shard boundary: ``shard_device_trie`` cuts the trie into P
contiguous DFS ranges by greedy bin-packing over the depth-1 subtree sizes
(``FrozenTrie.depth1_subtrees``) and puts shard ``d`` on
``mesh.devices[d]`` (``launch.mesh.TrieMesh``).  Each shard holds its own
tensors, unpadded (``TrieShard``):

* its DFS slice of the metric, depth and item columns (the rank and
  membership kernels' inputs);
* its slice of the posting lists, co-partitioned by item in local DFS
  coordinates (a shard is a union of whole depth-1 subtrees, so every
  posting's subtree range is shard-local);
* a relabeled local edge table and CSR buckets for the descent: local id
  0 is the global root, whose bucket holds only the shard's own depth-1
  children, so a query's first item routes it to exactly one shard.

The two back-map tables (DFS position -> node id, posting index -> node
id) live on the lead device, ``mesh.lead``.

The three batched ops loop over the shards in one process: each shard
runs the port's unchanged kernel wrappers (``rank.topk_rank_batch``,
``item_index.rules_with_member``, ``rule_search.rule_search_fused`` or
``rule_search_span``) on its own device, over its own range, and the
outputs are copied to the lead device in shard order, where they merge:

* ranked ops: positions are globalized first, then the P k-best lists
  fold in shard order through ``rank.rank_merge``; shard ranges ascend in
  DFS order, so the tie order is the single-device op's, bit for bit;
* the search: a found-winner select (at most one shard completes a
  descent; a row no shard finds takes shard 0's not-found fields), and
  the consequent-path Support folds by ``rank.ieee_maximum`` in shard
  order, so compound lift (paper Eq. 1-4) is assembled globally even
  when the consequent path lies on another shard than the rule's path.

A shard with an empty DFS range (fewer depth-1 subtrees than shards, or
a dead shard of a masked plan) launches nothing: its k-best lists are
empty and its search answers are the not-found values, what the
reference's kernels give over its padding.  At P = 1 the merge is
skipped, as in the reference.  On CPU tensors each wrapper runs its plain
version; ``use_kernel=False`` runs the plain versions on any device.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, fields, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.array_trie import (
    AUTO_COMPRESS_SPAN_FRACTION,
    FrozenTrie,
    canonical_prefix_rows,
    compress_pos_space,
    sanitize_query_items,
)
from repro_torch.kernels.item_index import ROLES, rules_with_member
from repro_torch.kernels.metrics_inkernel import RANK_METRICS, compound_lift
from repro_torch.kernels.ops import (
    InvalidQueryError,
    TrieQueryError,
    dedup_query_rows,
)
from repro_torch.kernels.rank import ieee_maximum, rank_merge, topk_rank_batch
from repro_torch.kernels.ref import (
    not_found,
    rule_search_fused_ref,
    rule_search_span_ref,
    rules_with_ref,
    topk_rank_batch_ref,
)
from repro_torch.kernels.rule_search import (
    rule_search_fused,
    rule_search_span,
)
from repro_torch.kernels.streaming import LANE, _MERGE_ELEMS
from repro_torch.kernels.tuning import launch_pad

_BIG = 2**30


class ShardFailure(TrieQueryError):
    """A specific trie shard is unhealthy (raised by fault injection or a
    real per-device launch failure).  Deliberately NOT retryable under
    ``kernels.ops.is_retryable``: re-launching on the same sharded
    backend hits the same dead shard; the serve loop's ``ShardHealth``
    handles it by demoting to the replicated backend or to a
    dead-shard-masked degraded plan (``mask_dead_shards``)."""

    def __init__(self, shard: int, message: str = ""):
        self.shard = int(shard)
        super().__init__(
            message or f"shard {self.shard} failed"
        )


# ----------------------------------------------------------------------
# partitioning: greedy contiguous bin-packing over depth-1 subtree sizes
# ----------------------------------------------------------------------
def _greedy_bounds(sizes: Sequence[int], n_shards: int) -> List[Tuple[int, int]]:
    m = len(sizes)
    bounds: List[Tuple[int, int]] = []
    i = 0
    remaining = int(np.sum(sizes)) if m else 0
    for b in range(n_shards):
        bins_left = n_shards - b
        if i >= m or remaining <= 0:
            bounds.append((i, i))
            continue
        target = remaining / bins_left
        acc = 0
        j = i
        while j < m:
            nxt = int(sizes[j])
            overshoot = (acc + nxt) - target
            if (
                acc > 0 and bins_left > 1 and overshoot > 0
                and overshoot > target - acc
            ):
                break
            acc += nxt
            j += 1
            if acc >= target:
                break
        bounds.append((i, j))
        remaining -= acc
        i = j
    if i < m:
        lo, _ = bounds[-1]
        bounds[-1] = (lo, m)
    return bounds


def _bin_loads(sizes: Sequence[int], bounds: Sequence[Tuple[int, int]]):
    return [int(np.sum(sizes[a:b])) if b > a else 0 for a, b in bounds]


def plan_shard_bounds(
    sizes: Sequence[int],
    n_shards: int,
    hub_buckets=None,
    c: Optional[float] = None,
    prev_bounds: Optional[Sequence[Tuple[int, int]]] = None,
    drift: Optional[float] = None,
) -> List[Tuple[int, int]]:
    """Greedy contiguous partition of depth-1 subtrees into ``n_shards``
    bins.

    ``sizes`` are the subtree sizes in DFS order; bin ``b`` receives the
    contiguous run ``sizes[a_b:a_{b+1}]``.  Each bin fills toward the
    running ideal ``remaining / bins_left`` and closes at the cut nearest
    that target: the next subtree is still taken when overshooting by it
    beats stopping short (and always when the bin is empty: a single
    giant subtree must land somewhere).  Trailing bins may come out empty
    when there are fewer subtrees than shards; leftovers (a final
    oversized run) fold into the last bin.

    ``prev_bounds`` + ``drift`` gate rebalancing on load drift: when a
    previous partition of the same subtree list is still within
    ``(1 + drift)`` of the fresh plan's max load, it is returned
    unchanged, so streaming folds keep their resident shard layout until
    the delta actually skews the load.

    ``hub_buckets`` + ``c`` trigger hub refinement: when the plan's max
    load exceeds ``c * ideal`` because one bin is a single hub subtree,
    the planner recurses one level into that hub's child buckets
    (``hub_buckets`` maps subtree index -> its depth-2 bucket sizes) and
    re-plans over the refined unit list.  The return then becomes
    ``(bounds, units)`` where ``units[u] = (subtree, bucket)`` (bucket
    ``-1`` = the hub node itself; whole subtrees keep bucket ``-1``) and
    ``bounds`` indexes ``units``: cuts may land inside a refined hub.
    ``shard_device_trie`` cannot realize such interior cuts (its local
    relabeling and posting co-partition assume whole depth-1 subtrees),
    so refined plans feed load accounting and insert routing, not the
    device layout; the reference is the same.
    """
    bounds = _greedy_bounds(sizes, n_shards)
    if prev_bounds is not None and drift is not None:
        prev = [tuple(map(int, b)) for b in prev_bounds]
        valid = (
            len(prev) == n_shards
            and prev[0][0] == 0
            and all(b[1] == nb[0] for b, nb in zip(prev, prev[1:]))
            and (prev[-1][1] == len(sizes))
        )
        if valid:
            prev_max = max(_bin_loads(sizes, prev), default=0)
            new_max = max(_bin_loads(sizes, bounds), default=0)
            if prev_max <= (1.0 + float(drift)) * new_max:
                return prev
    if hub_buckets is None or c is None:
        return bounds
    total = int(np.sum(sizes)) if len(sizes) else 0
    ideal = total / max(n_shards, 1)
    loads = _bin_loads(sizes, bounds)
    refined: List[int] = []
    if loads and max(loads) > c * ideal:
        b = int(np.argmax(loads))
        a, e = bounds[b]
        if e - a == 1 and len(hub_buckets.get(a, ())) > 0:
            refined.append(a)
    if not refined:
        return bounds
    r_sizes: List[int] = []
    r_units: List[Tuple[int, int]] = []
    for t, sz in enumerate(sizes):
        if t in refined:
            r_sizes.append(1)             # the hub node itself
            r_units.append((t, -1))
            for bi, bsz in enumerate(hub_buckets[t]):
                r_sizes.append(int(bsz))
                r_units.append((t, bi))
        else:
            r_sizes.append(int(sz))
            r_units.append((t, -1))
    return _greedy_bounds(r_sizes, n_shards), r_units


def shard_dfs_ranges(
    frozen: FrozenTrie,
    n_shards: int,
    prev_ranges: Optional[Sequence[Tuple[int, int]]] = None,
    drift: Optional[float] = None,
) -> List[Tuple[int, int]]:
    """P contiguous DFS ranges tiling ``[0, N)``, cut at depth-1 subtree
    boundaries (shard 0 also holds the root at position 0).

    ``prev_ranges`` + ``drift`` pass through to ``plan_shard_bounds``'s
    drift gate (ranges convert to subtree bounds when they still align
    with the current trie's depth-1 boundaries): a staggered streaming
    refreeze that barely moved the load keeps its previous cuts.
    """
    _kids, _los, sizes = frozen.depth1_subtrees()
    cum = np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])
    prev_bounds = None
    if prev_ranges is not None and drift is not None:
        pb: List[Tuple[int, int]] = []
        edges = [0] + [int(hi) for _, hi in prev_ranges]
        ok = len(prev_ranges) == n_shards
        for lo_e, hi_e in zip(edges, edges[1:]):
            a = int(np.searchsorted(1 + cum, max(lo_e, 1)))
            b = int(np.searchsorted(1 + cum, max(hi_e, 1)))
            if (
                a >= len(cum) or 1 + int(cum[a]) != max(lo_e, 1)
                or b >= len(cum) or 1 + int(cum[b]) != max(hi_e, 1)
            ):
                ok = False       # old cut no longer on a subtree boundary
                break
            pb.append((a, b))
        if ok:
            prev_bounds = pb
    bounds = plan_shard_bounds(
        sizes, n_shards, prev_bounds=prev_bounds, drift=drift
    )
    ranges: List[Tuple[int, int]] = []
    for d, (a, b) in enumerate(bounds):
        lo = 1 + int(cum[a])
        hi = 1 + int(cum[b])
        if d == 0:
            lo = 0
        ranges.append((lo, hi))
    return ranges


def hub_child_buckets(frozen: FrozenTrie) -> Dict[int, List[int]]:
    """Depth-2 bucket sizes per depth-1 subtree (subtree index in DFS
    order -> its children's subtree sizes): the one-level recursion
    input of ``plan_shard_bounds``'s hub refinement."""
    kids, _los, _sizes = frozen.depth1_subtrees()
    co = np.asarray(frozen.child_offsets)
    ec = np.asarray(frozen.edge_child)
    sub = np.asarray(frozen.subtree_size)
    out: Dict[int, List[int]] = {}
    for t, v in enumerate(kids):
        lo, hi = int(co[v]), int(co[v + 1])
        if hi > lo:
            out[t] = [int(sub[ec[j]]) for j in range(lo, hi)]
    return out


# ----------------------------------------------------------------------
# the sharded device structure
# ----------------------------------------------------------------------
@dataclass
class TrieShard:
    """One shard's tensors, all on ``device``.

    The DFS slice ``[dfs_base, dfs_base + dfs_len)`` of the node columns;
    the shard's postings in local DFS coordinates (at least one entry,
    ``_BIG`` padding when it has none); the posting-ordered metric columns
    (plain layout; one-entry dummies on the compressed layout); the local
    subforest: CSR buckets and edge columns on the plain layout, or the
    span edge columns and the position-space node columns ``s_*`` (the
    root at local position 0) on the compressed one, the other family a
    one-entry dummy, as the reference keeps its unused leaves; and
    ``l2g``, local node id (compressed: local position) -> global id."""

    device: torch.device
    dfs_base: int
    dfs_len: int
    support: torch.Tensor
    confidence: torch.Tensor
    lift: torch.Tensor
    depth: torch.Tensor
    node_item: torch.Tensor
    post_lo: torch.Tensor
    post_hi: torch.Tensor
    p_support: torch.Tensor
    p_confidence: torch.Tensor
    p_lift: torch.Tensor
    p_depth: torch.Tensor
    child_offsets: torch.Tensor
    edge_item: torch.Tensor
    edge_child: torch.Tensor
    edge_conf: torch.Tensor
    edge_sup: torch.Tensor
    edge_lift: torch.Tensor
    l2g: torch.Tensor
    edge_pos: torch.Tensor
    edge_span: torch.Tensor
    edge_tail: torch.Tensor
    s_item: torch.Tensor
    s_support: torch.Tensor
    s_confidence: torch.Tensor
    s_lift: torch.Tensor

    def nbytes(self) -> int:
        """Device-resident bytes of the shard."""
        return sum(int(getattr(self, f).numel())
                   * getattr(self, f).element_size() for f in _LEAVES)


# every shard tensor, named as the reference's [P, ...] leaves
_LEAVES = tuple(f.name for f in fields(TrieShard)
                if f.name not in ("device", "dfs_base", "dfs_len"))


@dataclass
class ShardedDeviceTrie:
    """Device side of a P-way sharded frozen trie: the shards in DFS
    order, the back-map tables on the lead device, and the statics."""

    shards: List[TrieShard]
    g_dfs_to_node: torch.Tensor   # int32 [N], global DFS position -> id
    g_item_nodes: torch.Tensor    # int32 [E], global posting -> id
    n_shards: int = 1
    max_fanout: int = 0           # max local bucket width across shards
    max_postings: int = 0         # global longest posting list
    layout: str = "plain"
    n_transactions: int = 0       # compressed quantization statics
    confidence_scale: float = 1.0
    lift_scale: float = 1.0

    def _dequant(self) -> Dict:
        return {
            "n_transactions": self.n_transactions,
            "confidence_scale": self.confidence_scale,
            "lift_scale": self.lift_scale,
        }


@dataclass
class ShardPlan:
    """Host-side companion of a ``ShardedDeviceTrie``: the mesh, the DFS
    cut points, per-shard posting offsets (each query's posting window
    per shard) and the global posting base per (shard, item) that
    globalizes local posting positions ahead of the k-best merge.
    ``frozen`` stays referenced for host-side canonicalization and the
    prefix descent."""

    mesh: object                      # launch.mesh.TrieMesh
    trie: ShardedDeviceTrie
    frozen: FrozenTrie
    ranges: Tuple[Tuple[int, int], ...]
    local_item_offsets: np.ndarray    # int64 [P, I+1]
    gbase: np.ndarray                 # int64 [P, I]

    @property
    def n_shards(self) -> int:
        return self.trie.n_shards

    @property
    def device(self) -> torch.device:
        """The lead device: the sharded ops answer there."""
        return self.mesh.lead


def _host_tensor(a) -> torch.Tensor:
    """A CPU tensor of ``a`` (numpy, or a CPU tensor such as a bf16
    column), keeping its dtype."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def shard_device_trie(
    frozen: FrozenTrie,
    mesh,
    layout: str = "plain",
    quantize: bool = False,
    n_transactions: int = 0,
    columns: str = "bf16",
    prev_ranges: Optional[Sequence[Tuple[int, int]]] = None,
    drift: Optional[float] = None,
) -> ShardPlan:
    """Partition ``frozen`` over every device of ``mesh``'s ``data`` axis.

    Returns the host-side :class:`ShardPlan`; its ``.trie`` holds the
    shards.  ``kernels.ops``'s three batched query ops accept the plan
    wherever they accept a ``DeviceTrie`` and give bit-identical results.

    ``layout``/``quantize``/``n_transactions``/``columns`` mirror
    ``FrozenTrie.device_arrays``: with ``layout="compressed"`` every
    shard carries a path-compressed span pool covering exactly its own
    depth-1 subtrees (chains never cross a subtree boundary, so the
    per-shard ``compress_pos_space`` run reproduces the global span set
    restricted to the shard), and the metric columns may be quantized
    with the global scales, so each shard dequantizes bit for bit like
    the single-device compressed trie.

    ``prev_ranges`` + ``drift`` rebalance only on load drift (see
    ``plan_shard_bounds``).
    """
    if layout not in ("plain", "compressed", "auto"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "auto":
        layout = (
            "compressed"
            if frozen.span_fraction() >= AUTO_COMPRESS_SPAN_FRACTION
            else "plain"
        )
    comp = (
        frozen.compress(
            quantize=quantize, n_transactions=n_transactions,
            columns=columns,
        )
        if layout == "compressed"
        else None
    )
    n_shards = int(mesh.shape["data"])
    ranges = shard_dfs_ranges(
        frozen, n_shards, prev_ranges=prev_ranges, drift=drift
    )
    n = frozen.n_nodes
    dfs = np.asarray(frozen.dfs_order, np.int64)
    sub = np.asarray(frozen.subtree_size, np.int64)
    d2n = np.asarray(frozen.dfs_to_node, np.int64)

    # --- DFS-ordered columns ------------------------------------------
    # (the compressed path reuses the possibly-quantized position-space
    # columns, so every shard slice carries the global encoding's stored
    # values, and therefore its dequantized ones)
    cols = {
        "support": (
            comp.support_pos if comp is not None
            else np.asarray(frozen.support, np.float32)[d2n]
        ),
        "confidence": (
            comp.confidence_pos if comp is not None
            else np.asarray(frozen.confidence, np.float32)[d2n]
        ),
        "lift": (
            comp.lift_pos if comp is not None
            else np.asarray(frozen.lift, np.float32)[d2n]
        ),
        "depth": np.asarray(frozen.node_depth, np.int32)[d2n],
        "node_item": np.asarray(frozen.node_item, np.int32)[d2n],
    }
    cols = {k: _host_tensor(v) for k, v in cols.items()}

    # --- posting lists, co-partitioned by item -----------------------
    item_offsets = np.asarray(frozen.item_offsets, np.int64)
    item_nodes = np.asarray(frozen.item_nodes, np.int64)
    n_items = item_offsets.shape[0] - 1
    e = item_nodes.shape[0]
    post_item = np.repeat(
        np.arange(n_items, dtype=np.int64), np.diff(item_offsets)
    )
    post_dfs = dfs[item_nodes] if e else np.zeros((0,), np.int64)
    # postings are (item, dfs)-sorted, so one composite-key searchsorted
    # finds every shard's slice of every item's posting list at once
    key = post_item * (n + 1) + post_dfs
    item_keys = np.arange(n_items, dtype=np.int64) * (n + 1)
    starts = np.searchsorted(
        key, item_keys[None, :] + np.array([r[0] for r in ranges])[:, None]
    )
    ends = np.searchsorted(
        key, item_keys[None, :] + np.array([r[1] for r in ranges])[:, None]
    )
    counts = ends - starts                       # [P, I]
    local_item_offsets = np.zeros((n_shards, n_items + 1), np.int64)
    np.cumsum(counts, axis=1, out=local_item_offsets[:, 1:])

    nsup = np.asarray(frozen.support, np.float32)
    nconf = np.asarray(frozen.confidence, np.float32)
    nlift = np.asarray(frozen.lift, np.float32)
    ndep = np.asarray(frozen.node_depth, np.int32)
    edge_parent = np.asarray(frozen.edge_parent, np.int64)
    edge_item = np.asarray(frozen.edge_item, np.int64)
    edge_child = np.asarray(frozen.edge_child, np.int64)
    child_dfs = dfs[edge_child] if edge_child.size else np.zeros(
        (0,), np.int64
    )
    cc_pos = None
    if comp is not None:
        cc_all = np.diff(np.asarray(frozen.child_offsets, np.int64))
        cc_pos = cc_all[d2n] if d2n.size else cc_all

    def padded(a, fill, dtype):
        """``a`` as ``dtype``, one ``fill`` entry when it is empty (the
        reference's padding keeps the membership kernel's postings
        non-empty)."""
        a = np.asarray(a).astype(dtype)
        return a if a.size else np.full((1,), fill, dtype)

    def dummy(fill, dtype):
        return np.full((1,), fill, dtype)

    shards: List[TrieShard] = []
    max_fanout = 1
    for d, (lo, hi) in enumerate(ranges):
        t: Dict[str, object] = {
            name: cols[name][lo:hi] for name in cols
        }
        # postings of the shard, item-major and DFS-minor
        sel = (post_dfs >= lo) & (post_dfs < hi)
        ln = item_nodes[sel]
        sp_lo = (dfs[ln] - lo).astype(np.int64)
        sp_hi = sp_lo + sub[ln]
        # per-item ascending subtree ends (the membership kernel's second
        # binary-search side): the single-device composite-key sort
        order = np.argsort(post_item[sel] * (n + 1) + sp_hi, kind="stable")
        t["post_lo"] = padded(sp_lo, _BIG, np.int32)
        t["post_hi"] = padded(sp_hi[order], _BIG, np.int32)
        if comp is None:
            t["p_support"] = padded(nsup[ln], 0.0, np.float32)
            t["p_confidence"] = padded(nconf[ln], 0.0, np.float32)
            t["p_lift"] = padded(nlift[ln], 0.0, np.float32)
            t["p_depth"] = padded(ndep[ln], -1, np.int32)
        else:
            # the compressed layout ranks its consequent role through the
            # membership kernel, so no posting-ordered columns
            t["p_support"] = dummy(0.0, np.float32)
            t["p_confidence"] = dummy(0.0, np.float32)
            t["p_lift"] = dummy(0.0, np.float32)
            t["p_depth"] = dummy(-1, np.int32)

        # the relabeled local subforest: local id 0 = the global root;
        # in-shard nodes take 1 + their offset inside the shard's DFS
        # range (parents are root or in-shard: shards are whole depth-1
        # subtrees)
        start_pos = max(lo, 1)
        n_loc = max(hi - start_pos, 0)
        esel = (child_dfs >= start_pos) & (child_dfs < hi)
        ep, ei, ec = edge_parent[esel], edge_item[esel], edge_child[esel]
        lp = np.where(ep == 0, 0, dfs[ep] - start_pos + 1)
        lc = dfs[ec] - start_pos + 1
        t["l2g"] = np.concatenate([[0], d2n[start_pos:hi]]).astype(np.int32)
        if comp is not None:
            # path compression in local position space: the slice keeps
            # the global DFS order and every non-root local node its
            # global child count, so chain_spans sees the global span set
            # restricted to this shard
            cc_loc = np.concatenate([
                [int(np.count_nonzero(lp == 0))], cc_pos[start_pos:hi],
            ])
            c = compress_pos_space(cc_loc, lp, ei, lc)
            t["child_offsets"] = c["child_offsets"].astype(np.int32)
            t["edge_item"] = c["edge_item"].astype(np.int32)
            t["edge_pos"] = c["edge_pos"].astype(np.int32)
            t["edge_span"] = c["edge_span"].astype(np.int32)
            t["edge_tail"] = c["edge_tail"].astype(np.int32)
            fan = int(c["max_fanout"])
            t["edge_child"] = dummy(-1, np.int32)
            for name in ("edge_conf", "edge_sup", "edge_lift"):
                t[name] = dummy(0.0, np.float32)
            # position-space node columns for the span descent: the root
            # at local position 0, then the shard's DFS slice
            for name, src in (("s_item", "node_item"),
                              ("s_support", "support"),
                              ("s_confidence", "confidence"),
                              ("s_lift", "lift")):
                col = cols[src]
                t[name] = torch.cat([col[:1], col[start_pos:hi]])
        else:
            order = np.lexsort((ei, lp))
            lp, ei, lc, ec = lp[order], ei[order], lc[order], ec[order]
            cnt = np.bincount(lp, minlength=n_loc + 1)
            offsets = np.zeros((n_loc + 2,), np.int64)
            np.cumsum(cnt, out=offsets[1:])
            t["child_offsets"] = offsets.astype(np.int32)
            t["edge_item"] = ei.astype(np.int32)
            t["edge_child"] = lc.astype(np.int32)
            t["edge_conf"] = nconf[ec]
            t["edge_sup"] = nsup[ec]
            t["edge_lift"] = nlift[ec]
            fan = int(cnt.max()) if cnt.size else 0
            t["edge_pos"] = dummy(-1, np.int32)
            t["edge_span"] = dummy(0, np.int32)
            t["edge_tail"] = dummy(0, np.int32)
            t["s_item"] = dummy(-2, np.int32)
            for name, src in (("s_support", "support"),
                              ("s_confidence", "confidence"),
                              ("s_lift", "lift")):
                t[name] = torch.zeros((1,), dtype=cols[src].dtype)
        max_fanout = max(max_fanout, fan)
        dev = mesh.devices[d]
        shards.append(TrieShard(
            device=dev, dfs_base=int(lo), dfs_len=int(hi - lo),
            **{name: _host_tensor(v).to(dev) for name, v in t.items()},
        ))

    lead = mesh.lead
    trie = ShardedDeviceTrie(
        shards=shards,
        g_dfs_to_node=torch.from_numpy(d2n.astype(np.int32)).to(lead),
        g_item_nodes=torch.from_numpy(item_nodes.astype(np.int32)).to(lead),
        n_shards=n_shards,
        max_fanout=max_fanout,
        max_postings=int(frozen.max_postings),
        layout=layout,
        n_transactions=comp.n_transactions if comp is not None else 0,
        confidence_scale=(
            comp.confidence_scale if comp is not None else 1.0
        ),
        lift_scale=comp.lift_scale if comp is not None else 1.0,
    )
    return ShardPlan(
        mesh=mesh,
        trie=trie,
        frozen=frozen,
        ranges=tuple(ranges),
        local_item_offsets=local_item_offsets,
        gbase=starts.astype(np.int64),
    )


# ----------------------------------------------------------------------
# degraded plans: answering around dead shards
# ----------------------------------------------------------------------
# every shard tensor's padding value: masking a shard with its own padding
# convention makes a dead shard indistinguishable from an empty one (rank
# ops return nothing from its DFS range, posting windows come back empty,
# and descents routed to it report found=False)
_MASK_FILLS = {
    "support": 0.0, "confidence": 0.0, "lift": 0.0,
    "depth": -1, "node_item": -2,
    "dfs_len": 0,
    "post_lo": _BIG, "post_hi": _BIG,
    "p_support": 0.0, "p_confidence": 0.0, "p_lift": 0.0, "p_depth": -1,
    "child_offsets": 0, "edge_item": -7, "edge_child": -1,
    "edge_conf": 0.0, "edge_sup": 0.0, "edge_lift": 0.0, "l2g": -1,
    "edge_pos": -1, "edge_span": 0, "edge_tail": 0,
    "s_item": -2, "s_support": 0, "s_confidence": 0, "s_lift": 0,
}


def mask_dead_shards(
    plan: ShardPlan, dead: Sequence[int]
) -> ShardPlan:
    """A degraded copy of ``plan`` with the listed shards' data blanked.

    The masked plan still answers every batched op without error, but
    each dead shard's DFS range, posting lists and subforest vanish:
    ranked results exclude its rules and descents whose first item
    routes to it return ``found=False``.  This is the partial-answer
    fallback the serve loop's ``ShardHealth`` selects when the replicated
    backend is unavailable; the scheduler stamps ``degraded=True`` on
    every response answered through a masked plan.

    Allocation only, on each dead shard's device: the original plan and
    its tensors are untouched, so recovery is resuming the old plan.
    Raises ``ValueError`` when ``dead`` names an out-of-range shard or
    would kill all shards.
    """
    dead_set = sorted({int(d) for d in dead})
    p = plan.n_shards
    bad = [d for d in dead_set if not 0 <= d < p]
    if bad:
        raise ValueError(
            f"dead shard ids {bad} out of range for {p}-shard plan"
        )
    if not dead_set:
        return plan
    if len(dead_set) == p:
        raise ValueError(
            f"masking all {p} shards leaves nothing to answer from"
        )
    shards = list(plan.trie.shards)
    for d in dead_set:
        sh = shards[d]
        shards[d] = replace(
            sh, dfs_len=_MASK_FILLS["dfs_len"],
            **{name: torch.full_like(getattr(sh, name), _MASK_FILLS[name])
               for name in _LEAVES},
        )
    local_item_offsets = plan.local_item_offsets.copy()
    local_item_offsets[dead_set] = 0
    gbase = plan.gbase.copy()
    gbase[dead_set] = 0
    return ShardPlan(
        mesh=plan.mesh,
        trie=replace(plan.trie, shards=shards),
        frozen=plan.frozen,
        ranges=plan.ranges,
        local_item_offsets=local_item_offsets,
        gbase=gbase,
    )


# ----------------------------------------------------------------------
# the k-best merge on the lead device
# ----------------------------------------------------------------------
def merge_kbest(vals, pos, k: int):
    """Fold P per-shard k-best lists (``[P, Q, k]``, or a sequence of P
    ``[Q, k]`` tensors on one device) into the global ``[Q, k]`` through
    ``rank.rank_merge`` in shard order, each list padded to a multiple
    of the reference's lane with ``(-inf, -1)``: the same (value desc,
    pos asc) rank scatter as the reference, so the merged tie order is
    ``jax.lax.top_k``'s.  Positions must be global (distinct across
    shards)."""
    k = int(k)
    kpad = k + (-k % LANE)

    def pad(v, fill):
        return torch.nn.functional.pad(v, (0, kpad - k), value=fill)

    mv, mp = pad(vals[0], -torch.inf), pad(pos[0], -1).to(torch.int32)
    q = mv.shape[0]
    step = max(1, _MERGE_ELEMS // (kpad * kpad))
    for d in range(1, len(vals)):
        tv, tp = pad(vals[d], -torch.inf), pad(pos[d], -1).to(torch.int32)
        parts = [rank_merge(mv[r:r + step], mp[r:r + step],
                            tv[r:r + step], tp[r:r + step], kpad)
                 for r in range(0, q, step)]
        if parts:
            mv = torch.cat([a for a, _ in parts])
            mp = torch.cat([b for _, b in parts])
    return mv[:, :k], mp[:, :k]


def _take_back(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    if table.shape[0] == 0:
        return torch.full_like(pos, -1)
    return torch.where(pos >= 0, table[pos.clamp(min=0).long()], -1)


def _on(dev: torch.device):
    """Launch context of a shard: its CUDA device made current (the
    wrappers launch on the current device)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _empty_lists(q: int, k: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((q, k), -torch.inf, dtype=torch.float32, device=dev),
            torch.full((q, k), -1, dtype=torch.int32, device=dev))


def _merged(plan: ShardPlan, lists, k: int):
    """Copy the shards' k-best lists to the lead device in shard order
    and merge them (the one list at P = 1)."""
    lead = plan.device
    vals = [v.to(lead) for v, _ in lists]
    pos = [p.to(lead) for _, p in lists]
    if len(lists) == 1:
        return vals[0], pos[0]
    return merge_kbest(vals, pos, k)


# ----------------------------------------------------------------------
# host-side prefix descent (query prep without touching devices)
# ----------------------------------------------------------------------
def host_prefix_ranges(
    frozen: FrozenTrie, prefixes
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy mirror of ``kernels.ops.prefix_ranges`` (the same
    canonicalization, ``array_trie.canonical_prefix_rows``, the same CSR
    bucket descent, the same ``[Q, P]``-matrix vs ragged padding rule), so
    the sharded ops resolve antecedent prefixes to global DFS ranges
    without the global edge table on a device.  Integer for integer the
    device descent's answer."""
    co = np.asarray(frozen.child_offsets, np.int64)
    ei = np.asarray(frozen.edge_item, np.int64)
    ec = np.asarray(frozen.edge_child, np.int64)
    dfs = np.asarray(frozen.dfs_order, np.int64)
    sub = np.asarray(frozen.subtree_size, np.int64)
    n = frozen.n_nodes
    rows = canonical_prefix_rows(prefixes, frozen.item_rank)
    q = len(rows)
    los = np.zeros((q,), np.int32)
    his = np.zeros((q,), np.int32)
    nodes = np.zeros((q,), np.int32)
    for i, its in enumerate(rows):
        node = 0
        for it in its:
            lo_e, hi_e = int(co[node]), int(co[node + 1])
            j = lo_e + int(np.searchsorted(ei[lo_e:hi_e], it))
            if j < hi_e and ei[j] == it:
                node = int(ec[j])
            else:
                node = -1
                break
        if node >= 0:
            los[i] = dfs[node]
            his[i] = min(int(dfs[node] + sub[node]), n)
            nodes[i] = node
        else:
            nodes[i] = -1
    return los, his, nodes


# ----------------------------------------------------------------------
# the sharded batched ops
# ----------------------------------------------------------------------
def sharded_top_k_rules_batch(
    plan: ShardPlan, prefixes, k: int,
    metric: str = "confidence", min_depth: int = 1, use_kernel: bool = True,
) -> Dict[str, torch.Tensor]:
    """Sharded form of ``ops.top_k_rules_batch``: each shard ranks its
    DFS slice of every prefix's range, then the k-best lists merge on the
    lead device.  Bit-identical (tie order included) to the single-device
    op."""
    if metric not in RANK_METRICS:
        raise InvalidQueryError(
            f"metric {metric!r} not in {RANK_METRICS}"
        )
    # the single-device op's normalization: a [Q, P] matrix stays a
    # matrix (its -1 entries are padding), anything else is Q ragged rows
    if not isinstance(prefixes, np.ndarray):
        prefixes = list(prefixes)
    lead = plan.device
    k = int(k)
    q = len(prefixes)
    if q == 0:
        kk = max(k, 0)
        return {
            "values": torch.zeros((0, kk), dtype=torch.float32, device=lead),
            "node": torch.zeros((0, kk), dtype=torch.int32, device=lead),
            "dfs_pos": torch.zeros((0, kk), dtype=torch.int32, device=lead),
        }
    los, his, _nodes = host_prefix_ranges(plan.frozen, prefixes)
    rank_fn = topk_rank_batch if use_kernel else topk_rank_batch_ref
    lists = []
    for sh in plan.trie.shards:
        if sh.dfs_len == 0:   # an empty or dead shard covers no range
            lists.append(_empty_lists(q, k, sh.device))
            continue
        b, ln = sh.dfs_base, sh.dfs_len
        ll = torch.from_numpy(np.clip(los - b, 0, ln).astype(np.int32))
        hh = torch.from_numpy(np.clip(his - b, 0, ln).astype(np.int32))
        with _on(sh.device):
            v, p = rank_fn(
                sh.support, sh.confidence, sh.lift, sh.depth,
                ll.to(sh.device), hh.to(sh.device),
                k=k, metric=metric, min_depth=int(min_depth),
                **plan.trie._dequant(),
            )
        lists.append((v, torch.where(p >= 0, p + b, -1)))
    vals, pos = _merged(plan, lists, k)
    node = _take_back(plan.trie.g_dfs_to_node, pos)
    return {"values": vals, "node": node, "dfs_pos": pos}


def _sharded_posting_slices(plan: ShardPlan, items):
    """[P, Q] posting slices per shard, [P, Q] global-index deltas and the
    sanitized [Q] item ids (absent items: empty slices, id -1; the sanitize
    step is ``array_trie.sanitize_query_items``, shared with the
    single-device ``ops._posting_slices``, whose clip of ``safe + 1`` for
    an empty item universe this keeps)."""
    offsets = plan.local_item_offsets
    n_items = offsets.shape[1] - 1
    valid, safe, qitems = sanitize_query_items(items, n_items)
    hi = np.minimum(safe + 1, n_items)
    plos = np.where(valid[None, :], offsets[:, safe], 0).astype(np.int32)
    phis = np.where(valid[None, :], offsets[:, hi], 0).astype(np.int32)
    gbase = plan.gbase[:, safe] if n_items else np.zeros_like(plos)
    gdelta = np.where(valid[None, :], gbase - plos, 0).astype(np.int32)
    return plos, phis, gdelta, qitems


def sharded_rules_with(
    plan: ShardPlan, items, role: str = "any", k: int = 10,
    metric: str = "confidence", min_depth: int = 1, use_kernel: bool = True,
) -> Dict[str, torch.Tensor]:
    """Sharded form of ``ops.rules_with``: each shard answers over its
    co-partitioned posting lists and DFS slice, then the k-best merge.
    Bit-identical (tie order included) to the single-device op."""
    if role not in ROLES:
        raise InvalidQueryError(f"role {role!r} not in {ROLES}")
    if metric not in RANK_METRICS:
        raise InvalidQueryError(
            f"metric {metric!r} not in {RANK_METRICS}"
        )
    lead = plan.device
    k = int(k)
    plos, phis, gdelta, qitems = _sharded_posting_slices(plan, items)
    if qitems.shape[0] == 0:
        kk = max(k, 0)
        z = torch.zeros((0, kk), dtype=torch.int32, device=lead)
        return {
            "values": torch.zeros((0, kk), dtype=torch.float32, device=lead),
            "node": z, "pos": z,
        }
    # duplicate items dedup as in the single-device op: the launches run
    # over the U unique items, padded to launch_pad with absent-item rows
    _, first, inv = np.unique(qitems, return_index=True, return_inverse=True)
    u = first.shape[0]
    pad = launch_pad(u) - u
    plos = np.pad(plos[:, first], ((0, 0), (0, pad)))
    phis = np.pad(phis[:, first], ((0, 0), (0, pad)))
    gdelta = np.pad(gdelta[:, first], ((0, 0), (0, pad)))
    qitems = np.pad(qitems[first], (0, pad), constant_values=-1)
    qu = qitems.shape[0]
    # compressed plans carry no posting-ordered metric columns, so their
    # consequent role runs through the membership kernel, as on one device
    posting_rank = role == "consequent" and plan.trie.layout != "compressed"
    rank_fn = topk_rank_batch if use_kernel else topk_rank_batch_ref
    member_fn = rules_with_member if use_kernel else rules_with_ref
    lists = []
    for d, sh in enumerate(plan.trie.shards):
        if sh.dfs_len == 0:
            lists.append(_empty_lists(qu, k, sh.device))
            continue
        dev = sh.device
        lo_t = torch.from_numpy(plos[d]).to(dev)
        hi_t = torch.from_numpy(phis[d]).to(dev)
        with _on(dev):
            if posting_rank:
                v, p = rank_fn(
                    sh.p_support, sh.p_confidence, sh.p_lift, sh.p_depth,
                    lo_t, hi_t, k=k, metric=metric,
                    min_depth=int(min_depth),
                )
                # local posting index -> global posting index
                shift = torch.from_numpy(gdelta[d]).to(dev)[:, None]
            else:
                v, p = member_fn(
                    sh.support, sh.confidence, sh.lift, sh.depth,
                    sh.node_item, sh.post_lo, sh.post_hi, lo_t, hi_t,
                    torch.from_numpy(qitems).to(dev),
                    k=k, metric=metric, min_depth=int(min_depth), role=role,
                    **plan.trie._dequant(),
                )
                # local DFS position -> global DFS position
                shift = sh.dfs_base
        lists.append((v, torch.where(p >= 0, p + shift, -1)))
    vals, pos = _merged(plan, lists, k)
    inv_t = torch.from_numpy(np.asarray(inv).reshape(-1)).to(lead)
    vals, pos = vals[inv_t], pos[inv_t]
    # compressed consequent answers come back as DFS positions (the
    # membership kernel's coordinate), like every other role there
    back = (plan.trie.g_item_nodes if posting_rank
            else plan.trie.g_dfs_to_node)
    return {"values": vals, "node": _take_back(back, pos), "pos": pos}


def _shard_search(plan: ShardPlan, sh: TrieShard, queries, ant_len,
                  use_kernel: bool) -> Dict[str, torch.Tensor]:
    """One shard's descent of every row on its device, node ids global
    (``node`` > 0 only where the shard completed the walk)."""
    dev = sh.device
    q_t, al_t = queries.to(dev), ant_len.to(dev)
    with _on(dev):
        if plan.trie.layout == "compressed":
            fn = rule_search_span if use_kernel else rule_search_span_ref
            out = fn(
                sh.child_offsets, sh.edge_item, sh.edge_pos, sh.edge_span,
                sh.edge_tail, sh.s_item, sh.s_support, sh.s_confidence,
                sh.s_lift, q_t, al_t, max_fanout=plan.trie.max_fanout,
                **plan.trie._dequant(),
            )
            local = out["pos"]
        else:
            fn = rule_search_fused if use_kernel else rule_search_fused_ref
            out = fn(
                sh.child_offsets, sh.edge_item, sh.edge_child,
                sh.edge_conf, sh.edge_sup, sh.edge_lift, q_t, al_t,
                max_fanout=plan.trie.max_fanout,
            )
            local = out["node"]
    l2g = sh.l2g
    out["node"] = torch.where(
        local > 0, l2g[local.clamp(0, l2g.shape[0] - 1).long()], -1
    )
    return out


def fold_con_support(con_support: torch.Tensor) -> torch.Tensor:
    """The shards' consequent-path Supports ``[P, Q]`` folded to ``[Q]``
    as the reference's ``jnp.max`` over P: ``rank.ieee_maximum`` in shard
    order, so a NaN propagates and +0.0 ranks above -0.0 (``torch.amax``
    keeps whichever zero it meets first)."""
    csup = con_support[0]
    for d in range(1, con_support.shape[0]):
        csup = ieee_maximum(csup, con_support[d])
    return csup


def sharded_rule_search_batch(
    plan: ShardPlan, queries, ant_len=None, use_kernel: bool = True,
) -> Dict[str, torch.Tensor]:
    """Sharded form of ``ops.rule_search_batch``: every shard runs the
    fused CSR descent (the span descent on a compressed plan) over its
    local subforest, then a found-winner merge and the global compound
    lift on the lead device.  Bit-identical per row to the single-device
    op."""
    lead = plan.device
    if ant_len is None:
        pairs = list(queries)
        if not pairs:
            queries = np.zeros((0, 1), np.int32)
            ant_len = np.zeros((0,), np.int32)
        else:
            queries, ant_len = plan.frozen.canonicalize_queries(
                [p[0] for p in pairs], [p[1] for p in pairs])
    queries = np.asarray(queries, np.int32)
    ant_len = np.asarray(ant_len, np.int32)
    q, width = queries.shape
    if q == 0 or width == 0 or plan.frozen.n_edges == 0:
        z = torch.zeros((q,), dtype=torch.float32, device=lead)
        return {
            "found": torch.zeros((q,), dtype=torch.bool, device=lead),
            "node": torch.full((q,), -1, dtype=torch.int32, device=lead),
            "support": z, "confidence": z, "lift": z,
        }
    # whole-query dedup, the single-device op's helper: skewed serving
    # traffic descends each unique canonical row once per shard
    queries, ant_len, inv = dedup_query_rows(queries, ant_len)
    q_t = torch.from_numpy(np.ascontiguousarray(queries, np.int32))
    al_t = torch.from_numpy(np.ascontiguousarray(ant_len, np.int32))
    outs = []
    for sh in plan.trie.shards:
        if sh.dfs_len == 0:   # no depth-1 child: every row not found
            outs.append(not_found(q_t.shape[0], sh.device))
        else:
            outs.append(_shard_search(plan, sh, q_t, al_t, use_kernel))
    keys = ("found", "node", "confidence", "support", "lift",
            "con_support")
    if len(outs) == 1:
        out = {f: outs[0][f].to(lead) for f in keys[:-1]}
    else:
        gathered = {f: torch.stack([o[f].to(lead) for o in outs])
                    for f in keys}
        found_all = gathered["found"]                      # [P, Q]
        # at most one shard completes a descent; all-False rows pick
        # shard 0 (the first maximum), whose fields are not-found values
        win = found_all.to(torch.int32).argmax(dim=0)

        def take(f):
            return torch.gather(gathered[f], 0, win[None, :])[0]

        found = found_all.any(dim=0)
        conf = take("confidence")
        # the consequent-only walk may succeed on another shard than the
        # main path: fold its Support and redo the Eq. 1-4 select globally
        csup = fold_con_support(gathered["con_support"])
        q_lead = q_t.to(lead)
        seq_len = (q_lead >= 0).sum(dim=1, dtype=torch.int32)
        single = (seq_len - al_t.to(lead)) == 1
        out = {
            "found": found,
            "node": take("node"),
            "confidence": conf,
            "support": take("support"),
            "lift": compound_lift(found, single, take("lift"), conf, csup),
        }
    out = {key: out[key] for key in
           ("found", "node", "support", "confidence", "lift")}
    if inv is None:
        return out
    inv_t = torch.from_numpy(np.asarray(inv)).to(lead).long()
    return {key: v[inv_t] for key, v in out.items()}
