"""The batched query ops over a frozen trie (search, ranking, item-scoped
ranking and traversal), and the support counting and batched annotation of
trie construction.

PyTorch port of the main path of ``repro.kernels.ops``.  Host-side work
stays numpy or plain torch, as the reference keeps it outside its
kernels: query validation, canonicalization and dedup, the prefix
descent (``child_lookup``), and the position-to-node back-maps.  Each op
then makes one kernel call (``rank.topk_rank_batch``,
``rule_search.rule_search_fused``, ``item_index.rules_with_member`` or
``trie_reduce.trie_reduce_columns``), which on CUDA tensors launches the
hand-written kernel and on CPU tensors runs its plain version.

``support_count`` and ``annotate_candidates`` make one
``support_count.support_count_bitmap`` call over the transaction DB's
vertical bitmaps, on ``device`` (CUDA unless named).

``trie`` is a ``DeviceTrie`` (its device decides) or a ``FrozenTrie``
(uploaded to ``device``, CUDA unless named).  A compressed ``DeviceTrie``
(``FrozenTrie.device_arrays(layout="compressed" | "auto")``) runs every
query op on its span layout: the search through
``rule_search.rule_search_span``, the rankings over its DFS-ordered
columns with no gathers, the consequent role of ``rules_with`` through
the membership kernel, and its quantized columns widen inside every
kernel (``_dequant_statics``).  Sharded plans, streaming tries and the
seed layout without CSR offsets are later slices of the port and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.array_trie import (
    DeviceTrie,
    canonical_prefix_rows,
    child_lookup,
    compressed_descend,
    resolve_device,
    sanitize_query_items,
)

from .item_index import ROLES, rules_with_member
from .metrics_inkernel import RANK_METRICS, rank_score
from .rank import topk_rank_batch
from .ref import members_from_candidates  # noqa: F401  (the reference's ops name)
from .ref import rules_with_ref, topk_rank_batch_ref
from .rule_search import rule_search_fused, rule_search_span
from .support_count import support_count_bitmap
from .trie_reduce import trie_reduce_columns
from .tuning import launch_pad


# ----------------------------------------------------------------------
# error taxonomy (the serve loop's retryable-vs-fatal classification)
# ----------------------------------------------------------------------
class TrieQueryError(Exception):
    """Base of the trie-query error taxonomy."""


class InvalidQueryError(TrieQueryError, ValueError):
    """Malformed query input: fatal for the offending request, never
    retried."""


class TransientBackendError(TrieQueryError):
    """Transient backend/launch failure: safe to retry with backoff."""


_RETRYABLE_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "out of memory",
)


def is_retryable(exc: BaseException) -> bool:
    """``TransientBackendError`` retries, ``InvalidQueryError`` never does;
    anything else retries only when its message names a transient backend
    condition (allocator pressure and the like)."""
    if isinstance(exc, InvalidQueryError):
        return False
    if isinstance(exc, TransientBackendError):
        return True
    msg = str(exc)
    return any(marker in msg for marker in _RETRYABLE_MARKERS)


# ----------------------------------------------------------------------
# typed input validation
# ----------------------------------------------------------------------
_UNKNOWN_RANK = np.iinfo(np.int32).max // 2   # item_tables' unknown rank


def _validate_k(k, op: str) -> int:
    if isinstance(k, bool) or not isinstance(k, (int, np.integer)):
        raise InvalidQueryError(f"{op}: k must be a positive int, got {k!r}")
    if int(k) <= 0:
        raise InvalidQueryError(f"{op}: k must be positive, got {int(k)}")
    return int(k)


def _scalar_item_ok(it) -> bool:
    if isinstance(it, bool) or it is None:
        return False
    if isinstance(it, (int, np.integer)):
        return True
    shape = getattr(it, "shape", None)
    if shape == ():
        if isinstance(it, torch.Tensor):
            return not it.is_floating_point() and it.dtype != torch.bool
        return bool(np.issubdtype(np.asarray(it).dtype, np.integer))
    return False


def validate_items(
    items, op: str = "rules_with",
    n_items: Optional[int] = None, strict: bool = False,
) -> list:
    """Typed validation of a flat item-id list.  ``strict=True`` also
    rejects ids outside ``[0, n_items)``; otherwise absent ids resolve to
    empty result rows."""
    seq = list(items)
    try:
        arr = np.asarray(seq)
    except (ValueError, TypeError):
        arr = np.asarray(seq, dtype=object)
    if arr.ndim != 1:
        raise InvalidQueryError(
            f"{op}: expected a flat list of item ids, got shape {arr.shape}"
        )
    if arr.size and not np.issubdtype(arr.dtype, np.integer):
        offender_i, offender = next(
            ((i, v) for i, v in enumerate(seq) if not _scalar_item_ok(v)),
            (0, seq[0]),
        )
        raise InvalidQueryError(
            f"{op}: query item at index {offender_i} is {offender!r}; "
            f"expected an integer item id"
        )
    if strict and n_items is not None and arr.size:
        bad = np.where((arr < 0) | (arr >= n_items))[0]
        if bad.size:
            i = int(bad[0])
            raise InvalidQueryError(
                f"{op}: item id {int(arr[i])} at index {i} outside the "
                f"vocabulary [0, {n_items})"
            )
    return seq


def _strict_vocab_check(its, qi: int, op: str, item_rank) -> None:
    nr = int(np.asarray(item_rank).shape[0])
    for it in its:
        v = int(it)
        if not (0 <= v < nr) or int(item_rank[v]) >= _UNKNOWN_RANK:
            raise InvalidQueryError(
                f"{op}: item id {v} in query {qi} is not in the trie's "
                f"vocabulary"
            )


def validate_prefixes(
    prefixes, op: str = "top_k_rules_batch",
    item_rank=None, strict: bool = False,
) -> None:
    """Typed validation of Q ragged antecedent prefixes; an already-padded
    ``[Q, P]`` integer matrix passes wholesale."""
    if isinstance(prefixes, np.ndarray) and prefixes.ndim == 2:
        if not np.issubdtype(prefixes.dtype, np.integer):
            raise InvalidQueryError(
                f"{op}: prefix matrix must be integer-typed, got "
                f"{prefixes.dtype}"
            )
        return
    for qi, p in enumerate(list(prefixes)):
        if p is None:
            raise InvalidQueryError(f"{op}: prefix {qi} is None")
        its = list(np.asarray(p).reshape(-1)) if not isinstance(
            p, (list, tuple)
        ) else list(p)
        for i, it in enumerate(its):
            if not _scalar_item_ok(it):
                raise InvalidQueryError(
                    f"{op}: entry {i} of prefix {qi} is {it!r}; "
                    f"expected an integer item id"
                )
        if strict and item_rank is not None:
            _strict_vocab_check(its, qi, op, item_rank)


def validate_rule_pairs(
    pairs, op: str = "rule_search_batch",
    item_rank=None, strict: bool = False,
) -> None:
    """Typed validation of ragged (antecedent, consequent) query pairs."""
    for qi, pair in enumerate(pairs):
        if pair is None or len(pair) != 2:
            raise InvalidQueryError(
                f"{op}: query {qi} is {pair!r}; expected an "
                f"(antecedent, consequent) pair"
            )
        for side_name, side in zip(("antecedent", "consequent"), pair):
            if side is None:
                raise InvalidQueryError(
                    f"{op}: {side_name} of query {qi} is None; expected "
                    f"a sequence of integer item ids"
                )
            its = list(side)
            for i, it in enumerate(its):
                if not _scalar_item_ok(it):
                    raise InvalidQueryError(
                        f"{op}: entry {i} of the {side_name} of query "
                        f"{qi} is {it!r}; expected an integer item id"
                    )
            if strict and item_rank is not None:
                _strict_vocab_check(its, qi, op, item_rank)


def dedup_query_rows(queries, ant_len):
    """Whole-query dedup for canonical ``[Q, L]`` search rows.

    Returns ``(uq, ual, inv)`` where ``inv`` scatters unique-row results
    back to the Q rows, or ``(queries, ant_len, None)`` when every row is
    unique and Q already equals its launch pad.  The unique rows pad up to
    ``launch_pad`` with all-padding rows (found False by construction).
    """
    q = np.asarray(queries)
    al = np.asarray(ant_len)
    if q.shape[0] <= 1:
        return q, al, None
    key = np.concatenate(
        [q.astype(np.int64), al.astype(np.int64)[:, None]], axis=1
    )
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    inv = np.asarray(inv).reshape(-1)
    u = uniq.shape[0]
    upad = launch_pad(u)
    if u == q.shape[0] and upad == u:
        return q, al, None
    uq = np.full((upad, q.shape[1]), -1, np.int32)
    ual = np.zeros((upad,), np.int32)
    uq[:u] = uniq[:, :-1]
    ual[:u] = uniq[:, -1]
    return uq, ual, inv.astype(np.int32)


# ----------------------------------------------------------------------
# residency
# ----------------------------------------------------------------------
def _require_supported(trie, op: str) -> None:
    kind = type(trie).__name__
    if kind == "ShardPlan":
        raise NotImplementedError(
            f"{op}: sharded plans are ROADMAP slice 6 (multi-GPU)"
        )
    if kind == "StreamingTrie":
        raise NotImplementedError(
            f"{op}: streaming tries are ROADMAP slice 4 (streaming)"
        )
    if getattr(trie, "child_offsets", 0) is None:
        raise NotImplementedError(
            f"{op}: the seed layout without CSR offsets is ROADMAP Queue 2 "
            f"row 7 (rule_search_pallas)"
        )


def _device_trie(trie, device=None) -> DeviceTrie:
    _require_supported(trie, "query")
    if isinstance(trie, DeviceTrie):
        return trie
    return trie.device_arrays(device=device)


def _is_compressed(trie) -> bool:
    return getattr(trie, "layout", "plain") == "compressed"


def _dequant_statics(src) -> Dict:
    """The dequantization scalars of a compressed trie or of one of its
    column dicts (f32 no-op defaults otherwise), passed to every rank,
    membership, search and reduction call so quantized columns widen
    in-kernel."""
    get = src.get if isinstance(src, dict) else (
        lambda k, d: getattr(src, k, d)
    )
    return {
        "n_transactions": int(get("n_transactions", 0)),
        "confidence_scale": float(get("confidence_scale", 1.0)),
        "lift_scale": float(get("lift_scale", 1.0)),
    }


def _cached_device_trie(trie, arrays: Optional[Dict] = None, device=None):
    """The descent's DeviceTrie, cached in the arrays dict so repeat
    queries with ``arrays=`` upload the trie once."""
    if isinstance(trie, DeviceTrie) or arrays is None:
        return _device_trie(trie, device)
    dt = arrays.get("_device_trie")
    if dt is None:
        dt = _device_trie(trie, device)
        arrays["_device_trie"] = dt
    return dt


def _int32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


# ----------------------------------------------------------------------
# support counting
# ----------------------------------------------------------------------
def dense_from_bitmaps(item_bitmaps: np.ndarray) -> np.ndarray:
    """uint32 [I, W] vertical bitmaps → uint8 [T, I] dense membership,
    ``T = 32 W`` (the padding transactions hold no item)."""
    i, w = item_bitmaps.shape
    bits = np.unpackbits(
        item_bitmaps.view(np.uint8).reshape(i, w, 4), axis=-1, bitorder="little"
    )  # [I, W, 32]
    return bits.reshape(i, w * 32).T.astype(np.uint8)


def bitmaps_from_dense(dense_tx) -> np.ndarray:
    """[T, I] 0/1 dense membership → uint32 [I, ceil(T / 32)] vertical
    bitmaps: the inverse of ``dense_from_bitmaps``."""
    dense = np.asarray(
        dense_tx.cpu() if isinstance(dense_tx, torch.Tensor) else dense_tx
    ) != 0
    t, i = dense.shape
    w = (t + 31) // 32
    bits = np.zeros((i, w * 32), np.uint8)
    bits[:, :t] = dense.T
    packed = np.packbits(bits.reshape(i, w, 4, 8), axis=-1,
                         bitorder="little")            # [I, W, 4, 1] bytes
    return np.ascontiguousarray(packed.reshape(i, w * 4)).view(np.uint32)


def _device_int32(a, dev) -> torch.Tensor:
    """An int32 tensor on ``dev``; numpy uint32 words keep their bits."""
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=torch.int32).contiguous()
    a = np.asarray(a)
    if a.size == 0:
        return torch.zeros(a.shape, dtype=torch.int32, device=dev)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(dev)


def support_count(
    candidates,            # int32 [C, K] padded with -1
    lengths,               # int32 [C]; <= 0 marks padding rows (count 0)
    item_bitmaps=None,     # uint32 [I, W] vertical layout (TransactionDB)
    dense_tx=None,         # or [T, I] 0/1 dense transactions
    device=None,
    n_transactions=None,   # T; needed with item_bitmaps, implied by dense_tx
) -> torch.Tensor:
    """Counts (int32 ``[C]`` on ``device``) for every candidate itemset
    against the transaction DB, in one ``support_count_bitmap`` call.

    Each row counts its distinct valid items' transaction set, so rows
    with repeated items (duplicate-item trie paths) count their item SET;
    a negative entry anywhere in the row is skipped.  A row with
    ``lengths > 0`` and no valid item counts all ``n_transactions``
    (Support(∅)).  The bitmaps do not carry the transaction count, so
    ``item_bitmaps`` needs ``n_transactions``; given only ``dense_tx``, it
    is packed into bitmaps first.  ``item_bitmaps`` may already be a
    tensor (``TransactionDB.device_bitmaps``); ``device`` then defaults
    to its device.
    """
    if dense_tx is not None and item_bitmaps is None:
        n_transactions = int(dense_tx.shape[0])
        item_bitmaps = bitmaps_from_dense(dense_tx)
    elif item_bitmaps is None:
        raise ValueError("need item_bitmaps or dense_tx")
    elif n_transactions is None:
        raise ValueError(
            "item_bitmaps need n_transactions: the bitmaps' padding bits do "
            "not say how many transactions the last word holds"
        )
    if device is None and isinstance(item_bitmaps, torch.Tensor):
        dev = item_bitmaps.device
    else:
        dev = resolve_device(device)
    bitmaps = _device_int32(item_bitmaps, dev)
    cand = _device_int32(candidates, dev)
    if cand.dim() != 2:
        raise ValueError("candidates must be [C, K]")
    return support_count_bitmap(
        bitmaps, cand, _device_int32(lengths, dev).reshape(-1),
        int(n_transactions),
    )


def annotate_candidates(
    candidates,            # int32 [C, K] node root-path items, -1 padded
    lengths,               # int32 [C] path depths
    node_parent,           # int32 [C] parent node id per node (0 = root)
    node_item,             # int32 [C] consequent item per node
    item_counts,           # int/float [n_items] absolute item frequencies
    n_transactions: int,
    item_bitmaps=None,     # uint32 [I, W] vertical layout (TransactionDB)
    dense_tx=None,         # or [T, I] 0/1 dense transactions
    device=None,
) -> Dict[str, torch.Tensor]:
    """Step-3 batched trie annotation: every node metric in one pass.

    Node ids are BFS/depth-major (``FrozenTrie`` numbering, root = 0), so
    row ``i`` describes node ``i + 1``.  Supports come from ONE
    ``support_count`` kernel launch over the whole candidate matrix, and
    the Confidence/Lift columns are f32 tensor ops on the same device
    against the parent supports via ``node_parent`` gathers.  Leverage and
    conviction are derived with the shared ``metrics_inkernel.rank_score``
    math the rank kernel uses.  Returns f32 ``[C]`` columns.
    """
    counts = support_count(
        candidates, lengths, item_bitmaps, dense_tx, device=device,
        n_transactions=n_transactions,
    )
    dev = counts.device

    def f32(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.float32)
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    def idx(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=torch.int64)
        return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

    n_tx = torch.clamp(
        torch.tensor(float(np.float32(n_transactions)), device=dev), min=1.0
    )
    sup = counts.to(torch.float32) / n_tx
    # parent-support gather; virtual root slot = Support(∅) = 1.0
    sup_full = torch.cat([torch.ones((1,), dtype=torch.float32, device=dev),
                          sup])
    psup = sup_full[idx(node_parent)]
    conf = torch.where(
        psup > 0, sup / torch.where(psup > 0, psup, 1.0), 0.0
    )
    isup = f32(item_counts)[idx(node_item)] / n_tx
    lift = torch.where(
        isup > 0, conf / torch.where(isup > 0, isup, 1.0), 0.0
    )
    return {
        "support": sup,
        "confidence": conf,
        "lift": lift,
        "leverage": rank_score("leverage", sup, conf, lift),
        "conviction": rank_score("conviction", sup, conf, lift),
    }


# ----------------------------------------------------------------------
# trie search
# ----------------------------------------------------------------------
def edge_metric_arrays(trie, device=None) -> Dict:
    """Child-node metrics gathered onto the edges once, plus the CSR
    bucket index the fused search descends.

    A compressed trie returns its span tables instead, marked
    ``"layout": "compressed"``: the compressed CSR, the span edge columns
    and the position-indexed (possibly quantized) metric columns, the
    trie's own tensors with no gathers."""
    dt = _device_trie(trie, device)
    if _is_compressed(dt):
        return {
            "layout": "compressed",
            "child_offsets": dt.child_offsets,
            "edge_item": dt.edge_item,
            "edge_pos": dt.edge_child,
            "edge_span": dt.edge_span,
            "edge_tail": dt.edge_tail,
            "node_item": dt.node_item,
            "support": dt.support,
            "confidence": dt.confidence,
            "lift": dt.lift,
            "dfs_to_node": dt.dfs_to_node,
            "max_fanout": int(dt.max_fanout),
            **_dequant_statics(dt),
        }
    safe_child = dt.edge_child.clamp(min=0).long()
    return {
        "edge_item": dt.edge_item,
        "edge_child": dt.edge_child,
        "edge_conf": dt.confidence[safe_child],
        "edge_sup": dt.support[safe_child],
        "edge_lift": dt.lift[safe_child],
        "child_offsets": dt.child_offsets,
        "max_fanout": int(dt.max_fanout),
    }


def rule_search(
    trie, queries, ant_len, edges: Optional[Dict] = None, device=None,
) -> Dict[str, torch.Tensor]:
    """Rule search with full paper metrics (compound lift included) for
    canonical int32 rows ``[Q, L]`` (-1 padded): one fused kernel call.
    Returns found/node/support/confidence/lift, each ``[Q]``."""
    _require_supported(trie, "rule_search")
    if edges is None:
        edges = edge_metric_arrays(trie, device)
    dev = edges["edge_item"].device
    queries = _int32(queries, dev)
    ant_len = _int32(ant_len, dev)
    if queries.shape[0] == 0:
        z = torch.zeros((0,), dtype=torch.float32, device=dev)
        return {
            "found": torch.zeros((0,), dtype=torch.bool, device=dev),
            "node": torch.zeros((0,), dtype=torch.int32, device=dev),
            "support": z, "confidence": z, "lift": z,
        }
    if edges.get("layout") == "compressed":
        out = rule_search_span(
            edges["child_offsets"], edges["edge_item"], edges["edge_pos"],
            edges["edge_span"], edges["edge_tail"], edges["node_item"],
            edges["support"], edges["confidence"], edges["lift"],
            queries, ant_len, max_fanout=edges["max_fanout"],
            **_dequant_statics(edges),
        )
        # the span kernel answers DFS positions (-1 when absent); the op
        # answers node ids
        return {
            "found": out["found"],
            "node": _back_map(out["pos"], edges["dfs_to_node"]),
            "support": out["support"],
            "confidence": out["confidence"],
            "lift": out["lift"],
        }
    out = rule_search_fused(
        edges["child_offsets"], edges["edge_item"], edges["edge_child"],
        edges["edge_conf"], edges["edge_sup"], edges["edge_lift"],
        queries, ant_len, max_fanout=edges["max_fanout"],
    )
    # con_support feeds the sharded merge, not the op-level contract
    return {k: v for k, v in out.items() if k != "con_support"}


def rule_search_batch(
    trie, queries, ant_len=None, edges: Optional[Dict] = None,
    strict: bool = False, device=None,
) -> Dict[str, torch.Tensor]:
    """Search Q rules in one kernel call: ``queries`` is a sequence of
    ``(antecedent, consequent)`` pairs (canonicalized host-side through
    ``FrozenTrie.canonicalize_queries``) or a canonical ``[Q, L]`` matrix
    with ``ant_len``.  The batch dedups to its unique rows and scatters
    results back."""
    _require_supported(trie, "rule_search_batch")
    if ant_len is None and not isinstance(queries, np.ndarray):
        queries = list(queries)
        validate_rule_pairs(
            queries, "rule_search_batch",
            item_rank=getattr(trie, "item_rank", None), strict=strict,
        )
    if ant_len is None:
        canonicalize = getattr(trie, "canonicalize_queries", None)
        if canonicalize is None:
            raise ValueError(
                "ragged (antecedent, consequent) queries need a FrozenTrie "
                "(canonicalize_queries lives host-side); for a DeviceTrie "
                "pass an already-canonical [Q, L] matrix plus ant_len"
            )
        pairs = list(queries)
        if not pairs:
            return rule_search(
                trie, np.zeros((0, 1), np.int32), np.zeros((0,), np.int32),
                edges=edges, device=device,
            )
        queries, ant_len = canonicalize(
            [p[0] for p in pairs], [p[1] for p in pairs]
        )
    uq, ual, inv = dedup_query_rows(queries, ant_len)
    out = rule_search(trie, uq, ual, edges=edges, device=device)
    if inv is None:
        return out
    inv_t = torch.as_tensor(inv, device=out["found"].device).long()
    return {key: v[inv_t] for key, v in out.items()}


# ----------------------------------------------------------------------
# ranked extraction over the DFS-contiguous layout
# ----------------------------------------------------------------------
def dfs_rank_arrays(trie, device=None) -> Dict[str, torch.Tensor]:
    """DFS-ordered rank columns and the DFS relabeling, gathered once.  On
    a compressed trie the node axis already is DFS order: the columns are
    the trie's own (possibly quantized) tensors, so no f32 copy of a
    quantized column is made, and the dict carries the dequantization
    scalars."""
    dt = _device_trie(trie, device)
    if dt.dfs_to_node is None:
        raise ValueError(
            "trie has no DFS layout (dfs_to_node is None); build it with "
            "FrozenTrie or array_trie.dfs_layout first"
        )
    if _is_compressed(dt):
        return {
            "support": dt.support,
            "confidence": dt.confidence,
            "lift": dt.lift,
            "depth": dt.node_depth,
            "subtree_size": dt.subtree_size,
            "dfs_to_node": dt.dfs_to_node,
            **_dequant_statics(dt),
        }
    d2n = dt.dfs_to_node.long()
    return {
        "support": dt.support[d2n],
        "confidence": dt.confidence[d2n],
        "lift": dt.lift[d2n],
        "depth": dt.node_depth[d2n],
        "dfs_order": dt.dfs_order,
        "subtree_size": dt.subtree_size,
        "dfs_to_node": dt.dfs_to_node,
    }


def _back_map(pos: torch.Tensor, back: torch.Tensor) -> torch.Tensor:
    if back.shape[0] == 0:
        return torch.full_like(pos, -1)
    return torch.where(pos >= 0, back[pos.clamp(min=0).long()], -1)


def prefix_ranges(trie, prefixes, dt: Optional[DeviceTrie] = None,
                  device=None) -> tuple:
    """Resolve Q antecedent prefixes to DFS ranges ``[lo, hi)`` by one
    batched CSR descent: ``(los, his, nodes)``, int32 ``[Q]``.  Absent
    prefixes give ``[0, 0)``, empty ones ``[0, N)``; in a padded ``[Q, P]``
    matrix ``-1`` is padding, in ragged rows every entry is an item."""
    rows = canonical_prefix_rows(prefixes, getattr(trie, "item_rank", None))
    q = len(rows)
    width = max((len(r) for r in rows), default=0)
    mat = np.full((q, max(width, 1)), -1, np.int32)
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
    if dt is None:
        dt = _device_trie(trie, device)
    _require_supported(dt, "prefix_ranges")
    cols = _int32(mat, dt.device)
    if _is_compressed(dt):
        return _compressed_prefix_ranges(dt, cols)
    n = dt.dfs_order.shape[0]
    nodes = torch.zeros((q,), dtype=torch.int32, device=dt.device)
    for c in range(width):
        col = cols[:, c]
        step = child_lookup(dt, nodes, col)
        # only -1 is padding; other negatives are live (absent) items
        nodes = torch.where(col != -1, step, nodes)
    ok = nodes >= 0
    nid = nodes.clamp(min=0).long()
    los = torch.where(ok, dt.dfs_order[nid], 0).to(torch.int32)
    his = torch.where(ok, los + dt.subtree_size[nid], 0).to(torch.int32)
    his = his.clamp(max=n)
    return los, his, torch.where(ok, nodes, -1)


def _compressed_prefix_ranges(dt: DeviceTrie, cols):
    """The span-aware prefix descent: positions are DFS indices on this
    layout, so the range is ``[pos, pos + subtree_size[pos])``."""
    n = dt.subtree_size.shape[0]
    # only -1 is padding; other negatives are live (absent) items
    pos, ok = compressed_descend(dt, cols, pad=-1)
    pl = pos.long()
    los = torch.where(ok, pos, 0).to(torch.int32)
    his = torch.where(ok, pos + dt.subtree_size[pl], 0).to(torch.int32)
    nodes = torch.where(ok, dt.dfs_to_node[pl], -1).to(torch.int32)
    return los, his.clamp(max=n), nodes


def top_k_rules(
    trie, k: int, metric: str = "confidence",
    prefix: Optional[Sequence[int]] = None, min_depth: int = 1,
    arrays: Optional[Dict] = None, use_kernel: bool = True, device=None,
) -> Dict[str, torch.Tensor]:
    """Top-k rules by an interestingness metric, whole-trie or under one
    antecedent prefix: ``{"values" f32[k], "node" int32[k], "dfs_pos"
    int32[k]}``.  The Q=1 slice of ``top_k_rules_batch``."""
    _validate_k(k, "top_k_rules")
    if prefix is not None:
        validate_prefixes(
            [prefix], "top_k_rules", item_rank=getattr(trie, "item_rank", None)
        )
    out = top_k_rules_batch(
        trie, [[] if prefix is None else prefix], k, metric=metric,
        min_depth=min_depth, arrays=arrays, use_kernel=use_kernel,
        device=device,
    )
    return {key: v[0] for key, v in out.items()}


def top_k_rules_batch(
    trie, prefixes, k: int, metric: str = "confidence", min_depth: int = 1,
    arrays: Optional[Dict] = None, use_kernel: bool = True,
    strict: bool = False, device=None,
) -> Dict[str, torch.Tensor]:
    """Top-k rules under each of Q antecedent prefixes in one kernel call:
    the prefixes resolve to Q subtree ranges (``prefix_ranges``) that
    ``rank.topk_rank_batch`` ranks together.  ``use_kernel=False`` runs the
    plain version on any device.  Returns ``{"values" f32[Q, k], "node"
    int32[Q, k], "dfs_pos" int32[Q, k]}``."""
    if metric not in RANK_METRICS:
        raise InvalidQueryError(f"metric {metric!r} not in {RANK_METRICS}")
    _validate_k(k, "top_k_rules_batch")
    _require_supported(trie, "top_k_rules_batch")
    if not isinstance(prefixes, np.ndarray):
        prefixes = list(prefixes)
    validate_prefixes(
        prefixes, "top_k_rules_batch",
        item_rank=getattr(trie, "item_rank", None), strict=strict,
    )
    if arrays is None:
        arrays = dfs_rank_arrays(trie, device)
    dev = arrays["support"].device
    if len(prefixes) == 0:
        return {
            "values": torch.zeros((0, int(k)), dtype=torch.float32,
                                  device=dev),
            "node": torch.zeros((0, int(k)), dtype=torch.int32, device=dev),
            "dfs_pos": torch.zeros((0, int(k)), dtype=torch.int32,
                                   device=dev),
        }
    los, his, _nodes = prefix_ranges(
        trie, prefixes, dt=_cached_device_trie(trie, arrays, dev)
    )
    rank_fn = topk_rank_batch if use_kernel else topk_rank_batch_ref
    vals, pos = rank_fn(
        arrays["support"], arrays["confidence"], arrays["lift"],
        arrays["depth"], los, his,
        k=int(k), metric=metric, min_depth=int(min_depth),
        **_dequant_statics(arrays),
    )
    return {
        "values": vals,
        "node": _back_map(pos, arrays["dfs_to_node"]),
        "dfs_pos": pos,
    }


# ----------------------------------------------------------------------
# item-scoped ranking over the item-inverted index
# ----------------------------------------------------------------------
def item_rank_arrays(trie, device=None) -> Dict:
    """Inverted-index query arrays, gathered once: the DFS-ordered
    columns, the posting subtree ranges (``post_lo`` ascending per item,
    ``post_hi`` sorted per item here, so both sides of the laminar count
    are binary-searchable), and posting-ordered columns for the
    consequent role.  ``item_offsets`` stays on the host.

    A compressed trie carries its posting ranges and DFS-ordered columns
    already: the dict holds its own tensors, no posting-ordered block (the
    consequent role then runs through the membership kernel) and the
    dequantization scalars."""
    _require_supported(trie, "item_rank_arrays")
    if getattr(trie, "item_offsets", None) is None:
        raise ValueError(
            "trie has no item-inverted index (item_offsets is None)"
        )

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else \
            np.asarray(a)

    if _is_compressed(trie):
        return {
            "support": trie.support,
            "confidence": trie.confidence,
            "lift": trie.lift,
            "depth": trie.node_depth,
            "node_item": trie.node_item,
            "post_lo": trie.post_lo,
            "post_hi": trie.post_hi,
            "item_offsets": host(trie.item_offsets),
            "dfs_to_node": trie.dfs_to_node,
            "max_postings": int(trie.max_postings),
            **_dequant_statics(trie),
        }

    dev = trie.device if isinstance(trie, DeviceTrie) else \
        resolve_device(device)
    offsets = host(trie.item_offsets)
    item_nodes = host(trie.item_nodes)
    dfs_order = host(trie.dfs_order)
    subtree = host(trie.subtree_size)
    d2n = host(trie.dfs_to_node)
    n = dfs_order.shape[0]
    post_lo = dfs_order[item_nodes].astype(np.int64)
    post_hi_raw = post_lo + subtree[item_nodes].astype(np.int64)
    # per-item ascending subtree ends: one composite-key argsort
    seg = np.repeat(
        np.arange(offsets.shape[0] - 1, dtype=np.int64), np.diff(offsets)
    )
    order = np.argsort(seg * (n + 1) + post_hi_raw, kind="stable")
    post_hi = post_hi_raw[order]
    sup = host(trie.support)
    conf = host(trie.confidence)
    lift = host(trie.lift)
    depth = host(trie.node_depth).astype(np.int32)
    nitem = host(trie.node_item).astype(np.int32)
    max_postings = (
        int(np.diff(offsets).max()) if offsets.shape[0] > 1 else 0
    )

    def t(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(a).to(dev)

    return {
        "support": t(sup[d2n]),
        "confidence": t(conf[d2n]),
        "lift": t(lift[d2n]),
        "depth": t(depth[d2n]),
        "node_item": t(nitem[d2n]),
        "post_lo": t(post_lo, np.int32),
        "post_hi": t(post_hi, np.int32),
        "item_offsets": offsets,
        "item_nodes": t(item_nodes, np.int32),
        "dfs_to_node": t(d2n, np.int32),
        "max_postings": max_postings,
        "p_support": t(sup[item_nodes]),
        "p_confidence": t(conf[item_nodes]),
        "p_lift": t(lift[item_nodes]),
        "p_depth": t(depth[item_nodes]),
    }


def _pad_pow2_rows(plos, phis, qitems) -> tuple:
    """Pad deduped query rows up to ``launch_pad`` with absent-item
    queries (empty slice ``[0, 0)``, item -1)."""
    u = qitems.shape[0]
    pad = launch_pad(u) - u
    if pad == 0:
        return plos, phis, qitems
    return (
        np.pad(plos, (0, pad)),
        np.pad(phis, (0, pad)),
        np.pad(qitems, (0, pad), constant_values=-1),
    )


def _posting_slices(offsets: np.ndarray, items) -> tuple:
    """Per-query posting slice ``[plo, phi)`` and sanitized item ids:
    absent items get the empty slice and id -1.  The ``safe + 1`` index
    is clipped too, so an empty item universe (``offsets == [0]``) gives
    empty slices where the reference indexes past the table."""
    valid, safe, qitems = sanitize_query_items(items, offsets.shape[0] - 1)
    plos = np.where(valid, offsets[safe], 0).astype(np.int32)
    hi = np.minimum(safe + 1, offsets.shape[0] - 1)
    phis = np.where(valid, offsets[hi], 0).astype(np.int32)
    return plos, phis, qitems


def rules_with(
    trie, items, role: str = "any", k: int = 10, metric: str = "confidence",
    min_depth: int = 1, arrays: Optional[Dict] = None,
    use_kernel: bool = True, strict: bool = False, device=None,
) -> Dict[str, torch.Tensor]:
    """Top-k rules involving each queried item, Q items in one kernel
    call.  ``role="consequent"`` ranks the item's posting range with the
    rank kernel over posting-ordered columns; the antecedent and any roles
    go through the membership kernel, and so does the consequent role on
    a compressed trie, which has no posting-ordered columns.  Returns
    ``{"values" f32[Q, k], "node" int32[Q, k], "pos" int32[Q, k]}``
    (``pos``: posting index for the consequent role on the plain layout,
    DFS position otherwise).  Duplicate items dedup before the launch and
    expand back after it."""
    if role not in ROLES:
        raise InvalidQueryError(f"role {role!r} not in {ROLES}")
    if metric not in RANK_METRICS:
        raise InvalidQueryError(f"metric {metric!r} not in {RANK_METRICS}")
    _validate_k(k, "rules_with")
    _require_supported(trie, "rules_with")
    if arrays is None:
        arrays = item_rank_arrays(trie, device)
    items = validate_items(
        items, "rules_with",
        n_items=arrays["item_offsets"].shape[0] - 1, strict=strict,
    )
    plos, phis, qitems = _posting_slices(arrays["item_offsets"], items)
    _, first, inv = np.unique(qitems, return_index=True, return_inverse=True)
    plos, phis, qitems = _pad_pow2_rows(
        plos[first], phis[first], qitems[first]
    )
    dev = arrays["support"].device
    plos_t, phis_t = _int32(plos, dev), _int32(phis, dev)
    if role == "consequent" and "p_support" in arrays:
        rank_fn = topk_rank_batch if use_kernel else topk_rank_batch_ref
        vals, pos = rank_fn(
            arrays["p_support"], arrays["p_confidence"], arrays["p_lift"],
            arrays["p_depth"], plos_t, phis_t,
            k=int(k), metric=metric, min_depth=int(min_depth),
        )
        back = arrays["item_nodes"]
    else:
        member_fn = rules_with_member if use_kernel else rules_with_ref
        vals, pos = member_fn(
            arrays["support"], arrays["confidence"], arrays["lift"],
            arrays["depth"], arrays["node_item"],
            arrays["post_lo"], arrays["post_hi"],
            plos_t, phis_t, _int32(qitems, dev),
            k=int(k), metric=metric, min_depth=int(min_depth), role=role,
            **_dequant_statics(arrays),
        )
        back = arrays["dfs_to_node"]
    inv_t = torch.as_tensor(np.asarray(inv).reshape(-1), device=dev).long()
    vals = vals[inv_t]
    pos = pos[inv_t]
    return {"values": vals, "node": _back_map(pos, back), "pos": pos}


# ----------------------------------------------------------------------
# traversal reduction
# ----------------------------------------------------------------------
def trie_reduce(trie, device=None) -> Dict[str, torch.Tensor]:
    """The visit-every-rule pass: ``n_rules``, ``support_sum``,
    ``confidence_max`` and ``mean_conf`` as f32 scalars."""
    dt = _device_trie(trie, device)
    dq = _dequant_statics(dt)
    n, sup_sum, conf_max, conf_sum = trie_reduce_columns(
        dt.support, dt.confidence, dt.node_depth,
        n_transactions=dq["n_transactions"],
        confidence_scale=dq["confidence_scale"],
    )
    return {
        "n_rules": n,
        "support_sum": sup_sum,
        "confidence_max": conf_max,
        "mean_conf": conf_sum / n.clamp(min=1.0),
    }
