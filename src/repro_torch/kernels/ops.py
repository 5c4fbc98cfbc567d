"""The batched query ops over a frozen trie (search, ranking, item-scoped
ranking and traversal), and the support counting and batched annotation of
trie construction.

PyTorch port of the main path of ``repro.kernels.ops``.  Host-side work
stays numpy or plain torch, as the reference keeps it outside its
kernels: query validation, canonicalization and dedup, the prefix
descent (``child_lookup``), and the position-to-node back-maps.  Each op
then makes one kernel call (``rank.topk_rank_batch``,
``rule_search.rule_search_fused``, ``item_index.rules_with_member`` or
``trie_reduce.trie_reduce_stats``), which on CUDA tensors launches the
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
kernel (``_dequant_statics``).  A seed-layout ``DeviceTrie``
(``child_offsets`` None) runs every query op too: the search as two
``rule_search.rule_search_sweep`` calls (the full rows, then the
consequent columns alone for compound lift), the prefix descent by a
lower bound over the lex-sorted edge table, and the rankings and the
reduction over its DFS and posting columns as on the CSR layout.

A ``core.delta_trie.StreamingTrie`` (a frozen base plus a delta overlay)
answers the search and ranking ops through ``kernels.streaming``: the
frozen side runs the kernels above on the stream's device, and the
delta side and the k-best merge are tensor ops, bit-identical to the op
on a from-scratch rebuild.  It has no ``trie_reduce`` or column-dict
path, as in the reference.

A ``distributed.trie_sharding.ShardPlan`` (a trie cut into contiguous
DFS subtree ranges over a ``launch.mesh.TrieMesh``) answers
``rule_search_batch``, ``top_k_rules_batch`` / ``top_k_rules`` and
``rules_with``: each shard runs the kernels above on its own device over
its own range, and the answers merge on the mesh's lead device, bitwise
the single-device op's.  Every other op refuses a plan, as the reference
has no sharded form of it.

Each wrapper chooses its kernel or its plain version by
``interpret_mode``: the plain version on the CPU, the kernel on CUDA
(``REPRO_TORCH_FORCE_INTERPRET`` can only assert one of the two, and
raises where the device disagrees).  It lives in ``_build``, beside the
launches, since the wrappers import it and this module imports them.
Launch knobs resolve at call time from ``tuning.get_kernel_config()``.

Every kernel dispatch runs under ``_profiled``, the launch profiler's
hook (``obs.profile.kernel_profiler``): disabled, it costs one attribute
read.
"""
from __future__ import annotations

from time import perf_counter
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
from repro_torch.core.delta_trie import StreamingTrie
from repro_torch.obs.profile import kernel_profiler

from ._build import interpret_mode  # noqa: F401  (the reference's ops name)
from .item_index import ROLES, rules_with_member
from .metrics_inkernel import RANK_METRICS, compound_lift, rank_score
from .rank import topk_rank_batch
from .ref import members_from_candidates  # noqa: F401  (the reference's ops name)
from .ref import rules_with_ref, topk_rank_batch_ref
from .ref import (
    rule_search_fused_ref, rule_search_span_ref, rule_search_sweep_ref,
)
from .rule_search import rule_search_fused, rule_search_span, rule_search_sweep
from .support_count import support_count_bitmap
from .trie_reduce import trie_reduce_stats
from .tuning import launch_pad


# ----------------------------------------------------------------------
# kernel-launch profiling (obs: one timing ring per op)
# ----------------------------------------------------------------------
def _profiled(op, fn, *, rows, shape, device, live=None, n_shards=1):
    """Run one kernel dispatch under the launch profiler.

    Disabled (the default): one attribute read, then ``fn()`` untouched.
    Enabled: ``device`` is synchronized before the clock stops (honest
    wall time under CUDA's asynchronous launches) and the record lands
    in the per-op ring, fanning out to the bound registry and any
    observers."""
    if not kernel_profiler.enabled:
        return fn()
    t0 = perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rows = max(int(rows), 1)
    live_rows = rows if live is None else min(max(int(live), 1), rows)
    kernel_profiler.record(
        op, rows=rows, shape=tuple(int(x) for x in shape),
        seconds=perf_counter() - t0,
        pad_factor=rows / live_rows,
        n_shards=int(n_shards),
    )
    return out


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
    """Refuse a sharded plan or a stream where ``op`` has no sharded or
    streaming path (the batched search and ranking ops dispatch both
    before reaching here)."""
    if _as_shard_plan(trie) is not None:
        raise NotImplementedError(
            f"{op}: a ShardPlan answers rule_search_batch, "
            f"top_k_rules_batch, top_k_rules and rules_with only; the "
            f"reference has no sharded {op}: run it on plan.frozen"
        )
    if isinstance(trie, StreamingTrie):
        raise NotImplementedError(
            f"{op}: a StreamingTrie answers rule_search, top_k_rules, "
            f"rules_with and their batched forms only; ROADMAP slice 4 "
            f"(streaming) ports no streaming {op}, as the reference has "
            f"none: run it on stream.frozen after stream.refreeze()"
        )


def _as_shard_plan(trie):
    """The ShardPlan when ``trie`` is one, else None (imported here:
    ``distributed.trie_sharding`` imports this module)."""
    from repro_torch.distributed.trie_sharding import ShardPlan

    return trie if isinstance(trie, ShardPlan) else None


def _as_streaming(trie):
    """The StreamingTrie when ``trie`` is one, else None."""
    return trie if isinstance(trie, StreamingTrie) else None


def _refuse_with_plan(op: str, what: str) -> None:
    raise ValueError(
        f"sharded {op} takes no {what}: the plan already owns its "
        f"(sharded) device residency; drop the argument"
    )


def _refuse_with_stream(op: str, what: str) -> None:
    raise ValueError(
        f"streaming {op} takes no {what}: the stream owns its "
        f"(epoch-versioned) residency; drop the argument"
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
    """Child-node metrics gathered onto the edges once, the edge parents
    the seed layout's full sweep matches, and the CSR bucket index the
    fused search descends (``child_offsets`` None on the seed layout).

    A compressed trie returns its span tables instead, marked
    ``"layout": "compressed"``: the compressed CSR, the span edge columns
    and the position-indexed (possibly quantized) metric columns, the
    trie's own tensors with no gathers."""
    _require_supported(trie, "edge_metric_arrays")
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
        "edge_parent": dt.edge_parent,
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
    use_kernel: bool = True,
) -> Dict[str, torch.Tensor]:
    """Rule search with full paper metrics (compound lift included) for
    canonical int32 rows ``[Q, L]`` (-1 padded): one fused kernel call,
    or on the seed layout two full-sweep calls.  Returns
    found/node/support/confidence/lift, each ``[Q]``.  ``use_kernel=False``
    runs the plain versions on any device.

    ``trie`` may also be a ``StreamingTrie`` (answered on its own device
    through ``kernels.streaming``)."""
    stream = _as_streaming(trie)
    if stream is not None:
        if edges is not None:
            _refuse_with_stream("rule_search", "edges=")
        from .streaming import streaming_rule_search_batch

        return streaming_rule_search_batch(stream, queries, ant_len,
                                           use_kernel=use_kernel)
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
    # live rows (any real item) are the pad factor's denominator
    rows = dict(rows=queries.shape[0], shape=queries.shape, device=dev,
                live=(int((queries >= 0).any(dim=1).sum())
                      if kernel_profiler.enabled else None))
    if edges.get("layout") == "compressed":
        span_fn = rule_search_span if use_kernel else rule_search_span_ref
        out = _profiled("rule_search", lambda: span_fn(
            edges["child_offsets"], edges["edge_item"], edges["edge_pos"],
            edges["edge_span"], edges["edge_tail"], edges["node_item"],
            edges["support"], edges["confidence"], edges["lift"],
            queries, ant_len, max_fanout=edges["max_fanout"],
            **_dequant_statics(edges),
        ), **rows)
        # the span kernel answers DFS positions (-1 when absent); the op
        # answers node ids
        return {
            "found": out["found"],
            "node": _back_map(out["pos"], edges["dfs_to_node"]),
            "support": out["support"],
            "confidence": out["confidence"],
            "lift": out["lift"],
        }
    if edges["child_offsets"] is None:
        sweep_fn = rule_search_sweep if use_kernel else rule_search_sweep_ref
        return _seed_rule_search(
            edges, queries, ant_len,
            lambda *a: _profiled("rule_search", lambda: sweep_fn(*a),
                                 **rows),
        )
    fused_fn = rule_search_fused if use_kernel else rule_search_fused_ref
    out = _profiled("rule_search", lambda: fused_fn(
        edges["child_offsets"], edges["edge_item"], edges["edge_child"],
        edges["edge_conf"], edges["edge_sup"], edges["edge_lift"],
        queries, ant_len, max_fanout=edges["max_fanout"],
    ), **rows)
    # con_support feeds the sharded merge, not the op-level contract
    return {k: v for k, v in out.items() if k != "con_support"}


def _seed_rule_search(edges, queries, ant_len,
                      sweep) -> Dict[str, torch.Tensor]:
    """The seed layout's search: one full sweep over the rows, and one over
    their consequent columns alone (the antecedent blanked, ``ant_len``
    0) for the consequent-path Support that compound lift divides by."""
    cols = (edges["edge_parent"], edges["edge_item"], edges["edge_child"],
            edges["edge_conf"], edges["edge_sup"], edges["edge_lift"])
    full = sweep(*cols, queries, ant_len)
    width = queries.shape[1]
    pos = torch.arange(width, dtype=torch.int32, device=queries.device)
    cons_q = torch.where(pos[None, :] >= ant_len[:, None], queries, -1)
    cons = sweep(*cols, cons_q, torch.zeros_like(ant_len))
    seq_len = (queries >= 0).sum(dim=1, dtype=torch.int32)
    single = (seq_len - ant_len) == 1
    return {
        "found": full["found"],
        "node": full["node"],
        "support": full["support"],
        "confidence": full["confidence"],
        "lift": compound_lift(full["found"], single, full["node_lift"],
                              full["confidence"], cons["support"]),
    }


def rule_search_batch(
    trie, queries, ant_len=None, edges: Optional[Dict] = None,
    strict: bool = False, device=None, use_kernel: bool = True,
) -> Dict[str, torch.Tensor]:
    """Search Q rules in one kernel call: ``queries`` is a sequence of
    ``(antecedent, consequent)`` pairs (canonicalized host-side through
    ``FrozenTrie.canonicalize_queries``) or a canonical ``[Q, L]`` matrix
    with ``ant_len``.  The batch dedups to its unique rows and scatters
    results back.

    Or a ``StreamingTrie``: the frozen kernel plus a host recompute of the
    rows touching modified rules (``kernels.streaming``), bit-identical to
    a from-scratch rebuild of frozen+delta."""
    stream = _as_streaming(trie)
    if stream is not None:
        if edges is not None:
            _refuse_with_stream("rule_search_batch", "edges=")
        from .streaming import streaming_rule_search_batch

        return streaming_rule_search_batch(stream, queries, ant_len,
                                           strict=strict,
                                           use_kernel=use_kernel)
    plan = _as_shard_plan(trie)
    if ant_len is None and not isinstance(queries, np.ndarray):
        queries = list(queries)
        validate_rule_pairs(
            queries, "rule_search_batch",
            item_rank=getattr(plan.frozen if plan is not None else trie,
                              "item_rank", None),
            strict=strict,
        )
    if plan is not None:
        if edges is not None:
            _refuse_with_plan("rule_search_batch", "edges=")
        from repro_torch.distributed.trie_sharding import (
            sharded_rule_search_batch,
        )

        n_q = (queries.shape[0] if isinstance(queries, np.ndarray)
               else len(queries))
        return _profiled(
            "rule_search",
            lambda: sharded_rule_search_batch(plan, queries, ant_len,
                                              use_kernel=use_kernel),
            rows=n_q, shape=(n_q,), device=plan.device,
            n_shards=plan.n_shards,
        )
    _require_supported(trie, "rule_search_batch")
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
                edges=edges, device=device, use_kernel=use_kernel,
            )
        queries, ant_len = canonicalize(
            [p[0] for p in pairs], [p[1] for p in pairs]
        )
    uq, ual, inv = dedup_query_rows(queries, ant_len)
    out = rule_search(trie, uq, ual, edges=edges, device=device,
                      use_kernel=use_kernel)
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
    _require_supported(trie, "dfs_rank_arrays")
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
    _require_supported(trie, "prefix_ranges")
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
        plan = _as_shard_plan(trie)
        validate_prefixes(
            [prefix], "top_k_rules",
            item_rank=getattr(plan.frozen if plan is not None else trie,
                              "item_rank", None),
        )
    stream = _as_streaming(trie)
    if stream is not None:
        if arrays is not None:
            _refuse_with_stream("top_k_rules", "arrays=")
        from .streaming import streaming_top_k_rules

        return streaming_top_k_rules(
            stream, k, metric=metric, prefix=prefix, min_depth=min_depth,
            use_kernel=use_kernel,
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
    plan = _as_shard_plan(trie)
    if not isinstance(prefixes, np.ndarray):
        prefixes = list(prefixes)
    validate_prefixes(
        prefixes, "top_k_rules_batch",
        item_rank=getattr(plan.frozen if plan is not None else trie,
                          "item_rank", None),
        strict=strict,
    )
    stream = _as_streaming(trie)
    if stream is not None:
        if arrays is not None:
            _refuse_with_stream("top_k_rules_batch", "arrays=")
        from .streaming import streaming_top_k_rules_batch

        return streaming_top_k_rules_batch(
            stream, prefixes, k, metric=metric, min_depth=min_depth,
            use_kernel=use_kernel,
        )
    if plan is not None:
        if arrays is not None:
            _refuse_with_plan("top_k_rules_batch", "arrays=")
        from repro_torch.distributed.trie_sharding import (
            sharded_top_k_rules_batch,
        )

        return _profiled(
            "top_k",
            lambda: sharded_top_k_rules_batch(
                plan, prefixes, k, metric=metric, min_depth=min_depth,
                use_kernel=use_kernel,
            ),
            rows=len(prefixes), shape=(len(prefixes), int(k)),
            device=plan.device, n_shards=plan.n_shards,
        )
    _require_supported(trie, "top_k_rules_batch")
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
    vals, pos = _profiled("top_k", lambda: rank_fn(
        arrays["support"], arrays["confidence"], arrays["lift"],
        arrays["depth"], los, his,
        k=int(k), metric=metric, min_depth=int(min_depth),
        **_dequant_statics(arrays),
    ), rows=len(prefixes), shape=(len(prefixes), int(k)), device=dev)
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
    expand back after it.  ``trie`` may also be a ``StreamingTrie``
    (``kernels.streaming``; ``pos`` in rebuilt coordinates)."""
    if role not in ROLES:
        raise InvalidQueryError(f"role {role!r} not in {ROLES}")
    if metric not in RANK_METRICS:
        raise InvalidQueryError(f"metric {metric!r} not in {RANK_METRICS}")
    _validate_k(k, "rules_with")
    stream = _as_streaming(trie)
    if stream is not None:
        if arrays is not None:
            _refuse_with_stream("rules_with", "arrays=")
        from .streaming import streaming_rules_with

        return streaming_rules_with(
            stream, items, role=role, k=k, metric=metric,
            min_depth=min_depth, strict=strict, use_kernel=use_kernel,
        )
    plan = _as_shard_plan(trie)
    if plan is not None:
        if arrays is not None:
            _refuse_with_plan("rules_with", "arrays=")
        items = validate_items(
            items, "rules_with",
            n_items=plan.local_item_offsets.shape[1] - 1, strict=strict,
        )
        from repro_torch.distributed.trie_sharding import sharded_rules_with

        return _profiled(
            "rules_with",
            lambda: sharded_rules_with(
                plan, items, role=role, k=k, metric=metric,
                min_depth=min_depth, use_kernel=use_kernel,
            ),
            rows=len(items), shape=(len(items), int(k)),
            device=plan.device, n_shards=plan.n_shards,
        )
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
    rows = dict(
        rows=plos.shape[0], shape=(int(plos.shape[0]), int(k)), device=dev,
        live=(int(np.count_nonzero(np.asarray(qitems) >= 0))
              if kernel_profiler.enabled else None),
    )
    if role == "consequent" and "p_support" in arrays:
        rank_fn = topk_rank_batch if use_kernel else topk_rank_batch_ref
        vals, pos = _profiled("rules_with", lambda: rank_fn(
            arrays["p_support"], arrays["p_confidence"], arrays["p_lift"],
            arrays["p_depth"], plos_t, phis_t,
            k=int(k), metric=metric, min_depth=int(min_depth),
        ), **rows)
        back = arrays["item_nodes"]
    else:
        member_fn = rules_with_member if use_kernel else rules_with_ref
        vals, pos = _profiled("rules_with", lambda: member_fn(
            arrays["support"], arrays["confidence"], arrays["lift"],
            arrays["depth"], arrays["node_item"],
            arrays["post_lo"], arrays["post_hi"],
            plos_t, phis_t, _int32(qitems, dev),
            k=int(k), metric=metric, min_depth=int(min_depth), role=role,
            **_dequant_statics(arrays),
        ), **rows)
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
    ``confidence_max`` and ``mean_conf`` as f32 scalars, all four from the
    reduction's one launch (the mean ``Σ confidence / max(n, 1)`` too)."""
    _require_supported(trie, "trie_reduce")
    dt = _device_trie(trie, device)
    dq = _dequant_statics(dt)
    n_nodes = int(dt.support.shape[0])
    n, sup_sum, conf_max, _, mean = _profiled(
        "trie_reduce",
        lambda: trie_reduce_stats(
            dt.support, dt.confidence, dt.node_depth,
            n_transactions=dq["n_transactions"],
            confidence_scale=dq["confidence_scale"],
        ),
        rows=n_nodes, shape=(n_nodes,), device=dt.device,
    )
    return {
        "n_rules": n,
        "support_sum": sup_sum,
        "confidence_max": conf_max,
        "mean_conf": mean,
    }
