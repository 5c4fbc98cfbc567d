"""Frozen+delta k-best merging: StreamingTrie answers for the batched ops.

PyTorch port of ``repro.kernels.streaming``.  Every batched op in
``kernels.ops`` accepts a ``core.delta_trie.StreamingTrie`` and lands
here: the frozen side runs the op's normal kernel path on the stream's
device (the rank, membership and fused search kernels), the delta side
ranks the overlay entries with the same ``metrics_inkernel.rank_score``,
and the two k-best lists fold through ``rank.rank_merge``, in REBUILT DFS
coordinates, so the result is bit-identical (tie order included) to
running the op on a from-scratch rebuild of frozen+delta.

Coordinate plumbing (all precomputed per epoch by the overlay):

* frozen k-best positions remap monotonically (``p -> p + shift[p]``),
  preserving each row's (value desc, pos asc) invariant, so the two
  inputs of ``rank_merge`` are both internally sorted as it requires;
* stale frozen copies of UPDATED rules never reach the merge: their
  depth column is patched to ``-1`` in a per-epoch clone of the frozen
  base's resident columns (``index_fill_`` on the device), which the
  rank kernels' ``depth >= min_depth`` filter drops for any
  ``min_depth >= 0`` while leaving descent structure untouched;
* node ids come from ``r2n`` (rebuilt position -> rebuilt BFS id), and
  the consequent-role posting contract from the rebuilt posting tables,
  both exactly what the rebuild would emit;
* rule search needs no ranking: the frozen kernel answers as-is except
  on rows whose path (or consequent path) touches a modified rule;
  those recompute host-side in np.float32 mirroring the fused kernel's
  scan-order arithmetic, with the final Eq. 1-4 lift select through the
  shared ``compound_lift``.

The delta side's k-best is the reference's ``jax.lax.top_k``: IEEE total
order (+NaN above +inf, +0.0 above -0.0, -NaN below -inf), lower index
first among equal values.  ``torch.topk`` promises no tie order, so the
port sorts a total-order integer key of the scores with a stable
descending sort.

The frozen base is uploaded once per base (it changes only at a
refreeze) and cached on the stream; each epoch's overlay columns and
masked column copies are cached on its overlay.  With a mesh on the
stream the frozen side is its ``ShardPlan`` (``StreamingTrie.shard_plan``,
updated nodes' depth already -1 there), and ``base=`` overrides the
frozen side (the resilience ladder's dead-shard-masked plan): the
sharded ops answer on the plan's lead device, and their answers move to
the stream's device for the merge.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.array_trie import (
    canonical_prefix_rows,
    sanitize_query_items,
)

from . import ops
from .metrics_inkernel import compound_lift, rank_score
from .rank import rank_merge

# the reference's k-buffer padding granularity (``repro.kernels.rank.LANE``):
# the merge runs over k rounded up to it, so padding behaves the same
LANE = 128
# elements of one [rows, kpad, kpad] merge block
_MERGE_ELEMS = 1 << 24


def _kpad(k: int) -> int:
    return int(k) + (-int(k) % LANE)


def resident(stream, what: str):
    """The frozen base's device residency, built once per base: ``"dt"``
    (its ``DeviceTrie``), ``"rank"`` (``dfs_rank_arrays``), ``"item"``
    (``item_rank_arrays``), ``"edges"`` (``edge_metric_arrays``) and
    ``"post_of"`` (host: frozen node id -> posting index)."""
    res = stream._resident
    if res is None or res["frozen"] is not stream.frozen:
        fz = stream.frozen
        res = {"frozen": fz, "dt": fz.device_arrays(device=stream.device)}
        stream._resident = res
    if what not in res:
        dt = res["dt"]
        if what == "rank":
            arrs = ops.dfs_rank_arrays(dt)
            arrs["_device_trie"] = dt
            res[what] = arrs
        elif what == "item":
            res[what] = ops.item_rank_arrays(dt)
        elif what == "edges":
            res[what] = ops.edge_metric_arrays(dt)
        elif what == "post_of":
            nodes = np.asarray(res["frozen"].item_nodes, np.int64)
            post_of = np.full((res["frozen"].n_nodes,), -1, np.int64)
            post_of[nodes] = np.arange(nodes.size, dtype=np.int64)
            res[what] = post_of
        else:
            raise KeyError(what)
    return res[what]


def _base(stream, base=None):
    """The frozen side of the merge: an explicit override (the resilient
    engine's dead-masked plan), else the stream's plan, else the frozen
    trie itself."""
    if base is not None:
        return base
    plan = stream.shard_plan()
    return plan if plan is not None else stream.frozen


def _on_stream(stream, out: Dict[str, torch.Tensor]):
    """A sharded op's answers moved to the stream's device."""
    return {key: v.to(stream.device) for key, v in out.items()}


def _ov_device(stream) -> Dict[str, torch.Tensor]:
    """Overlay columns on the stream's device, cached for the epoch."""
    ov = stream.overlay()
    dev = ov.cache.get("device")
    if dev is None:
        def t(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.int32)
            ).to(stream.device)

        dev = {
            "pos": t(ov.pos),
            "shift": t(ov.shift),
            "old2new": t(ov.old2new),
            "r2n": t(ov.r2n),
            "post_index": t(ov.post_index),
            "post_nodes": t(ov.post_nodes),
        }
        ov.cache["device"] = dev
    return dev


def _delta_scores(stream, metric: str) -> torch.Tensor:
    """rank_score over the delta metric columns, cached per metric: the
    SAME scoring expression the rank kernels evaluate."""
    ov = stream.overlay()
    key = ("score", metric)
    s = ov.cache.get(key)
    if s is None:
        def t(a):
            return torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.float32)
            ).to(stream.device)

        s = rank_score(
            metric, t(ov.support), t(ov.confidence), t(ov.lift)
        ).to(torch.float32)
        ov.cache[key] = s
    return s


def _masked(col: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """A copy of ``col`` with ``-1`` at ``idx``."""
    at = torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(col.device)
    return col.clone().index_fill_(0, at, -1)


def _rank_arrays(stream) -> Dict[str, torch.Tensor]:
    """The frozen base's rank columns with updated nodes' depth masked to
    -1 (the stale-copy suppression), cached for the epoch."""
    ov = stream.overlay()
    arrs = ov.cache.get("rank_arrays")
    if arrs is None:
        arrs = resident(stream, "rank")
        if ov.masked_nodes.size:
            dfs = stream._host_arrays()["dfs"]
            arrs = dict(arrs)
            arrs["depth"] = _masked(arrs["depth"], dfs[ov.masked_nodes])
        ov.cache["rank_arrays"] = arrs
    return arrs


def _item_arrays(stream) -> Dict:
    """The frozen base's inverted-index columns with updated nodes' depth
    masked to -1 in BOTH the DFS-ordered and posting-ordered blocks."""
    ov = stream.overlay()
    arrs = ov.cache.get("item_arrays")
    if arrs is None:
        arrs = resident(stream, "item")
        if ov.masked_nodes.size:
            dfs = stream._host_arrays()["dfs"]
            post_of = resident(stream, "post_of")
            arrs = dict(arrs)
            arrs["depth"] = _masked(arrs["depth"], dfs[ov.masked_nodes])
            arrs["p_depth"] = _masked(arrs["p_depth"],
                                      post_of[ov.masked_nodes])
        ov.cache["item_arrays"] = arrs
    return arrs


def total_order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys ordered as IEEE 754 totalOrder orders the f32 scores:
    -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN, the order
    ``jax.lax.top_k`` ranks by."""
    bits = scores.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _delta_topk(scores: torch.Tensor, dpos: torch.Tensor, kpad: int):
    """Per-query k-best over the delta entries: ``scores`` is [Q, D]
    with -inf at non-matching entries, ``dpos`` the [D] merge positions
    (ascending per query by construction, so the lower-index-first tie
    rule IS the (value desc, pos asc) order)."""
    d = scores.shape[1]
    if d < kpad:
        scores = torch.nn.functional.pad(
            scores, (0, kpad - d), value=-torch.inf
        )
        dpos = torch.nn.functional.pad(dpos, (0, kpad - d), value=-1)
    idx = torch.sort(
        total_order_key(scores), dim=1, descending=True, stable=True
    ).indices[:, :kpad]
    vals = torch.gather(scores, 1, idx)
    pos = torch.where(vals > -torch.inf, dpos[idx], -1)
    return vals, pos.to(torch.int32)


def _merge(fvals, fpos, dvals, dpos, k: int):
    """rank_merge the frozen and delta k-best lists (both [Q, *] in
    rebuilt positions) and slice back to k columns."""
    kpad = _kpad(k)
    pad = kpad - fvals.shape[1]
    if pad:
        fvals = torch.nn.functional.pad(fvals, (0, pad), value=-torch.inf)
        fpos = torch.nn.functional.pad(fpos, (0, pad), value=-1)
    fpos = fpos.to(torch.int32)
    step = max(1, _MERGE_ELEMS // (kpad * kpad))
    vals, pos = [], []
    for r0 in range(0, fvals.shape[0], step):
        sl = slice(r0, r0 + step)
        mv, mp = rank_merge(fvals[sl], fpos[sl], dvals[sl], dpos[sl], kpad)
        vals.append(mv[:, :k])
        pos.append(mp[:, :k])
    return torch.cat(vals), torch.cat(pos)


def _back(pos: torch.Tensor, back: torch.Tensor) -> torch.Tensor:
    return torch.where(pos >= 0, back[pos.clamp(min=0).long()], -1)


def _prefix_match(stream, prefixes) -> np.ndarray:
    """bool [Q, D]: does delta entry d's path start with prefix q?
    Canonicalization mirrors ``prefix_ranges`` (only -1 is padding;
    other invalid items match nothing, like any absent item)."""
    ov = stream.overlay()
    rows = canonical_prefix_rows(prefixes, stream.frozen.item_rank)
    q = len(rows)
    wp = max((len(r) for r in rows), default=0)
    pm = np.full((q, max(wp, 1)), -1, np.int64)
    for i, r in enumerate(rows):
        pm[i, : len(r)] = r
    paths = ov.paths.astype(np.int64)
    w = paths.shape[1]
    if pm.shape[1] > w:
        paths = np.pad(
            paths, ((0, 0), (0, pm.shape[1] - w)), constant_values=-1
        )
    paths = paths[:, : pm.shape[1]]
    return np.all(
        (pm[:, None, :] == -1) | (pm[:, None, :] == paths[None, :, :]),
        axis=2,
    )


def _delta_side(stream, match: np.ndarray, metric: str, dmerge, k: int):
    scores = torch.where(
        torch.from_numpy(match).to(stream.device),
        _delta_scores(stream, metric)[None, :],
        -torch.inf,
    )
    return _delta_topk(scores, dmerge, _kpad(k))


# ----------------------------------------------------------------------
# ranked ops
# ----------------------------------------------------------------------
def streaming_top_k_rules_batch(
    stream, prefixes, k: int, metric: str = "confidence",
    min_depth: int = 1, use_kernel: bool = True, base=None,
) -> Dict[str, torch.Tensor]:
    """top_k_rules_batch over frozen+delta (inputs pre-validated by the
    ops dispatch).  ``use_kernel=False`` runs the frozen side's plain
    version."""
    fb = _base(stream, base)
    kw = dict(metric=metric, min_depth=min_depth, use_kernel=use_kernel)
    if ops._as_shard_plan(fb) is not None:
        fout = _on_stream(stream, ops.top_k_rules_batch(fb, prefixes, k,
                                                        **kw))
        if stream.is_identity:
            return fout
    elif stream.is_identity:
        return ops.top_k_rules_batch(
            fb, prefixes, k, arrays=resident(stream, "rank"), **kw
        )
    else:
        fout = ops.top_k_rules_batch(
            fb, prefixes, k, arrays=_rank_arrays(stream), **kw
        )
    if len(prefixes) == 0:
        return fout
    ov = stream.overlay()
    dev = _ov_device(stream)

    fpos = fout["dfs_pos"]
    rpos = torch.where(
        fpos >= 0, fpos + dev["shift"][fpos.clamp(min=0).long()], -1
    )
    match = _prefix_match(stream, prefixes)
    match &= ov.depth[None, :] >= int(min_depth)
    dvals, dpos = _delta_side(stream, match, metric, dev["pos"], k)
    vals, pos = _merge(fout["values"], rpos, dvals, dpos, int(k))
    return {"values": vals, "node": _back(pos, dev["r2n"]), "dfs_pos": pos}


def streaming_top_k_rules(
    stream, k: int, metric: str = "confidence", prefix=None,
    min_depth: int = 1, use_kernel: bool = True, base=None,
) -> Dict[str, torch.Tensor]:
    """Q=1 slice of the batched form (identical merge path)."""
    out = streaming_top_k_rules_batch(
        stream, [prefix if prefix is not None else []], k,
        metric=metric, min_depth=min_depth, use_kernel=use_kernel,
        base=base,
    )
    return {key: v[0] for key, v in out.items()}


def streaming_rules_with(
    stream, items, role: str = "any", k: int = 10,
    metric: str = "confidence", min_depth: int = 1,
    strict: bool = False, use_kernel: bool = True, base=None,
) -> Dict[str, torch.Tensor]:
    """rules_with over frozen+delta.  ``pos`` keeps the op contract in
    REBUILT coordinates: the rebuilt posting index for the (plain
    layout) consequent role, the rebuilt DFS position otherwise."""
    fb = _base(stream, base)
    plan = ops._as_shard_plan(fb)
    if not isinstance(items, np.ndarray):
        items = list(items)
    kw = dict(role=role, k=k, metric=metric, min_depth=min_depth,
              strict=strict, use_kernel=use_kernel)
    if plan is not None:
        fout = _on_stream(stream, ops.rules_with(plan, items, **kw))
        if stream.is_identity:
            return fout
    elif stream.is_identity:
        return ops.rules_with(fb, items, arrays=resident(stream, "item"),
                              **kw)
    else:
        fout = ops.rules_with(fb, items, arrays=_item_arrays(stream), **kw)
    qitems = np.asarray(items, np.int64).reshape(-1)
    if qitems.shape[0] == 0:
        return fout
    ov = stream.overlay()
    dev = _ov_device(stream)
    n_items = int(stream.frozen.item_rank.shape[0])
    _, _, qit = sanitize_query_items(qitems, n_items)
    qit = np.asarray(qit, np.int64).reshape(-1)

    # delta membership per role
    paths = ov.paths
    plen = ov.path_len
    cols = np.arange(paths.shape[1])
    in_path = cols[None, :] < plen[:, None]
    is_last = cols[None, :] == (plen[:, None] - 1)
    eq = paths[None, :, :] == qit[:, None, None]     # [Q, D, W]
    if role == "consequent":
        match = np.any(eq & is_last[None, :, :], axis=2)
    elif role == "antecedent":
        match = np.any(eq & (in_path & ~is_last)[None, :, :], axis=2)
    else:
        match = np.any(eq & in_path[None, :, :], axis=2)
    match &= ov.depth[None, :] >= int(min_depth)

    fpos = fout["pos"]
    live = fpos >= 0
    if role == "consequent":
        # streams are plain-layout, so the consequent role ranks posting
        # indices: merge in rebuilt POSTING coordinates (the kernel's tie
        # key on this path); entry posting indices are ascending in entry
        # order per item, and cross-item entries are masked out per query
        dmerge = dev["post_index"][dev["r2n"][dev["pos"].long()].long()]
        old_post = (plan.trie.g_item_nodes.to(stream.device)
                    if plan is not None
                    else resident(stream, "dt").item_nodes)
        if old_post.shape[0] == 0:
            # delta-only stream: the frozen base has no postings, so
            # every frozen lane is already dead (nothing to gather)
            rpos = torch.full_like(fpos, -1)
        else:
            rebuilt = dev["old2new"][
                old_post[fpos.clamp(min=0).long()].long()
            ]
            rpos = torch.where(
                live, dev["post_index"][rebuilt.long()], -1
            )
        back = dev["post_nodes"]
    else:
        dmerge = dev["pos"]
        rpos = torch.where(
            live, fpos + dev["shift"][fpos.clamp(min=0).long()], -1
        )
        back = dev["r2n"]

    dvals, dpos = _delta_side(stream, match, metric, dmerge, k)
    vals, pos = _merge(fout["values"], rpos, dvals, dpos, int(k))
    return {"values": vals, "node": _back(pos, back), "pos": pos}


# ----------------------------------------------------------------------
# rule search
# ----------------------------------------------------------------------
def _affected_rows(stream, qmat: np.ndarray, ant_len: np.ndarray):
    """Rows whose result can differ from the frozen answer: some prefix
    of the full path, or the consequent path itself, is a modified rule."""
    ov = stream.overlay()
    mod = ov.modified
    aff = np.zeros((qmat.shape[0],), bool)
    for i in range(qmat.shape[0]):
        row = qmat[i]
        items = tuple(int(x) for x in row[row >= 0])
        if not items:
            continue
        al = int(ant_len[i])
        if any(items[:j] in mod for j in range(1, len(items) + 1)):
            aff[i] = True
        elif items[al:] in mod:
            aff[i] = True
    return aff


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def streaming_rule_search_batch(
    stream, queries, ant_len=None, strict: bool = False,
    use_kernel: bool = True, base=None,
) -> Dict[str, torch.Tensor]:
    """rule_search_batch over frozen+delta.

    The frozen kernel answers every row (its descent structure is
    untouched by the overlay); rows touching a modified rule recompute
    from the union host-side, mirroring the fused kernel's scan-order
    f32 arithmetic, with the Eq. 1-4 lift select through the shared
    ``compound_lift``.  Node ids remap old -> rebuilt everywhere.
    """
    fb = _base(stream, base)
    if ops._as_shard_plan(fb) is not None:
        kw = dict(use_kernel=use_kernel)

        def search(*a, **k):
            return _on_stream(stream, ops.rule_search_batch(*a, **k))
    else:
        kw = dict(edges=resident(stream, "edges"), use_kernel=use_kernel)
        search = ops.rule_search_batch
    if stream.is_identity:
        return search(fb, queries, ant_len, strict=strict, **kw)
    fz = stream.frozen
    if ant_len is None and not isinstance(queries, np.ndarray):
        pairs = list(queries)
        ops.validate_rule_pairs(
            pairs, "rule_search_batch", item_rank=fz.item_rank,
            strict=strict,
        )
        if not pairs:
            return search(fb, np.zeros((0, 1), np.int32),
                          np.zeros((0,), np.int32), **kw)
        queries, ant_len = fz.canonicalize_queries(
            [p[0] for p in pairs], [p[1] for p in pairs]
        )
    qmat = _host(queries)
    al = _host(ant_len)
    out = search(fb, qmat, al, **kw)
    dev = _ov_device(stream)
    node = out["node"]
    node = torch.where(
        node >= 0, dev["old2new"][node.clamp(min=0).long()], node
    )

    aff = _affected_rows(stream, qmat, al)
    if not aff.any():
        return {**out, "node": node}

    q = qmat.shape[0]
    c_found = np.zeros((q,), bool)
    c_node = np.full((q,), -1, np.int32)
    c_sup = np.zeros((q,), np.float32)
    c_conf = np.zeros((q,), np.float32)
    c_nlift = np.zeros((q,), np.float32)
    c_consup = np.zeros((q,), np.float32)
    c_single = np.zeros((q,), bool)
    for i in np.nonzero(aff)[0]:
        row = qmat[i]
        items = tuple(int(x) for x in row[row >= 0])
        a = int(al[i])
        full = stream.lookup(items)
        if full is None:
            continue  # absent from the union: all-zero row stands
        # scan-order f32 product over the consequent steps, exactly the
        # kernel's conf accumulation
        conf = np.float32(1.0)
        for j in range(a + 1, len(items) + 1):
            conf = np.float32(conf * np.float32(stream.lookup(items[:j])[1]))
        cons = items[a:]
        cm = stream.lookup(cons) if cons else None
        c_found[i] = True
        c_node[i] = stream.node_of(items)
        c_sup[i] = np.float32(full[0])
        c_conf[i] = conf
        c_nlift[i] = np.float32(full[2])
        c_consup[i] = np.float32(cm[0]) if cm is not None else 0.0
        c_single[i] = (len(items) - a) == 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(stream.device)

    found = t(c_found)
    c_lift = compound_lift(found, t(c_single), t(c_nlift), t(c_conf),
                           t(c_consup))
    aj = t(aff)
    return {
        "found": torch.where(aj, found, out["found"]),
        "node": torch.where(aj, t(c_node), node),
        "support": torch.where(aj, t(c_sup), out["support"]),
        "confidence": torch.where(
            aj, t(c_conf * c_found), out["confidence"]
        ),
        "lift": torch.where(aj, c_lift, out["lift"]),
    }
