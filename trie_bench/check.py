"""The comparison that decides ``correct``: the program's trie and every
answer its serve loop returned, against the plain reference.

Five numbers, each with its limit (``LIMITS``; ``PERF.md`` gives the
readings each limit was set from):

* ``trie_mismatch``: rule paths the program's trie has and the reference's
  has not, or lacks, or holds twice.  Exact: 0.
* ``column_gap``: the widest relative gap of the program's Support,
  Confidence and Lift columns (float32) from the reference's (float64).
* ``answer_wrong``: answers that say the wrong thing whatever the
  rounding: a rule found or not found against the reference, another node,
  a ranked node outside the query's candidates or ranked twice, a filled
  slot where the reference has none or the reverse.  Exact: 0.
* ``answer_gap``: the widest relative gap of an answer's values from the
  reference's: a found rule's Support, Confidence and Lift; a ranking's
  values against the reference's k best (sorted), and each ranked node's
  value against that node's reference score.  Ties may fall in either
  order: a ranking is judged by its values and its nodes' membership, so
  any order of equal scores passes.
* ``unanswered``: requests sent that never came back ``ok``.  Exact: 0.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .loadgen import OPS, Traffic
from .reference import answers as ra
from .reference.mine import RefTrie

# Each limit lies between the largest reading of sound runs of the program
# and the smallest reading of the bfloat16 control (PERF.md, section 2).
LIMITS = {
    "trie_mismatch": 0,
    "column_gap": 1e-4,
    "answer_wrong": 0,
    "answer_gap": 1e-4,
    "unanswered": 0,
}

COLUMNS = ("support", "confidence", "lift")


def _rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def _max(x) -> float:
    x = np.asarray(x, np.float64)
    if x.size == 0:
        return 0.0
    if np.isnan(x).any():
        return float("inf")
    return float(x.max())


def map_nodes(port: Dict[str, np.ndarray], ref: RefTrie
              ) -> Tuple[np.ndarray, int]:
    """Each program node's reference node (-1 where there is none), and the
    count of paths that differ: extra, missing or duplicated."""
    item = np.asarray(port["node_item"], np.int64)
    parent = np.asarray(port["node_parent"], np.int64)
    depth = np.asarray(port["node_depth"], np.int64)
    n = item.shape[0]
    m = np.full(n, -1, np.int64)
    bad = 0
    if n and parent[0] == -1 and depth[0] == 0:
        m[0] = 0
    else:
        bad += 1
    for d in range(1, int(depth.max(initial=0)) + 1):
        ids = np.nonzero(depth == d)[0]
        par = parent[ids]
        ok = (par >= 0) & (par < n)
        pm = np.where(ok, m[np.clip(par, 0, max(n - 1, 0))], -1)
        m[ids] = ref.child(pm, ref.ranks(item[ids]))
    m[depth < 0] = -1
    mapped = m[1:][m[1:] > 0]
    distinct = np.unique(mapped).shape[0]
    extra = int(np.count_nonzero(m[1:] <= 0))
    dup = int(mapped.shape[0] - distinct)
    missing = int(ref.n_nodes - 1 - distinct)
    return m, bad + extra + dup + missing


def trie_numbers(port: Dict[str, np.ndarray], ref: RefTrie
                 ) -> Tuple[Dict[str, float], np.ndarray]:
    m, mismatch = map_nodes(port, ref)
    live = np.nonzero(m > 0)[0]
    gap = 0.0
    for col in COLUMNS:
        gap = max(gap, _max(_rel(np.asarray(port[col])[live],
                                 ref.columns[col][m[live]])))
    return {"trie_mismatch": mismatch, "column_gap": gap}, m


def _unique(ids: List[int], marks: List[object], qids: np.ndarray):
    """Positions of each distinct (answer, query) pair: a cache hit hands
    every asker the same objects, and each must be the answer to its own
    query.  ``marks`` holds one result field per answer that is a distinct
    object for each computed answer."""
    seen = set()
    keep: List[int] = []
    for i, (rid, mark) in enumerate(zip(ids, marks)):
        key = (id(mark), int(qids[rid]))
        if key not in seen:
            seen.add(key)
            keep.append(i)
    return np.asarray(keep, np.int64)


def _rule_search(ref, traffic, qids, f, m):
    uq, inv = np.unique(qids, return_inverse=True)
    want = ra.rule_search(ref, traffic.rule_pairs(uq))
    want = {k: v[inv] for k, v in want.items()}
    found = np.asarray(f["found"], bool)
    node = np.asarray(f["node"], np.int64)
    vals = {c: np.asarray(f[c], np.float64) for c in COLUMNS}
    mapped = np.where((node >= 0) & (node < m.shape[0]),
                      m[np.clip(node, 0, m.shape[0] - 1)], -2)
    zeros = np.ones(found.shape[0], bool)
    for c in COLUMNS:
        zeros &= vals[c] == 0
    wrong = (found != want["found"]) | (found & (mapped != want["node"])) | \
        (~found & ((node != -1) | ~zeros))
    both = found & want["found"]
    gap = 0.0
    for c in COLUMNS:
        gap = max(gap, _max(_rel(vals[c][both], want[c][both])))
    return int(wrong.sum()), gap


def _ranked(ref, score, vals, node, m, want, member):
    """Judge ``[R, k]`` rankings against the reference's k best values
    ``want`` and the membership predicate ``member(ref_nodes)``."""
    vals = np.asarray(vals, np.float64)
    node = np.asarray(node, np.int64)
    filled = vals > -np.inf
    wrong = np.isnan(vals).any(axis=1)
    wrong |= (filled != (want > -np.inf)).any(axis=1)
    wrong |= (~filled & (node != -1)).any(axis=1)
    inside = (node >= 0) & (node < m.shape[0])
    mapped = np.where(inside, m[np.clip(node, 0, m.shape[0] - 1)], -1)
    wrong |= (filled & (mapped <= 0)).any(axis=1)
    ok_nodes = np.maximum(mapped, 0)
    wrong |= (filled & ~member(ok_nodes)).any(axis=1)
    # a node ranked twice in one answer
    keyed = np.where(filled, mapped, -1 - np.arange(node.shape[1]))
    srt = np.sort(keyed, axis=1)
    wrong |= (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    gap = max(_max(_rel(vals[filled], want[filled])),
              _max(_rel(vals[filled], score[ok_nodes][filled])))
    return int(wrong.sum()), gap


def _top_k(ref, traffic, qids, f, m):
    kw = traffic.kwargs["top_k"]
    k, metric, min_depth = kw["k"], kw["metric"], kw.get("min_depth", 1)
    uq, inv = np.unique(qids, return_inverse=True)
    lo, hi = ra.prefix_ranges(ref, traffic.prefixes(uq))
    want = ra.topk_values(ref.score_by_pos(metric), ref.depth[ref.dfs_node],
                          np.arange(uq.shape[0]), lo, hi, uq.shape[0], k,
                          min_depth)[inv]
    qlo, qhi = lo[inv][:, None], hi[inv][:, None]

    def member(n):
        p = ref.pos[n]
        return (p >= qlo) & (p < qhi) & (ref.depth[n] >= min_depth)

    return _ranked(ref, ref.columns[metric], np.stack(f["values"]),
                   np.stack(f["node"]), m, want, member)


def _rules_with(ref, traffic, qids, f, m):
    kw = traffic.kwargs["rules_with"]
    k, metric, role = kw["k"], kw["metric"], kw["role"]
    min_depth = kw.get("min_depth", 1)
    uq, inv = np.unique(qids, return_inverse=True)
    qid, lo, hi = ra.member_ranges(ref, uq, role)
    want = ra.topk_values(ref.score_by_pos(metric), ref.depth[ref.dfs_node],
                          qid, lo, hi, uq.shape[0], k, min_depth)[inv]
    r = ref.ranks(uq)[inv][:, None, None]

    def member(n):
        path = ref.path[n]                       # [R, k, D]
        has = (path == r).any(axis=2)
        last = ref.rank[n] == r[:, :, 0]
        ok = {"any": has, "consequent": last,
              "antecedent": has & ~last}[role]
        return ok & (ref.depth[n] >= min_depth)

    return _ranked(ref, ref.columns[metric], np.stack(f["values"]),
                   np.stack(f["node"]), m, want, member)


def answer_numbers(loop, traffic: Traffic, ref: RefTrie, m: np.ndarray
                   ) -> Dict[str, float]:
    qids = np.asarray(loop.qids, np.int64)
    wrong, gap = 0, 0.0
    judges = (_rule_search, _top_k, _rules_with)
    for o in range(len(OPS)):
        ids = loop.answers.ids[o]
        if not ids:
            continue
        fields = loop.answers.fields[o]
        # the last field is a distinct object for each computed answer
        keep = _unique(ids, fields[list(fields)[-1]], qids)
        f = {name: [values[i] for i in keep]
             for name, values in fields.items()}
        ids_k = np.asarray(ids, np.int64)[keep]
        w, g = judges[o](ref, traffic, qids[ids_k], f, m)
        wrong += w
        gap = max(gap, g)
    return {
        "answer_wrong": wrong,
        "answer_gap": gap,
        "unanswered": int(len(loop.ops) - len(loop.answers)),
    }


def judge(numbers: Dict[str, float], limits=None):
    """``(correct, lines)``: each number beside its limit."""
    limits = LIMITS if limits is None else limits
    ok = True
    lines = []
    for name, lim in limits.items():
        v = numbers[name]
        passed = v <= lim
        ok &= bool(passed)
        lines.append(f"check {name} {v!r} limit {lim!r} "
                     f"{'ok' if passed else 'FAILED'}")
    return ok, lines


def checks_json(numbers: Dict[str, float], limits=None) -> dict:
    limits = LIMITS if limits is None else limits
    return {name: {"value": numbers[name], "limit": lim}
            for name, lim in limits.items()}
