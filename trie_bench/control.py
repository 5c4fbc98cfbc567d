"""The control of the comparison: the reference put in the program's place
and computed one precision below the configuration's float32 columns, in
bfloat16.  Its trie carries bfloat16 columns, and it answers the served
queries from them with bfloat16 arithmetic (the rankings sorted by
bfloat16 scores, a rule's Confidence and Lift divided in bfloat16).  The
comparison has to find it not correct; ``readings.py`` runs it at a
cell's own size and ``tests/test_trie_bench_faults.py`` at a small one.
"""
from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from . import check
from .check import COLUMNS
from .loadgen import OPS, Traffic
from .reference import answers as ra
from .reference.mine import RefTrie
from .serve_loop import Answers


def bf16(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64)).to(torch.bfloat16)


def trie(ref: RefTrie) -> Dict[str, np.ndarray]:
    """The reference's trie in the program's form, columns in bfloat16."""
    out = {
        "node_item": np.where(ref.rank >= 0,
                              ref.item_of_rank[np.maximum(ref.rank, 0)], -1),
        "node_parent": ref.parent,
        "node_depth": ref.depth,
    }
    for c in COLUMNS:
        out[c] = bf16(ref.columns[c]).float().numpy()
    return out


def _rule_rows(ref, traffic, qids) -> List[dict]:
    pairs = traffic.rule_pairs(qids)
    want = ra.rule_search(ref, pairs)
    ants = [ra.canonical(ref, a) for a, _ in pairs]
    cons = [ra.canonical(ref, c) for _, c in pairs]
    ant_node = torch.from_numpy(np.maximum(ref.walk(ants), 0))
    con_node = ref.walk(cons)
    sup = bf16(ref.columns["support"])
    node = torch.from_numpy(np.maximum(want["node"], 0))
    s = sup[node]
    has_ant = torch.tensor([len(a) > 0 for a in ants])
    conf = s / torch.where(has_ant, sup[ant_node],
                           torch.ones((), dtype=torch.bfloat16))
    multi = conf / sup[torch.from_numpy(np.maximum(con_node, 0))]
    multi = torch.where(torch.from_numpy(con_node > 0), multi,
                        torch.zeros((), dtype=torch.bfloat16))
    single = torch.tensor([len(c) == 1 for c in cons])
    lift = torch.where(single, bf16(ref.columns["lift"])[node], multi)
    found = want["found"].tolist()
    cols = [x.float().numpy().tolist() for x in (s, conf, lift)]
    rows = []
    for i, f in enumerate(found):
        if not f:
            rows.append({"found": False, "node": -1, "support": 0.0,
                         "confidence": 0.0, "lift": 0.0})
            continue
        rows.append({"found": True, "node": int(node[i]),
                     "support": cols[0][i], "confidence": cols[1][i],
                     "lift": cols[2][i]})
    return rows


def _ranked_rows(score_pos, depth_pos, qid, lo, hi, q, k, min_depth, ref):
    """Top-k by bfloat16 scores over each query's ranges: values and the
    reference's node ids."""
    vals = np.full((q, k), -np.inf, np.float32)
    nodes = np.full((q, k), -1, np.int64)
    lens = np.maximum(hi - lo, 0)
    pos = np.repeat(lo - np.cumsum(lens) + lens, lens) + np.arange(lens.sum())
    owner = np.repeat(qid, lens)
    live = depth_pos[pos] >= min_depth
    pos, owner = pos[live], owner[live]
    s = bf16(score_pos[pos]).float().numpy()
    order = np.lexsort((pos, -s, owner))
    owner, pos, s = owner[order], pos[order], s[order]
    start = np.searchsorted(owner, np.arange(q))
    rank = np.arange(owner.shape[0]) - start[owner]
    take = rank < k
    vals[owner[take], rank[take]] = s[take]
    nodes[owner[take], rank[take]] = ref.dfs_node[pos[take]]
    return [{"values": vals[i], "node": nodes[i]} for i in range(q)]


def answers(ref: RefTrie, traffic: Traffic, loop) -> Answers:
    """Every answer the program's run gave, as the control answers the same
    queries."""
    qids = np.asarray(loop.qids, np.int64)
    out = Answers()
    for o, op in enumerate(OPS):
        sel = np.asarray(loop.answers.ids[o], np.int64)
        if sel.size == 0:
            continue
        uq, inv = np.unique(qids[sel], return_inverse=True)
        if op == "rule_search":
            rows = _rule_rows(ref, traffic, uq)
        else:
            kw = traffic.kwargs[op]
            if op == "top_k":
                lo, hi = ra.prefix_ranges(ref, traffic.prefixes(uq))
                qid = np.arange(uq.shape[0])
            else:
                qid, lo, hi = ra.member_ranges(ref, uq, kw["role"])
            rows = _ranked_rows(ref.score_by_pos(kw["metric"]),
                                ref.depth[ref.dfs_node], qid, lo, hi,
                                uq.shape[0], kw["k"],
                                kw.get("min_depth", 1), ref)
        for i, j in zip(sel.tolist(), inv.tolist()):
            out.add(o, i, rows[j])
    return out


def numbers(ref: RefTrie, traffic: Traffic, loop) -> Dict[str, float]:
    """The control's compared numbers: its trie, and its answers to every
    query the program's run answered, against the reference."""
    out, m = check.trie_numbers(trie(ref), ref)
    ctl = copy.copy(loop)
    ctl.answers = answers(ref, traffic, loop)
    out.update(check.answer_numbers(ctl, traffic, ref, m))
    return out
