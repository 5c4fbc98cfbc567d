"""The plain reference against brute force, and against the port's plain
path (its ops on the CPU) on a tiny generated database."""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from trie_bench import check, data
from trie_bench.loadgen import Traffic, item_paths
from trie_bench.reference import answers as ra
from trie_bench.reference.mine import mine, min_count
from trie_bench.tests.helpers import TINY

SMALL = dict(TINY, n_transactions=300, n_items=24, minsup=0.05,
             n_profiles=4)


@pytest.fixture(scope="module")
def small():
    tx = data.make_transactions(SMALL, 2**31 + 3)
    return tx, mine(tx, SMALL["n_items"], SMALL["minsup"],
                    SMALL["max_len"])


def brute_force(tx, n_items, minsup, max_len):
    mc = min_count(minsup, len(tx))
    sets = [frozenset(t) for t in tx]
    out = {}
    for k in range(1, max_len + 1):
        level = {}
        cands = (itertools.combinations(range(n_items), 1) if k == 1 else
                 {tuple(sorted(set(a) | {j})) for a in out if len(a) == k - 1
                  for j in range(n_items) if j not in a})
        for c in cands:
            n = sum(1 for s in sets if s.issuperset(c))
            if n >= mc:
                level[tuple(sorted(c))] = n
        if not level:
            break
        out.update(level)
    return out


def test_miner_equals_brute_force(small):
    tx, ref = small
    want = brute_force(tx, SMALL["n_items"], SMALL["minsup"],
                       SMALL["max_len"])
    got = {}
    for n in range(1, ref.n_nodes):
        ranks = ref.path[n][ref.path[n] >= 0]
        got[tuple(sorted(ref.item_of_rank[ranks].tolist()))] = \
            int(ref.count[n])
    assert got == want


def test_columns_follow_the_paper(small):
    tx, ref = small
    n = len(tx)
    sup = ref.columns["support"]
    for node in range(1, ref.n_nodes):
        assert sup[node] == ref.count[node] / n
        par = ref.parent[node]
        psup = 1.0 if par == 0 else sup[par]
        assert ref.columns["confidence"][node] == pytest.approx(
            sup[node] / psup, rel=1e-12)
        last = ref.rank[node]
        isup = sup[ref.child(np.array([0]), np.array([last]))[0]]
        assert ref.columns["lift"][node] == pytest.approx(
            ref.columns["confidence"][node] / isup, rel=1e-12)


def test_rankings_against_brute_force(small):
    _, ref = small
    conf = ref.columns["confidence"]
    nodes = np.arange(1, ref.n_nodes)
    # top-k under every first-level prefix
    firsts = [[int(ref.item_of_rank[r])] for r in range(ref.n_frequent)]
    lo, hi = ra.prefix_ranges(ref, firsts)
    got = ra.topk_values(ref.score_by_pos("confidence"),
                         ref.depth[ref.dfs_node],
                         np.arange(len(firsts)), lo, hi, len(firsts), 5, 1)
    for i, (item,) in enumerate(firsts):
        r = ref.rank_of_item[item]
        sub = [n for n in nodes if ref.path[n][0] == r]
        want = sorted(conf[sub], reverse=True)[:5]
        assert np.allclose(got[i][: len(want)], want)
        assert np.all(got[i][len(want):] == -np.inf)
    # rules_with, each role
    lift = ref.columns["lift"]
    items = list(range(SMALL["n_items"]))
    for role in ra.ROLES:
        qid, lo, hi = ra.member_ranges(ref, items, role)
        got = ra.topk_values(ref.score_by_pos("lift"),
                             ref.depth[ref.dfs_node], qid, lo, hi,
                             len(items), 4, 1)
        for item in items:
            r = ref.ranks([item])[0]
            path = ref.path[nodes]
            has = (path == r).any(axis=1)
            last = ref.rank[nodes] == r
            ok = {"any": has, "consequent": last,
                  "antecedent": has & ~last}[role]
            want = sorted(lift[nodes[ok]], reverse=True)[:4]
            assert np.allclose(got[item][: len(want)], want)
            assert np.all(got[item][len(want):] == -np.inf)


@pytest.fixture(scope="module")
def port_and_ref():
    from repro_torch.arm.transactions import TransactionDB
    from repro_torch.core.builder import build_trie_of_rules
    from repro_torch.serve.trie_engine import TrieQueryEngine

    tx = data.make_transactions(TINY, 2**32 + 9)
    built = build_trie_of_rules(
        TransactionDB(tx, n_items=TINY["n_items"]), TINY["minsup"],
        miner="apriori", max_len=TINY["max_len"], engine="arrays",
        device="cpu")
    fz = built.frozen
    ref = mine(tx, TINY["n_items"], TINY["minsup"], TINY["max_len"])
    return fz, TrieQueryEngine(fz, device="cpu", mode="replicated"), ref


def test_port_trie_equals_the_reference(port_and_ref):
    fz, _, ref = port_and_ref
    port = {k: np.asarray(getattr(fz, k)) for k in (
        "node_item", "node_parent", "node_depth", "support", "confidence",
        "lift")}
    nums, m = check.trie_numbers(port, ref)
    assert nums["trie_mismatch"] == 0
    assert nums["column_gap"] < 1e-6
    assert fz.n_nodes == ref.n_nodes


@pytest.mark.parametrize("mix", ["cold", "cold_wide"])
def test_port_answers_equal_the_reference(port_and_ref, mix):
    """The port's three ops on every query a mix can ask, judged by the
    comparison the benchmark uses."""
    from trie_bench.serve_loop import LoopResult
    from trie_bench.tests.test_trie_bench_traffic import mix as load_mix

    fz, eng, ref = port_and_ref
    m = load_mix(mix)
    t = Traffic(m, item_paths(fz.node_parent, fz.node_item, fz.node_depth),
                1)
    port = {k: np.asarray(getattr(fz, k)) for k in (
        "node_item", "node_parent", "node_depth", "support", "confidence",
        "lift")}
    _, node_map = check.trie_numbers(port, ref)
    loop = LoopResult()
    qs = {0: [p * 64 + c for p in range(len(t.paths))
              for c in range(1, int(t.depth[p]) + 1)],
          1: t.universe["top_k"].tolist(),
          2: t.universe["rules_with"].tolist()}
    kw = t.kwargs
    for o, ids in qs.items():
        for lo in range(0, len(ids), 64):
            chunk = ids[lo:lo + 64]
            if o == 0:
                pairs = t.rule_pairs(chunk)
                rows, als = fz.canonicalize_queries([a for a, _ in pairs],
                                                    [c for _, c in pairs])
                out = eng.rule_search_batch(np.asarray(rows), np.asarray(als))
            elif o == 1:
                pre = t.prefixes(chunk)
                w = max(len(p) for p in pre)
                mat = np.full((len(pre), w), -1, np.int32)
                for i, p in enumerate(pre):
                    mat[i, : len(p)] = p
                out = eng.top_k_rules_batch(mat, **kw["top_k"])
            else:
                out = eng.rules_with(chunk, **kw["rules_with"])
            host = {k: v.cpu().numpy() for k, v in out.items()}
            for i, q in enumerate(chunk):
                rid = len(loop.ops)
                loop.ops.append(o)
                loop.qids.append(q)
                loop.answers.add(o, rid, {k: v[i] for k, v in host.items()})
    nums = check.answer_numbers(loop, t, ref, node_map)
    assert nums["answer_wrong"] == 0
    assert nums["unanswered"] == 0
    assert nums["answer_gap"] < 1e-6
