"""The traffic generator and the database are deterministic for a seed,
and the seed changes which queries and items, never how much work."""
from __future__ import annotations

import json

import numpy as np
import pytest

from trie_bench import data
from trie_bench.loadgen import CUT, OPS, Traffic, item_paths
from trie_bench.reference.mine import mine
from trie_bench.tests.helpers import ROOT, TINY

MIXES = sorted(p.stem for p in (ROOT / "trie_bench" / "traffic").glob(
    "*.json"))


@pytest.fixture(scope="module")
def paths():
    ref = mine(data.make_transactions(TINY, 1), TINY["n_items"],
               TINY["minsup"], TINY["max_len"])
    item = np.where(ref.rank >= 0,
                    ref.item_of_rank[np.maximum(ref.rank, 0)], -1)
    return item_paths(ref.parent, item, ref.depth)


def mix(name, **kw):
    m = json.loads((ROOT / "trie_bench" / "traffic" / f"{name}.json")
                   .read_text())
    m.update(kw)
    return m


def stream(t: Traffic, n: int):
    return [t.next() for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_stream(paths, name):
    a = Traffic(mix(name), paths, 2**31 + 5)
    b = Traffic(mix(name), paths, 2**31 + 5)
    c = Traffic(mix(name), paths, 2**31 + 6)
    sa, sb, sc = stream(a, 5000), stream(b, 5000), stream(c, 5000)
    assert sa == sb
    assert sa != sc
    assert [a.payload(*x) for x in sa[:200]] == \
        [b.payload(*x) for x in sb[:200]]


@pytest.mark.parametrize("name", MIXES)
def test_op_mix_and_payloads(paths, name):
    m = mix(name)
    t = Traffic(m, paths, 9)
    ops = np.array([o for o, _ in stream(t, 20000)])
    for o, op in enumerate(OPS):
        share = float(np.mean(ops == o))
        assert abs(share - m["op_mix"][op]) < 0.02, (op, share)
    for o, q in stream(t, 2000):
        p = t.payload(o, q)
        if o == 0:
            ant, con = p
            path = t.paths[q // CUT]
            assert 1 <= q % CUT <= len(path)
            assert list(ant) + (list(con) if len(ant) < len(path) else []) \
                == list(path)
        elif o == 1:
            depth = m["top_k"]["prefix_depth"]
            assert depth is None or len(p) <= depth
        else:
            assert p in set(paths[paths >= 0].tolist())


def test_hot_pool_is_zipf_and_bounded(paths):
    t = Traffic(mix("hot", pool=64), paths, 4)
    s = stream(t, 20000)
    for o, op in enumerate(OPS):
        qs = [q for oo, q in s if oo == o]
        assert len(set(qs)) <= 64
        # the most asked query takes about its Zipf share
        top = max(np.bincount(np.unique(qs, return_inverse=True)[1]))
        ranks = np.arange(1, t.pool[op].shape[0] + 1, dtype=np.float64)
        p1 = 1.0 / (ranks ** -mix("hot")["zipf_s"]).sum()
        assert abs(top / len(qs) - p1) < 0.05


def test_the_stream_does_not_depend_on_node_numbering(paths):
    """Queries are ordered by path, so renumbering the nodes (as another
    build of the same ruleset may) leaves the stream as it was."""
    rng = np.random.default_rng(0)
    perm = np.concatenate([[0], 1 + rng.permutation(paths.shape[0] - 1)])
    a = Traffic(mix("cold"), paths, 3)
    b = Traffic(mix("cold"), paths[perm], 3)
    assert [a.payload(*x) for x in stream(a, 3000)] == \
        [b.payload(*x) for x in stream(b, 3000)]


def test_database_deterministic_and_same_work_on_every_seed():
    a = data.make_transactions(TINY, 2**32 + 1)
    b = data.make_transactions(TINY, 2**32 + 1)
    c = data.make_transactions(TINY, 2**32 + 2)
    assert a == b
    assert a != c
    ra = mine(a, TINY["n_items"], TINY["minsup"], TINY["max_len"])
    rc = mine(c, TINY["n_items"], TINY["minsup"], TINY["max_len"])
    # relabeled items and shuffled baskets: the same ruleset shape
    assert ra.n_nodes == rc.n_nodes
    assert np.array_equal(np.sort(ra.count), np.sort(rc.count))
    assert np.array_equal(np.bincount(ra.depth), np.bincount(rc.depth))
