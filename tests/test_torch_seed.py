"""Port parity on the seed layout (a trie without CSR offsets): the
full-sweep search ``rule_search_sweep`` (its plain version on the CPU)
against the reference's ``rule_search_pallas`` in interpret mode and its
jnp oracle, the lex-sorted child lookup, and every query op on a seed
``DeviceTrie`` against the reference's ops on its seed ``DeviceTrie`` and
against the port's CSR answers.  Bitwise throughout, int32 and bool
dtypes included; the trie_reduce sums hold to 1e-6 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import array_trie as JA  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels.ref import rule_search_ref  # noqa: E402
from repro.kernels.rule_search import rule_search_pallas  # noqa: E402
from repro_torch.core import array_trie as TA  # noqa: E402
from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.kernels import KERNELS, launch_counts  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import reset_launch_counts  # noqa: E402
from repro_torch.kernels.ref import rule_search_sweep_ref  # noqa: E402
from repro_torch.kernels.rule_search import rule_search_sweep  # noqa: E402

EDGE_COLS = ("edge_parent", "edge_item", "edge_child", "edge_conf",
             "edge_sup", "edge_lift")
ROLES = TO.ROLES


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _eq(got, want, what=""):
    """Bitwise equality of a port dict and a reference (or port) dict."""
    assert set(got) == set(want), what
    for key in want:
        w = want[key]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        g = got[key].numpy()
        assert g.dtype == w.dtype, (what, key, g.dtype, w.dtype)
        assert g.shape == w.shape, (what, key, g.shape, w.shape)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} {key}")


def _sweep_both(cols, queries, ant_len):
    """The port's sweep on CPU tensors, the reference's interpret-mode
    kernel and its jnp oracle, on the same numpy inputs."""
    got = rule_search_sweep(*[torch.as_tensor(c) for c in cols],
                            torch.as_tensor(queries),
                            torch.as_tensor(ant_len))
    j = [jnp.asarray(c) for c in cols]
    kernel = rule_search_pallas(*j, jnp.asarray(queries),
                                jnp.asarray(ant_len), interpret=True)
    oracle = (rule_search_ref(*j, jnp.asarray(queries), jnp.asarray(ant_len))
              if len(cols[0]) else None)
    return got, kernel, oracle


@pytest.mark.parametrize(
    "n_nodes,n_items,q,width",
    [(5, 4, 3, 2), (50, 12, 40, 5), (200, 30, 129, 7), (512, 64, 256, 4)],
)
def test_sweep_equals_reference(n_nodes, n_items, q, width, random_trie,
                                query_mix):
    rng = np.random.RandomState(n_nodes + q)
    arrs = random_trie(rng, n_nodes, n_items, max_children=4)
    # random rows (mostly absent) and the mix of real paths, junk and
    # padding, in one batch
    rand_q = rng.randint(-1, n_items, size=(q, width)).astype(np.int32)
    rand_al = rng.randint(0, width + 1, size=(q,)).astype(np.int32)
    mix_q, mix_al = query_mix(rng, arrs, q, width)
    queries = np.concatenate([rand_q, mix_q])
    ant_len = np.concatenate([rand_al, mix_al])
    got, kernel, oracle = _sweep_both([arrs[k] for k in EDGE_COLS], queries,
                                      ant_len)
    _eq(got, kernel, "vs rule_search_pallas")
    _eq(got, oracle, "vs rule_search_ref")
    assert got["found"].any()


def test_sweep_repeated_pair():
    """A table that repeats a (parent, item) pair: the child and each
    metric take their own max over the matching edges."""
    ep = np.array([0, 0, 0, 2, 1, 2, 2], np.int32)
    ei = np.array([1, 1, 1, 5, 5, 6, 6], np.int32)
    ec = np.array([1, 2, -3, 3, 4, 5, 6], np.int32)
    cf = np.array([0.5, 0.25, 0.75, 0.5, 0.9, 0.125, 0.0625], np.float32)
    sp = np.array([0.2, 0.1, 0.05, 0.3, 0.4, 0.01, 0.02], np.float32)
    lf = np.array([3.0, 1.0, 2.0, 1.5, 2.5, 4.0, 8.0], np.float32)
    queries = np.array([[1, 5], [1, 6], [1, -1], [5, -1], [1, 5], [-1, -1]],
                       np.int32)
    ant_len = np.array([0, 1, 0, 0, 1, 0], np.int32)
    got, kernel, oracle = _sweep_both((ep, ei, ec, cf, sp, lf), queries,
                                      ant_len)
    _eq(got, kernel, "vs rule_search_pallas")
    _eq(got, oracle, "vs rule_search_ref")
    # [1] -> child max(1, 2, -3) = 2 with conf 0.75, sup 0.2, lift 3.0,
    # then [5] from node 2 -> node 3
    np.testing.assert_array_equal(got["node"].numpy(), [3, 6, 2, -1, 3, -1])
    np.testing.assert_array_equal(
        got["confidence"].numpy(),
        np.array([np.float32(0.75) * np.float32(0.5),
                  np.float32(0.125), 0.75, 0.0, 0.5, 0.0], np.float32))
    np.testing.assert_array_equal(got["support"].numpy(),
                                  np.array([0.3, 0.02, 0.2, 0, 0.3, 0],
                                           np.float32))
    np.testing.assert_array_equal(got["node_lift"].numpy(),
                                  np.array([1.5, 8.0, 3.0, 0, 1.5, 0],
                                           np.float32))


def test_sweep_guards(random_trie):
    rng = np.random.RandomState(5)
    arrs = random_trie(rng, 60, 10, max_children=4)
    cols = [arrs[k] for k in EDGE_COLS]
    empty = [c[:0] for c in cols]
    queries = rng.randint(-1, 10, size=(9, 3)).astype(np.int32)
    ant_len = np.ones((9,), np.int32)
    # E = 0, width 0 and all-padding rows answer all-not-found, as the
    # reference does
    for what, c, q in (("E=0", empty, queries),
                       ("width 0", cols, queries[:, :0]),
                       ("padding", cols, np.full((9, 4), -1, np.int32))):
        got, kernel, oracle = _sweep_both(c, q, ant_len)
        _eq(got, kernel, f"{what} vs rule_search_pallas")
        if what != "E=0":   # the jnp oracle cannot max over no edges
            _eq(got, oracle, f"{what} vs rule_search_ref")
        assert not got["found"].any() and (got["node"] == -1).all()
    # Q = 0 gives empty outputs of the result dtypes
    got = rule_search_sweep(*[torch.as_tensor(c) for c in cols],
                            torch.zeros((0, 3), dtype=torch.int32),
                            torch.zeros((0,), dtype=torch.int32))
    want = {"found": torch.bool, "node": torch.int32,
            "confidence": torch.float32, "support": torch.float32,
            "node_lift": torch.float32}
    assert {k: v.dtype for k, v in got.items()} == want
    assert all(v.shape == (0,) for v in got.values())


def test_sweep_row_chunks(random_trie, query_mix, monkeypatch):
    """The plain version answers the same when its [rows, E] match blocks
    hold a few rows at a time."""
    from repro_torch.kernels import ref

    rng = np.random.RandomState(12)
    arrs = random_trie(rng, 300, 20, max_children=4)
    queries, ant_len = query_mix(rng, arrs, 50, 5)
    args = [torch.as_tensor(arrs[k]) for k in EDGE_COLS]
    args += [torch.as_tensor(queries), torch.as_tensor(ant_len)]
    whole = rule_search_sweep_ref(*args)
    monkeypatch.setattr(ref, "_SWEEP_ELEMS", 3 * len(arrs["edge_parent"]))
    _eq(rule_search_sweep_ref(*args), whole, "3-row chunks")


@pytest.fixture(scope="module")
def seed_pair():
    """One random trie as the reference's and the port's seed-layout
    device tries, the port's CSR ``FrozenTrie``, and its arrays."""
    from repro.core.synthetic import device_trie_from_arrays, random_csr_trie

    arrs = random_csr_trie(np.random.RandomState(41), 800, 24)
    tf = TS.frozen_from_arrays(arrs)
    tdt = tf.device_arrays(device="cpu")
    seed = dataclasses.replace(tdt, child_offsets=None, max_fanout=0)
    return device_trie_from_arrays(arrs, csr=False), seed, tf, tdt, arrs


def test_seed_child_lookup(seed_pair):
    jseed, seed, _, csr, arrs = seed_pair
    rng = np.random.RandomState(3)
    n = arrs["node_item"].shape[0]
    parents = rng.randint(-2, n + 3, size=500).astype(np.int32)
    items = rng.randint(-2, 27, size=500).astype(np.int32)
    # every real edge too
    parents = np.concatenate([parents, arrs["edge_parent"]])
    items = np.concatenate([items, arrs["edge_item"]])
    want = np.asarray(JA.child_lookup(jseed, jnp.asarray(parents),
                                      jnp.asarray(items)))
    got = TA.child_lookup(seed, torch.as_tensor(parents),
                          torch.as_tensor(items))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), TA.child_lookup(csr, torch.as_tensor(parents),
                                     torch.as_tensor(items)).numpy())
    np.testing.assert_array_equal(got.numpy()[500:], arrs["edge_child"])
    # the lower bound itself, at every step count the reference uses
    idx = TA._lex_binary_search(seed.edge_parent, seed.edge_item,
                                torch.as_tensor(parents),
                                torch.as_tensor(items),
                                TA._n_search_steps(len(arrs["edge_item"])))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(
        JA._lex_binary_search(jseed.edge_parent, jseed.edge_item,
                              jnp.asarray(parents), jnp.asarray(items),
                              JA._n_search_steps(len(arrs["edge_item"])))))


def test_seed_batched_rule_search(seed_pair, query_mix):
    jseed, seed, _, csr, arrs = seed_pair
    q, al = query_mix(np.random.RandomState(9), arrs, 150, 6)
    want = JA.batched_rule_search(jseed, jnp.asarray(q), jnp.asarray(al))
    got = TA.batched_rule_search(seed, torch.as_tensor(q),
                                 torch.as_tensor(al))
    _eq(got, want, "vs the reference's seed layout")
    _eq(got, TA.batched_rule_search(csr, torch.as_tensor(q),
                                    torch.as_tensor(al)), "vs CSR")


def test_seed_rule_search(seed_pair, query_mix):
    jseed, seed, tf, csr, arrs = seed_pair
    rng = np.random.RandomState(10)
    q, al = query_mix(rng, arrs, 150, 6)
    q[7], al[7] = q[0], al[0]           # a duplicate row
    want = ref_rows = JO.rule_search(jseed, q, al)
    reset_launch_counts()
    got = TO.rule_search(seed, q, al)
    _eq(got, want, "rule_search vs the reference's seed layout")
    _eq(got, TO.rule_search(csr, q, al), "rule_search vs CSR")
    _eq(TO.rule_search_batch(seed, q, al), want, "rule_search_batch")
    # no kernel launches on CPU tensors
    assert not any(launch_counts().values())
    # ragged pairs, canonicalized by the FrozenTrie, served by the seed
    # layout; the oracle on the reference's seed layout
    pairs = [([int(x) for x in row[:a] if x >= 0][::-1],
              [int(x) for x in row[a:] if x >= 0])
             for row, a in zip(q[:60], al[:60])]
    pairs += [([], []), ([1000], [1])]
    cq, cal = tf.canonicalize_queries([p[0] for p in pairs],
                                      [p[1] for p in pairs])
    want = JA.batched_rule_search(jseed, jnp.asarray(cq), jnp.asarray(cal))
    _eq(TO.rule_search_batch(seed, cq, cal), want, "ragged")
    _eq(TO.rule_search_batch(seed, cq, cal),
        TO.rule_search_batch(tf, pairs, device="cpu"), "ragged vs CSR")
    # the edge dict carries the parents the sweep matches
    edges = TO.edge_metric_arrays(seed)
    assert edges["child_offsets"] is None
    assert torch.equal(edges["edge_parent"], seed.edge_parent)
    _eq(TO.rule_search(seed, q, al, edges=edges), ref_rows, "edges=")
    # Q = 0 and width 0
    _eq(TO.rule_search(seed, np.zeros((0, 3), np.int32),
                       np.zeros(0, np.int32)),
        JO.rule_search(jseed, np.zeros((0, 3), np.int32),
                       np.zeros(0, np.int32)), "Q=0")
    _eq(TO.rule_search(seed, np.zeros((4, 0), np.int32),
                       np.zeros(4, np.int32)),
        JO.rule_search(jseed, np.zeros((4, 0), np.int32),
                       np.zeros(4, np.int32)), "width 0")


def _prefixes(arrs, rng, count):
    """Whole-trie, absent and real 1-3 item prefixes."""
    out = [[], [99], [-1]]
    n = arrs["node_item"].shape[0]
    for i in range(count):
        nid, path = int(rng.randint(1, n)), []
        while nid > 0:
            path.append(int(arrs["node_item"][nid]))
            nid = int(arrs["node_parent"][nid])
        out.append(path[::-1][: 1 + i % 3])
    return out


@pytest.mark.parametrize("metric", TO.RANK_METRICS)
def test_seed_top_k_rules_batch(seed_pair, metric):
    jseed, seed, _, csr, arrs = seed_pair
    prefixes = _prefixes(arrs, np.random.RandomState(4), 12)
    for k, min_depth in ((5, 1), (900, 2)):
        want = JO.top_k_rules_batch(jseed, prefixes, k, metric=metric,
                                    min_depth=min_depth, use_kernel=False)
        got = TO.top_k_rules_batch(seed, prefixes, k, metric=metric,
                                   min_depth=min_depth)
        _eq(got, want, f"k={k} vs the reference's seed layout")
        _eq(got, TO.top_k_rules_batch(csr, prefixes, k, metric=metric,
                                      min_depth=min_depth), f"k={k} vs CSR")
    for g, w in zip(TO.prefix_ranges(seed, prefixes),
                    JO.prefix_ranges(jseed, prefixes)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("role", ROLES)
def test_seed_rules_with(seed_pair, role):
    jseed, seed, _, csr, _ = seed_pair
    items = [0, 3, 3, 99, -1, 5, 23, 7, 0, -5]
    for metric in TO.RANK_METRICS:
        want = JO.rules_with(jseed, items, role=role, k=6, metric=metric,
                             use_kernel=False)
        got = TO.rules_with(seed, items, role=role, k=6, metric=metric)
        _eq(got, want, f"{metric} vs the reference's seed layout")
        _eq(got, TO.rules_with(csr, items, role=role, k=6, metric=metric),
            f"{metric} vs CSR")


def test_seed_trie_reduce(seed_pair):
    jseed, seed, _, csr, _ = seed_pair
    got, want, plain = (TO.trie_reduce(seed), JO.trie_reduce(jseed),
                        TO.trie_reduce(csr))
    assert set(got) == set(want) == set(plain)
    for key in ("n_rules", "confidence_max"):
        assert got[key].dtype == torch.float32
        assert float(got[key]) == float(want[key]) == float(plain[key]), key
    for key in ("support_sum", "mean_conf"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-6)
        assert float(got[key]) == float(plain[key]), key


def test_sweep_is_registered():
    assert KERNELS["rule_search_sweep"] is rule_search_sweep
    assert "rule_search_sweep" in launch_counts()
