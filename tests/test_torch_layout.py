"""Port parity: the frozen layout, the synthetic generators, the host
helpers and the tensor oracles give the reference's integers and floats.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import array_trie as JA  # noqa: E402
from repro.core import synthetic as JS  # noqa: E402
from repro_torch.core import array_trie as TA  # noqa: E402
from repro_torch.core import synthetic as TS  # noqa: E402


def _assert_dicts_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype, key
        np.testing.assert_array_equal(x, y, err_msg=key)


def _jax_fields(fz):
    return {
        f.name: np.asarray(getattr(fz, f.name))
        for f in dataclasses.fields(JA.FrozenTrie)
    }


@pytest.mark.parametrize(
    "n_edges,root_fanout,fanout,seed",
    [(1000, 0, 8, 0), (5000, 0, 3, 3), (20000, 40, 8, 1), (7, 0, 8, 2)],
)
def test_synthetic_csr_trie_equal(n_edges, root_fanout, fanout, seed):
    _assert_dicts_equal(
        JS.synthetic_csr_trie(n_edges, root_fanout, fanout, seed),
        TS.synthetic_csr_trie(n_edges, root_fanout, fanout, seed),
    )


@pytest.mark.parametrize("seed,n_nodes,n_items", [(0, 300, 12), (5, 1500, 40),
                                                  (9, 1, 4)])
def test_random_csr_trie_and_queries_equal(seed, n_nodes, n_items):
    a = JS.random_csr_trie(np.random.RandomState(seed), n_nodes, n_items)
    b = TS.random_csr_trie(np.random.RandomState(seed), n_nodes, n_items)
    _assert_dicts_equal(a, b)
    _assert_dicts_equal(
        dict(zip("qa", JS.mixed_queries(np.random.RandomState(seed), a,
                                        40, 6))),
        dict(zip("qa", TS.mixed_queries(np.random.RandomState(seed), b,
                                        40, 6))),
    )
    if n_nodes > 1:
        _assert_dicts_equal(
            dict(zip("qa", JS.synthetic_search_queries(a, 30, 5, seed))),
            dict(zip("qa", TS.synthetic_search_queries(b, 30, 5, seed))),
        )


def test_layout_helpers_equal_on_random_inputs():
    rng = np.random.RandomState(4)
    arrs = JS.random_csr_trie(rng, 800, 25, max_children=9)
    args = (arrs["node_parent"], arrs["node_depth"], arrs["edge_parent"],
            arrs["edge_child"], arrs["child_offsets"])
    for x, y in zip(JA.dfs_layout(*args), TA.dfs_layout(*args)):
        np.testing.assert_array_equal(x, y)
    for n_items in (25, 40):
        want = JA.item_index_arrays(arrs["node_item"], arrs["dfs_order"],
                                    n_items)
        got = TA.item_index_arrays(arrs["node_item"], arrs["dfs_order"],
                                   n_items)
        for x, y in zip(want, got):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(JA.csr_offsets_from_edges(arrs["edge_parent"], 800),
                    TA.csr_offsets_from_edges(arrs["edge_parent"], 800)):
        np.testing.assert_array_equal(x, y)
    order = rng.permutation(30)
    for x, y in zip(JA.item_tables(order), TA.item_tables(order)):
        np.testing.assert_array_equal(x, y)
    items = [3, -1, 99, 0, 24, -7]
    for x, y in zip(JA.sanitize_query_items(items, 25),
                    TA.sanitize_query_items(items, 25)):
        np.testing.assert_array_equal(x, y)
    empty = np.zeros(0, np.int32)
    assert all(a.size == 0 for a in TA.dfs_layout(
        empty, empty, empty, empty, np.zeros(1, np.int32)))


def test_from_arrays_round_trips_mined_trie(frozen):
    fz = frozen(0.25)
    fields = _jax_fields(fz)
    port = TA.FrozenTrie.from_arrays(fields)
    for name, want in fields.items():
        np.testing.assert_array_equal(np.asarray(getattr(port, name)), want,
                                      err_msg=name)
    # the derived layout (CSR, DFS, item index) is rebuilt identically
    base = {k: fields[k] for k in (
        "node_item", "node_parent", "node_depth", "support", "confidence",
        "lift", "edge_parent", "edge_item", "edge_child", "item_order",
        "item_rank")}
    rebuilt = TA.FrozenTrie.from_arrays(base)
    for name, want in fields.items():
        np.testing.assert_array_equal(np.asarray(getattr(rebuilt, name)),
                                      want, err_msg=name)
    assert (port.n_nodes, port.n_edges, port.max_depth) == \
        (fz.n_nodes, fz.n_edges, fz.max_depth)
    assert port.path_items(fz.n_nodes - 1) == fz.path_items(fz.n_nodes - 1)


def test_canonicalization_equal(frozen):
    fz = frozen(0.25)
    port = TA.FrozenTrie.from_arrays(_jax_fields(fz))
    rng = np.random.RandomState(7)
    n = int(fz.item_rank.shape[0])
    ants = [list(rng.randint(-2, n + 3, size=rng.randint(0, 4)))
            for _ in range(25)]
    cons = [list(rng.randint(0, n + 3, size=rng.randint(1, 3)))
            for _ in range(25)]
    for x, y in zip(fz.canonicalize_queries(ants, cons),
                    port.canonicalize_queries(ants, cons)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(fz.canonicalize_queries(ants, cons, max_len=8),
                    port.canonicalize_queries(ants, cons, max_len=8)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        port.canonicalize_queries([[1, 2, 3]], [[4]], max_len=2)
    mat = np.array([[3, -1, 1], [-1, -1, -1]], np.int32)
    ragged = [[3, -1, 1], [], [n + 4, 0]]
    for prefixes in (mat, ragged):
        assert JA.canonical_prefix_rows(prefixes, fz.item_rank) == \
            TA.canonical_prefix_rows(prefixes, fz.item_rank)
        assert JA.canonical_prefix_rows(prefixes) == \
            TA.canonical_prefix_rows(prefixes)


def test_device_arrays_and_nbytes():
    arrs = TS.synthetic_csr_trie(300, seed=1)
    dt = TS.frozen_from_arrays(arrs).device_arrays(device="cpu")
    jdt = JS.device_trie_from_arrays(JS.synthetic_csr_trie(300, seed=1))
    for f in dataclasses.fields(TA.DeviceTrie):
        v = getattr(dt, f.name)
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(getattr(jdt, f.name)), err_msg=f.name)
    assert dt.device == torch.device("cpu")
    assert (dt.max_fanout, dt.max_postings) == \
        (jdt.max_fanout, jdt.max_postings)
    assert dt.nbytes() > 0


def test_cuda_entry_point_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the GPU-less path is not reachable")
    fz = TS.frozen_from_arrays(TS.synthetic_csr_trie(50))
    with pytest.raises(RuntimeError, match="CUDA"):
        fz.device_arrays()
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.resolve_device("cuda")
    from repro_torch.kernels import ops
    from repro_torch.serve import TrieQueryEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        ops.trie_reduce(fz)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrieQueryEngine(fz)


# ----------------------------------------------------------------------
# tensor oracles
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tries():
    a = JS.random_csr_trie(np.random.RandomState(11), 600, 20)
    b = TS.random_csr_trie(np.random.RandomState(11), 600, 20)
    return a, JS.device_trie_from_arrays(a), \
        TS.frozen_from_arrays(b).device_arrays(device="cpu")


def test_child_lookup_equal(tries):
    arrs, jdt, tdt = tries
    rng = np.random.RandomState(3)
    parents = rng.randint(-2, 602, size=500).astype(np.int32)
    items = rng.randint(-2, 22, size=500).astype(np.int32)
    want = JA.child_lookup(jdt, jnp.asarray(parents), jnp.asarray(items))
    got = TA.child_lookup(tdt, torch.from_numpy(parents),
                          torch.from_numpy(items))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = JA.bucket_edge_lookup(jdt.child_offsets, jdt.edge_item,
                                 jdt.max_fanout, jnp.asarray(parents),
                                 jnp.asarray(items))
    got = TA.bucket_edge_lookup(tdt.child_offsets, tdt.edge_item,
                                tdt.max_fanout, torch.from_numpy(parents),
                                torch.from_numpy(items))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_rule_search_equal(tries):
    arrs, jdt, tdt = tries
    q, al = JS.mixed_queries(np.random.RandomState(5), arrs, 90, 6)
    want = JA.batched_rule_search(jdt, jnp.asarray(q), jnp.asarray(al))
    got = TA.batched_rule_search(tdt, torch.from_numpy(q),
                                 torch.from_numpy(al))
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert got["node"].dtype == torch.int32


def test_top_n_and_traverse_equal(tries):
    arrs, jdt, tdt = tries
    metric = np.round(arrs["confidence"], 1)   # tie-heavy
    for min_depth in (1, 2):
        wv, wi = JA.top_n_nodes(jdt, jnp.asarray(metric), 50, min_depth)
        gv, gi = TA.top_n_nodes(tdt, torch.from_numpy(metric), 50, min_depth)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    want = JA.traverse_reduce(jdt)
    got = TA.traverse_reduce(tdt)
    assert int(got["n_rules"]) == int(want["n_rules"])
    assert float(got["confidence_max"]) == float(want["confidence_max"])
    for key in ("support_sum", "mean_conf"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-6)
