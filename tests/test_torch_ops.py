"""Port parity: every op of the batched query path on the CPU (the plain
PyTorch versions) against the reference's jnp oracles, bitwise, tie order
and int32 dtypes included; the trie_reduce sums hold to 1e-6 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import array_trie as JA  # noqa: E402
from repro.core import synthetic as JS  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import rank as JR  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.core import array_trie as TA  # noqa: E402
from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.core.delta_trie import StreamingTrie  # noqa: E402
from repro_torch.distributed.trie_sharding import (  # noqa: E402
    shard_device_trie,
)
from repro_torch.kernels import KERNELS, launch_counts  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import rank as TR  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.launch.mesh import TrieMesh  # noqa: E402

METRICS = TO.RANK_METRICS
ROLES = TO.ROLES


def _port(fz):
    """The port's FrozenTrie over a reference FrozenTrie's fields."""
    return TA.FrozenTrie.from_arrays({
        f.name: np.asarray(getattr(fz, f.name))
        for f in dataclasses.fields(JA.FrozenTrie)
    })


def _eq(got, want, what=""):
    """Bitwise equality of a port dict and a reference dict."""
    assert set(got) == set(want), what
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.dtype == w.dtype, (what, key, g.dtype, w.dtype)
        assert g.shape == w.shape, (what, key)
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")


def _tie_forced(arrs):
    out = dict(arrs)
    for key in ("support", "confidence", "lift"):
        out[key] = np.round(arrs[key], 1).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """(reference FrozenTrie, port FrozenTrie, arrays) over one random
    irregular trie, and the same with tie-forced metric columns."""
    arrs = JS.random_csr_trie(np.random.RandomState(21), 700, 24)
    out = {}
    for tag, a in (("plain", arrs), ("ties", _tie_forced(arrs))):
        jf = JS.frozen_from_arrays(a)
        out[tag] = (jf, _port(jf), a)
    return out


PREFIXES = [[], [0], [3, 1], [1, 3], [99], [-1], [2, 2], [5, 7, 9], [0],
            [4, -3]]
ITEMS = [0, 3, 3, 99, -1, 5, 23, 7, 0, -5]


@pytest.mark.parametrize("tag", ["plain", "ties"])
@pytest.mark.parametrize("metric", METRICS)
def test_top_k_rules_batch(pair, tag, metric):
    jf, tf, _ = pair[tag]
    for k, min_depth in ((5, 1), (2000, 2)):
        want = JO.top_k_rules_batch(jf, PREFIXES, k, metric=metric,
                                    min_depth=min_depth, use_kernel=False)
        got = TO.top_k_rules_batch(tf, PREFIXES, k, metric=metric,
                                   min_depth=min_depth, device="cpu")
        _eq(got, want, f"k={k}")
    mat = np.array([[0, -1], [3, 1], [-1, -1], [99, 2]], np.int32)
    _eq(TO.top_k_rules_batch(tf, mat, 7, metric=metric, device="cpu"),
        JO.top_k_rules_batch(jf, mat, 7, metric=metric, use_kernel=False),
        "matrix")


def test_top_k_rules_single(pair):
    jf, tf, _ = pair["ties"]
    for prefix in (None, [3], [99], []):
        want = JO.top_k_rules(jf, 12, metric="lift", prefix=prefix,
                              use_kernel=False)
        got = TO.top_k_rules(tf, 12, metric="lift", prefix=prefix,
                             device="cpu")
        _eq(got, want, f"prefix={prefix}")
    # the single-range plain version
    d = JO.dfs_rank_arrays(jf)
    t = TO.dfs_rank_arrays(tf, device="cpu")
    cols = ("support", "confidence", "lift", "depth")
    for lo, hi, k in ((0, 700, 9), (40, 90, 80), (5, 5, 3)):
        want = JREF.topk_rank_ref(*[d[c] for c in cols], lo, hi, k=k,
                                  metric="leverage")
        got = TREF.topk_rank_ref(*[t[c] for c in cols], lo, hi, k=k,
                                 metric="leverage")
        _eq(dict(zip("vp", got)), dict(zip("vp", want)), "topk_rank_ref")


@pytest.mark.parametrize("tag", ["plain", "ties"])
@pytest.mark.parametrize("role", ROLES)
def test_rules_with(pair, tag, role):
    jf, tf, _ = pair[tag]
    for metric in METRICS:
        for k in (6, 300):
            want = JO.rules_with(jf, ITEMS, role=role, k=k, metric=metric,
                                 use_kernel=False)
            got = TO.rules_with(tf, ITEMS, role=role, k=k, metric=metric,
                                device="cpu")
            _eq(got, want, f"{metric} k={k}")


def test_rule_search_batch(pair):
    jf, tf, arrs = pair["plain"]
    q, al = JS.mixed_queries(np.random.RandomState(8), arrs, 120, 6)
    q[5] = q[0]
    al[5] = al[0]           # a duplicate row
    jdt = jf.device_arrays()
    oracle = JA.batched_rule_search(jdt, jnp.asarray(q), jnp.asarray(al))
    want = JREF.rule_search_fused_ref(
        *[jnp.asarray(arrs[k]) for k in (
            "edge_parent", "edge_item", "edge_child", "edge_conf",
            "edge_sup", "edge_lift")],
        jnp.asarray(q), jnp.asarray(al))
    got = TO.rule_search_batch(tf, q, al, device="cpu")
    _eq(got, oracle, "vs batched_rule_search")
    _eq(got, want, "vs rule_search_fused_ref")
    pairs = [([int(x) for x in row[:a] if x >= 0][::-1],
              [int(x) for x in row[a:] if x >= 0])
             for row, a in zip(q[:60], al[:60])]
    pairs.append(([], []))
    pairs.append(([1000], [1]))
    want = JA.batched_rule_search(jdt, *map(jnp.asarray, jf.canonicalize_queries(
        [p[0] for p in pairs], [p[1] for p in pairs])))
    _eq(TO.rule_search_batch(tf, pairs, device="cpu"), want, "ragged")


def test_prefix_ranges_and_dedup(pair):
    jf, tf, _ = pair["plain"]
    want = JO.prefix_ranges(jf, PREFIXES)
    got = TO.prefix_ranges(tf, PREFIXES, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng = np.random.RandomState(2)
    for q_rows in (1, 7, 8, 40):
        q = rng.randint(-1, 4, size=(q_rows, 3)).astype(np.int32)
        al = rng.randint(0, 2, size=q_rows).astype(np.int32)
        for g, w in zip(TO.dedup_query_rows(q, al),
                        JO.dedup_query_rows(q, al)):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)


def test_trie_reduce(pair):
    for tag in ("plain", "ties"):
        jf, tf, _ = pair[tag]
        want = JO.trie_reduce(jf)
        got = TO.trie_reduce(tf, device="cpu")
        assert set(got) == set(want)
        for key in ("n_rules", "confidence_max"):
            assert got[key].dtype == torch.float32
            assert float(got[key]) == float(want[key]), key
        for key in ("support_sum", "mean_conf"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-6)


def test_degenerate_inputs(pair, empty_frozen):
    jf, tf, _ = pair["plain"]
    # Q = 0 everywhere
    _eq(TO.rule_search_batch(tf, [], device="cpu"),
        JO.rule_search_batch(jf, []), "Q=0 search")
    _eq(TO.top_k_rules_batch(tf, [], 4, device="cpu"),
        JO.top_k_rules_batch(jf, [], 4, use_kernel=False), "Q=0 top-k")
    for role in ROLES:
        _eq(TO.rules_with(tf, [], role=role, k=3, device="cpu"),
            JO.rules_with(jf, [], role=role, k=3, use_kernel=False),
            "Q=0 rules_with")
    # the empty trie (root only)
    te = _port(empty_frozen)
    _eq(TO.rule_search_batch(te, [([1], [2]), ([], [0])], device="cpu"),
        JO.rule_search_batch(empty_frozen, [([1], [2]), ([], [0])]),
        "empty search")
    _eq(TO.top_k_rules_batch(te, [[], [4]], 3, device="cpu"),
        JO.top_k_rules_batch(empty_frozen, [[], [4]], 3, use_kernel=False),
        "empty top-k")
    for role in ROLES:
        _eq(TO.rules_with(te, [0, 1], role=role, k=2, device="cpu"),
            JO.rules_with(empty_frozen, [0, 1], role=role, k=2,
                          use_kernel=False), "empty rules_with")
    got, want = TO.trie_reduce(te, device="cpu"), JO.trie_reduce(empty_frozen)
    for key in want:
        assert float(got[key]) == float(want[key]) == 0.0, key
    # zero-width search rows
    _eq(TO.rule_search(tf, np.zeros((3, 0), np.int32),
                       np.zeros(3, np.int32), device="cpu"),
        JO.rule_search(jf, np.zeros((3, 0), np.int32),
                       np.zeros(3, np.int32)), "width 0")


def test_validation_errors(pair):
    _, tf, _ = pair["plain"]
    for bad_k in (0, -1, 2.5, True):
        with pytest.raises(TO.InvalidQueryError):
            TO.top_k_rules_batch(tf, [[]], bad_k, device="cpu")
    with pytest.raises(TO.InvalidQueryError):
        TO.top_k_rules_batch(tf, [[]], 3, metric="gini", device="cpu")
    with pytest.raises(TO.InvalidQueryError):
        TO.top_k_rules_batch(tf, [None], 3, device="cpu")
    with pytest.raises(TO.InvalidQueryError):
        TO.rules_with(tf, [1], role="parent", device="cpu")
    with pytest.raises(TO.InvalidQueryError):
        TO.rules_with(tf, [1, None], device="cpu")
    with pytest.raises(TO.InvalidQueryError):
        TO.rules_with(tf, [1, 10_000], strict=True, device="cpu")
    with pytest.raises(TO.InvalidQueryError):
        TO.rule_search_batch(tf, [([1], None)], device="cpu")
    with pytest.raises(TO.InvalidQueryError):
        TO.top_k_rules_batch(tf, [[1, 10_000]], 3, strict=True,
                             device="cpu")
    assert TO.is_retryable(TO.TransientBackendError("x"))
    assert not TO.is_retryable(TO.InvalidQueryError("x"))
    assert TO.is_retryable(RuntimeError("CUDA out of memory"))
    assert not TO.is_retryable(RuntimeError("bug"))


def test_later_slices_raise_not_implemented(pair, frozen):
    _, tf, _ = pair["plain"]
    dt = tf.device_arrays(device="cpu")
    seed_layout = dataclasses.replace(dt, child_offsets=None)
    # the compressed layout (slice 3) and the seed layout (Queue 2 row 7)
    # are ported: their ops answer (tests/test_torch_seed.py holds the
    # seed layout's answers)
    compressed = tf.device_arrays(device="cpu", layout="compressed")
    for trie in (compressed, seed_layout):
        assert TO.rule_search_batch(trie, np.zeros((1, 1), np.int32),
                                    np.zeros(1, np.int32))["found"].shape \
            == (1,)
        assert TO.top_k_rules_batch(trie, [[]], 3)["node"].shape == (1, 3)
        assert TO.rules_with(trie, [1])["node"].shape == (1, 10)
    # streaming tries (slice 4) are ported too: a real StreamingTrie with
    # one rule updated answers as the frozen trie with that rule's metrics
    # patched (tests/test_torch_streaming.py holds the rest), and has no
    # trie_reduce, as the reference has none
    tf = _port(frozen(0.25))     # a stream's base is a canonical trie
    stream = StreamingTrie(tf, device="cpu")
    node = int(np.nonzero(tf.node_depth == 1)[0][0])
    stream.insert([[int(tf.node_item[node])]], [0.75], [0.5], [2.0])
    cols = {f: np.asarray(getattr(tf, f)).copy()
            for f in ("support", "confidence", "lift")}
    for f, v in zip(cols, (0.75, 0.5, 2.0)):
        cols[f][node] = v
    patched = TA.FrozenTrie.from_arrays({
        **{f.name: getattr(tf, f.name) for f in dataclasses.fields(tf)},
        **cols})
    rows = np.asarray([[int(tf.node_item[node]), -1], [0, 1]], np.int32)
    for got, want in (
        (TO.rule_search_batch(stream, rows, np.ones(2, np.int32)),
         TO.rule_search_batch(patched, rows, np.ones(2, np.int32),
                              device="cpu")),
        (TO.top_k_rules_batch(stream, [[]], 3),
         TO.top_k_rules_batch(patched, [[]], 3, device="cpu")),
        (TO.rules_with(stream, [1]),
         TO.rules_with(patched, [1], device="cpu")),
    ):
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          want[key].numpy())
    with pytest.raises(NotImplementedError, match="slice 4"):
        TO.trie_reduce(stream)
    # sharded plans (slice 6) answer the three batched ops as the trie
    # does (tests/test_torch_sharding.py holds the rest); trie_reduce and
    # prefix_ranges refuse one, as the reference has no sharded form
    plan = shard_device_trie(tf, TrieMesh(["cpu"] * 2))
    rows = np.asarray([[0, 1], [1, -1]], np.int32)
    for got, want in (
        (TO.rule_search_batch(plan, rows, np.ones(2, np.int32)),
         TO.rule_search_batch(tf, rows, np.ones(2, np.int32), device="cpu")),
        (TO.top_k_rules_batch(plan, [[]], 3),
         TO.top_k_rules_batch(tf, [[]], 3, device="cpu")),
        (TO.rules_with(plan, [1]), TO.rules_with(tf, [1], device="cpu")),
    ):
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(),
                                          want[key].numpy())
    for fn in (TO.trie_reduce, lambda t: TO.prefix_ranges(t, [[0]])):
        with pytest.raises(NotImplementedError, match="ShardPlan"):
            fn(plan)
    meshed = StreamingTrie(tf, mesh=TrieMesh(["cpu"] * 2), device="cpu")
    assert meshed.shard_plan().ranges == plan.ranges


def test_rank_merge_equal():
    rng = np.random.RandomState(6)
    kpad = 16
    for _ in range(5):
        vals = np.round(rng.rand(2 * kpad), 1).astype(np.float32)
        pos = rng.permutation(100)[: 2 * kpad].astype(np.int32)
        lists = []
        for sl in (slice(0, kpad), slice(kpad, 2 * kpad)):
            v, p = vals[sl], pos[sl]
            order = np.lexsort((p, -v))
            v, p = v[order].copy(), p[order].copy()
            cut = rng.randint(0, kpad + 1)
            v[cut:], p[cut:] = -np.inf, -1
            lists += [v, p]
        want = JR.rank_merge(*map(jnp.asarray, lists), kpad)
        got = TR.rank_merge(*map(torch.from_numpy, lists), kpad)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cpu_runs_plain_versions_without_counting(pair):
    _, tf, _ = pair["plain"]
    before = launch_counts()
    TO.top_k_rules_batch(tf, [[]], 3, device="cpu")
    TO.rules_with(tf, [1], role="any", device="cpu")
    TO.rule_search_batch(tf, [([0], [1])], device="cpu")
    TO.trie_reduce(tf, device="cpu")
    assert launch_counts() == before
    assert set(before) == set(KERNELS)


def test_empty_item_universe_gives_empty_rows():
    """A trie whose item table is empty (root only, no items): the
    reference's ``_posting_slices`` indexes past its one-entry offsets
    table and raises IndexError; the port answers empty rows."""
    port = TS.frozen_from_arrays(TS.synthetic_csr_trie(0))
    assert port.item_offsets.shape == (1,)
    for role in ROLES:
        out = TO.rules_with(port, [0, 1, -1], role=role, k=4, device="cpu")
        assert out["values"].shape == (3, 4)
        assert bool((out["node"] == -1).all())
        assert bool(torch.isinf(out["values"]).all())
    jf = JS.frozen_from_arrays(JS.synthetic_csr_trie(0))
    with pytest.raises(IndexError):
        JO.rules_with(jf, [0], use_kernel=False)
