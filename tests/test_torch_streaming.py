"""Port parity for the streaming slice: ``StreamingTrie`` and its overlay,
the frozen+delta merges of ``kernels.streaming`` behind the five search
and ranking ops, the engine's stream routing and ``reconstruct_paths``.

The split is the reference's own (``tests/test_streaming.py``): a random
12-item, 40-transaction DB, 60 sampled rule sequences, the base built
from the first half and the novel paths of the whole.  Both packages
build both tries; every comparison runs the same inserts through the
port (on the CPU, where every kernel runs its plain version) and through
the JAX reference (its Pallas kernels in interpret mode).

Tolerance: bitwise everywhere (values as f32 bits, node ids, positions,
tie order and dtypes), NaN and signed zeros included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arm.rulegen import sample_rule_sequences  # noqa: E402
from repro.arm.transactions import TransactionDB as JDB  # noqa: E402
from repro.core import array_trie as JA  # noqa: E402
from repro.core.build_arrays import build_frozen_trie as j_build  # noqa: E402
from repro.core.delta_trie import StreamingTrie as JStream  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.serve.trie_engine import TrieQueryEngine as JEngine  # noqa: E402
from repro_torch.arm.rulegen import (  # noqa: E402
    sample_rule_sequences as t_sample,
)
from repro_torch.arm.transactions import TransactionDB as TDB  # noqa: E402
from repro_torch.core import array_trie as TA  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DeltaOverlay, StreamingTrie, reconstruct_paths,
)
from repro_torch.core.build_arrays import (  # noqa: E402
    build_frozen_trie as t_build,
)
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import streaming as TSTR  # noqa: E402
from repro_torch.launch.mesh import TrieMesh  # noqa: E402
from repro_torch.serve import TrieQueryEngine  # noqa: E402

METRICS = ("support", "confidence", "lift", "leverage", "conviction")
ROLES = ("any", "antecedent", "consequent")
OVERLAY_FIELDS = ("pos", "node", "shift", "old2new", "r2n", "post_index",
                  "post_nodes", "masked_nodes", "is_novel")
FROZEN_FIELDS = tuple(f.name for f in dataclasses.fields(JA.FrozenTrie))


def _txs(seed, n_items=12, n_tx=40, max_size=6):
    rng = np.random.RandomState(seed)
    return [set(rng.randint(0, n_items, size=rng.randint(1, max_size + 1)))
            for _ in range(n_tx)]


def all_paths(fz):
    """path -> (support, confidence, lift) for every rule node."""
    return {
        tuple(int(x) for x in fz.path_items(n)): (
            float(fz.support[n]), float(fz.confidence[n]),
            float(fz.lift[n]),
        )
        for n in range(1, fz.n_nodes)
    }


def _bits(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _eq(got, want, what=""):
    """Bitwise equality of a port dict and a reference (or port) dict."""
    assert set(got) == set(want), what
    for key in want:
        g, w = _bits(got[key]), _bits(want[key])
        assert g.dtype == w.dtype, (what, key, g.dtype, w.dtype)
        assert g.shape == w.shape, (what, key, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")


def _frozen_eq(got, want):
    for name in FROZEN_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if name in ("max_fanout", "max_postings"):
            assert int(g) == int(w), name
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


@pytest.fixture(scope="module")
def split():
    """Both packages' (full, base) tries over one DB and the novel paths:
    full = base + novel."""
    txs = _txs(3)
    jdb, tdb = JDB(txs, n_items=12), TDB(txs, n_items=12)
    seqs = sample_rule_sequences(jdb, 60, seed=1)
    assert t_sample(tdb, 60, seed=1) == seqs
    half = seqs[: len(seqs) // 2]
    tries = {}
    for tag, sq in (("full", seqs), ("base", half), ("empty", [])):
        jf, _, _ = j_build(jdb, sq)
        tf, _, _ = t_build(tdb, sq, use_kernel=False)
        tries[tag] = (jf, tf)
    fp, bp = all_paths(tries["full"][1]), all_paths(tries["base"][1])
    novel = {p: m for p, m in fp.items() if p not in bp}
    assert novel, "fixture needs novel paths"
    return tries, novel


def _insert(st, paths, metrics):
    st.insert(paths, [m[0] for m in metrics], [m[1] for m in metrics],
              [m[2] for m in metrics])


def _updates(base_paths):
    """Every fourth base path with fresh metrics, and one of them twice
    (a re-insert updates in place, later rows win)."""
    paths = sorted(base_paths)[::4]
    rng = np.random.RandomState(4)
    mets = [tuple(float(x) for x in rng.rand(3).astype(np.float32))
            for _ in paths]
    return paths + paths[:1], mets + [(0.125, 0.5, 2.0)]


def _streams(split, scenario):
    """(reference stream, port stream, port oracle FrozenTrie): the same
    inserts into both packages' streams, and the from-scratch build of
    their union."""
    tries, novel = split
    base = "empty" if scenario == "delta_only" else "base"
    js, ts = JStream(tries[base][0]), StreamingTrie(tries[base][1],
                                                    device="cpu")
    full = tries["full"][1]
    todo = dict(novel)
    if scenario == "delta_only":
        todo = all_paths(full)
    paths = sorted(todo, key=len)
    for st in (js, ts):
        _insert(st, paths, [todo[p] for p in paths])
    oracle = full
    if scenario == "updates":
        up, mets = _updates(all_paths(tries["base"][1]))
        for st in (js, ts):
            _insert(st, up, mets)
        oracle = _patched(full, dict(zip(up, mets)))
    return js, ts, oracle


def _patched(fz, new):
    """``fz`` with the metric columns of the nodes spelling ``new``'s
    paths replaced (a re-inserted path takes its last metrics)."""
    cols = {f: np.asarray(getattr(fz, f)).copy()
            for f in ("support", "confidence", "lift")}
    for path, mets in new.items():
        node = next(n for n in range(1, fz.n_nodes)
                    if tuple(fz.path_items(n)) == path)
        for f, v in zip(("support", "confidence", "lift"), mets):
            cols[f][node] = np.float32(v)
    return TA.FrozenTrie.from_arrays({
        **{f.name: getattr(fz, f.name) for f in dataclasses.fields(fz)},
        **cols,
    })


def query_fixture(fz):
    prefixes = [[], [0], [1, 2], [3], [0, 1], [99], [5, 1], [-1]]
    items = [0, 1, 2, 3, 4, 0, 11, -3]
    rng = np.random.RandomState(0)
    pairs = []
    for p in all_paths(fz):
        if len(p) >= 2:
            a = rng.randint(1, len(p))
            pairs.append((p[:a], p[a:]))
    pairs = pairs[:40] + [((0,), (99,)), ((1, 2), (3, 4)), ((), (0,))]
    return prefixes, items, pairs


def _rebuilt_ops(ts, oracle, prefixes, items, pairs, k=6, metric="lift",
                 min_depth=1):
    """The port's stream against the port's ops on the from-scratch
    rebuild, bitwise."""
    kw = dict(metric=metric, min_depth=min_depth, device="cpu")
    _eq(TO.top_k_rules_batch(ts, prefixes, k, metric=metric,
                             min_depth=min_depth),
        TO.top_k_rules_batch(oracle, prefixes, k, **kw), "rebuild topk")
    for role in ROLES:
        _eq(TO.rules_with(ts, items, role=role, k=k, metric=metric,
                          min_depth=min_depth),
            TO.rules_with(oracle, items, role=role, k=k, **kw),
            f"rebuild rules_with {role}")
    _eq(TO.rule_search_batch(ts, pairs),
        TO.rule_search_batch(oracle, pairs, device="cpu"),
        "rebuild rule_search")


# ----------------------------------------------------------------------
# construction and the overlay
# ----------------------------------------------------------------------
def test_build_matches_reference(split):
    tries, _ = split
    for jf, tf in tries.values():
        _frozen_eq(tf, jf)


@pytest.mark.parametrize("scenario", ["novel", "updates", "delta_only"])
@pytest.mark.parametrize("field", OVERLAY_FIELDS + ("rest",))
def test_overlay_field_matches_reference(split, scenario, field):
    js, ts, _ = _streams(split, scenario)
    jo, to = js.overlay(), ts.overlay()
    assert isinstance(to, DeltaOverlay)
    names = [field] if field != "rest" else [
        f.name for f in dataclasses.fields(jo)
        if f.name not in OVERLAY_FIELDS + ("cache",)
    ]
    for name in names:
        g, w = getattr(to, name), getattr(jo, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)
        else:
            assert g == w, name


# ----------------------------------------------------------------------
# every op against the reference's stream and the port's rebuild
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def updated(split):
    return _streams(split, "updates")


@pytest.mark.parametrize("metric", METRICS)
def test_ranked_ops_match_reference(split, updated, metric):
    js, ts, oracle = updated
    prefixes, items, _ = query_fixture(split[0]["full"][1])
    for k in (1, 6, 200):
        for md in (0, 1):
            what = f"{metric} k={k} min_depth={md}"
            kw = dict(metric=metric, min_depth=md)
            _eq(TO.top_k_rules_batch(ts, prefixes, k, **kw),
                JO.top_k_rules_batch(js, prefixes, k, **kw), f"topk {what}")
            for role in ROLES:
                _eq(TO.rules_with(ts, items, role=role, k=k, **kw),
                    JO.rules_with(js, items, role=role, k=k, **kw),
                    f"rules_with {role} {what}")
            _rebuilt_ops(ts, oracle, prefixes, items, [], k=k,
                         metric=metric, min_depth=md)


def test_search_and_single_ops_match_reference(split, updated):
    js, ts, oracle = updated
    prefixes, items, pairs = query_fixture(split[0]["full"][1])
    _eq(TO.rule_search_batch(ts, pairs), JO.rule_search_batch(js, pairs),
        "rule_search pairs")
    q, al = ts.frozen.canonicalize_queries([p[0] for p in pairs],
                                           [p[1] for p in pairs])
    _eq(TO.rule_search_batch(ts, q, al), JO.rule_search_batch(js, q, al),
        "rule_search matrix")
    _eq(TO.rule_search(ts, q, al), JO.rule_search(js, q, al),
        "rule_search")
    _eq(TO.rule_search_batch(ts, [], None), JO.rule_search_batch(js, []),
        "rule_search empty")
    for prefix in (None, [0], [1, 2], [99]):
        _eq(TO.top_k_rules(ts, 5, metric="support", prefix=prefix),
            JO.top_k_rules(js, 5, metric="support", prefix=prefix),
            f"top_k_rules {prefix}")
    _rebuilt_ops(ts, oracle, prefixes, items, pairs)
    # the frozen side's plain versions answer the same
    _eq(TO.top_k_rules_batch(ts, prefixes, 6, use_kernel=False),
        TO.top_k_rules_batch(ts, prefixes, 6), "use_kernel=False")
    _eq(TO.rule_search_batch(ts, pairs, use_kernel=False),
        TO.rule_search_batch(ts, pairs), "use_kernel=False search")


@pytest.mark.parametrize("fold", ["staggered", "full"])
def test_refrozen_trie_matches_reference(split, fold):
    js, ts, oracle = _streams(split, "updates")
    prefixes, items, pairs = query_fixture(split[0]["full"][1])
    if fold == "staggered":
        for st in (js, ts):
            st.refreeze_max_delta = 1
        folded = [js.maybe_refreeze(), ts.maybe_refreeze()]
        assert folded[0] == folded[1] is not None
        assert js.n_delta == ts.n_delta > 0
        _eq(TO.top_k_rules_batch(ts, prefixes, 6, metric="lift"),
            JO.top_k_rules_batch(js, prefixes, 6, metric="lift"),
            "after one fold")
        _rebuilt_ops(ts, oracle, prefixes, items, pairs)
    assert js.refreeze() == ts.refreeze() > 0
    assert ts.n_delta == 0 and ts.epoch == js.epoch
    _frozen_eq(ts.frozen, js.frozen)
    _frozen_eq(ts.frozen, oracle)
    _rebuilt_ops(ts, oracle, prefixes, items, pairs)


# ----------------------------------------------------------------------
# the reference's edge cases (non-sharded, scheduler-free)
# ----------------------------------------------------------------------
def _case_empty_delta(split):
    tries, _ = split
    base = tries["base"][1]
    st = StreamingTrie(base, device="cpu")
    assert st.is_identity and st.n_delta == 0 and st.epoch == 0
    prefixes, items, pairs = query_fixture(base)
    _rebuilt_ops(st, base, prefixes, items, pairs)
    assert st.refreeze() == 0
    assert st.frozen is base


def _case_delta_only(split):
    _, ts, oracle = _streams(split, "delta_only")
    assert ts.frozen.n_nodes == 1
    prefixes, items, pairs = query_fixture(oracle)
    _rebuilt_ops(ts, oracle, prefixes, items, pairs)
    ts.refreeze()
    _frozen_eq(ts.frozen, oracle)


def _case_reinsert(split):
    tries, _ = split
    base = tries["base"][1]
    bp = all_paths(base)
    path = sorted(bp)[len(bp) // 2]
    st = StreamingTrie(base, device="cpu")
    st.insert([path], [0.9], [0.8], [0.7])
    assert st.n_delta == 1
    st.insert([path], [0.5], [0.25], [2.0])
    assert st.n_delta == 1, "re-insert must update, never append"
    assert st.lookup(path) == (0.5, 0.25, 2.0)
    ref = _patched(base, {path: (0.5, 0.25, 2.0)})
    prefixes, items, pairs = query_fixture(base)
    _rebuilt_ops(st, ref, prefixes, items, pairs)
    st.refreeze()
    assert st.frozen.n_nodes == base.n_nodes
    _frozen_eq(st.frozen, ref)


def _case_racing_refreeze(split):
    """Inserts interleaved with threshold-triggered staggered folds answer
    as a pure-delta twin at every step, and the final drain equals the
    from-scratch rebuild."""
    tries, novel = split
    base, full = tries["base"][1], tries["full"][1]
    racer = StreamingTrie(base, refreeze_max_delta=4, refreeze_max_age=2,
                          device="cpu")
    pure = StreamingTrie(base, device="cpu")
    prefixes, items, pairs = query_fixture(full)
    paths = sorted(novel, key=len)
    folds = 0
    for i in range(0, len(paths), 5):
        chunk = paths[i: i + 5]
        for st in (racer, pure):
            _insert(st, chunk, [novel[p] for p in chunk])
        folds += racer.maybe_refreeze() is not None
        _eq(TO.top_k_rules_batch(racer, prefixes, 6, metric="lift"),
            TO.top_k_rules_batch(pure, prefixes, 6, metric="lift"),
            f"race {i}")
    assert folds >= 1, "thresholds must trigger staggered folds"
    _rebuilt_ops(racer, full, prefixes, items, pairs)
    while racer.n_delta:
        racer.refreeze()
    _frozen_eq(racer.frozen, full)


def _case_refreeze_rebuild(split):
    _, ts, oracle = _streams(split, "novel")
    e0 = ts.epoch
    ts.refreeze()
    assert ts.epoch > e0 and ts.n_delta == 0
    _frozen_eq(ts.frozen, oracle)


def _case_insert_validation(split):
    """Same exception types and messages as the reference."""
    tries, _ = split
    bad = [([[]], "empty"), ([[99]], "not in"),
           ([[0, 1, 2, 3, 4, 5, 6, 7]], "prefix-closed"),
           ([[0], [1]], "metric columns")]
    for seqs, match in bad:
        errs = []
        for st in (JStream(tries["base"][0]),
                   StreamingTrie(tries["base"][1], device="cpu")):
            with pytest.raises(ValueError, match=match) as info:
                st.insert(seqs, [0.1], [0.1], [0.1])
            errs.append(str(info.value))
            assert st.n_delta == 0 and st.epoch == 0
        assert errs[0] == errs[1]


def _case_no_stale_cache(split):
    """An engine over a stream never answers a post-insert query from
    pre-insert state: the per-epoch overlay caches die with the epoch."""
    tries, novel = split
    base, full = tries["base"][1], tries["full"][1]
    eng = TrieQueryEngine(StreamingTrie(base, device="cpu"))
    before = eng.top_k_rules_batch([[]], 6, metric="support")
    _eq(before, TO.top_k_rules_batch(base, [[]], 6, metric="support",
                                     device="cpu"), "pre-insert")
    paths = sorted(novel, key=len)
    eng.insert(paths, *zip(*[novel[p] for p in paths]))
    _eq(eng.top_k_rules_batch([[]], 6, metric="support"),
        TO.top_k_rules_batch(full, [[]], 6, metric="support",
                             device="cpu"), "post-insert")
    boost = paths[0]
    eng.insert([boost], [0.99], [0.5], [1.0])
    after = eng.top_k_rules_batch([[]], 6, metric="support")
    assert float(after["values"][0, 0]) == np.float32(0.99)
    _eq(after, TO.top_k_rules_batch(
        _patched(full, {boost: (0.99, 0.5, 1.0)}), [[]], 6,
        metric="support", device="cpu"), "post-update")


def _case_epoch_bump(split):
    tries, novel = split
    st = StreamingTrie(tries["base"][1], refreeze_max_delta=1,
                       device="cpu")
    eng = TrieQueryEngine(st)
    assert eng.epoch == 0 and eng.frozen is st.frozen
    path = sorted(novel, key=len)[0]
    eng.insert([path], *zip(novel[path]))
    assert eng.epoch == 1
    assert eng.maybe_refreeze() == path[0]
    assert eng.epoch == 2 and eng.frozen is st.frozen
    assert eng.frozen is not tries["base"][1]
    assert eng.maybe_refreeze() is None and eng.epoch == 2
    frozen_eng = TrieQueryEngine(tries["base"][1], device="cpu")
    assert frozen_eng.epoch == 0 and frozen_eng.maybe_refreeze() is None


def _case_frozen_engine_rejects_insert(split):
    tries, _ = split
    for eng in (JEngine(tries["base"][0], mode="replicated"),
                TrieQueryEngine(tries["base"][1], device="cpu")):
        with pytest.raises(TypeError, match="StreamingTrie"):
            eng.insert([(0,)], [0.1], [0.2], [0.3])


CASES = {
    "empty_delta": _case_empty_delta,
    "delta_only": _case_delta_only,
    "reinsert": _case_reinsert,
    "racing_refreeze": _case_racing_refreeze,
    "refreeze_rebuild": _case_refreeze_rebuild,
    "insert_validation": _case_insert_validation,
    "no_stale_cache": _case_no_stale_cache,
    "epoch_bump": _case_epoch_bump,
    "frozen_engine_rejects_insert": _case_frozen_engine_rejects_insert,
}


@pytest.mark.parametrize("case", list(CASES))
def test_streaming_case(split, case):
    CASES[case](split)


# ----------------------------------------------------------------------
# delta top-k order: ties, NaN and signed zeros
# ----------------------------------------------------------------------
SPECIAL = {
    "ties": [0.5, 0.25, 0.5],
    "nan": [np.nan, 0.5, -np.nan, np.inf, 0.0],
    "zeros": [0.0, -0.0, 0.0, 0.25],
}


@pytest.mark.parametrize("kind", list(SPECIAL))
def test_total_order_key_matches_lax_top_k(kind):
    rng = np.random.RandomState(len(kind))
    vals = np.asarray(SPECIAL[kind] + [-np.inf, 1.0], np.float32)
    x = vals[rng.randint(0, vals.size, size=(4, 96))]
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 96)
    order = torch.sort(TSTR.total_order_key(torch.from_numpy(x)), dim=1,
                       descending=True, stable=True).indices
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_i))
    got = np.take_along_axis(x, order.numpy(), 1)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.asarray(want_v).view(np.uint32))


@pytest.mark.parametrize("kind", list(SPECIAL))
def test_special_metrics_match_reference(split, kind):
    """Inserted metrics drawn from tie-heavy, NaN and signed-zero values:
    the ops answer as the reference's do, bit for bit."""
    tries, novel = split
    js, ts = JStream(tries["base"][0]), StreamingTrie(tries["base"][1],
                                                      device="cpu")
    paths = sorted(novel, key=len) + sorted(all_paths(tries["base"][1]))[::3]
    rng = np.random.RandomState(5)
    vals = np.asarray(SPECIAL[kind], np.float32)
    cols = [vals[rng.randint(0, vals.size, size=len(paths))]
            for _ in range(3)]
    for st in (js, ts):
        st.insert(paths, *cols)
    prefixes, items, pairs = query_fixture(tries["full"][1])
    for metric in ("support", "conviction"):
        _eq(TO.top_k_rules_batch(ts, prefixes, 6, metric=metric),
            JO.top_k_rules_batch(js, prefixes, 6, metric=metric),
            f"{kind} topk {metric}")
        for role in ("any", "consequent"):
            _eq(TO.rules_with(ts, items, role=role, k=6, metric=metric),
                JO.rules_with(js, items, role=role, k=6, metric=metric),
                f"{kind} rules_with {role} {metric}")
    _eq(TO.rule_search_batch(ts, pairs), JO.rule_search_batch(js, pairs),
        f"{kind} rule_search")


# ----------------------------------------------------------------------
# engine routing, refusals and reconstruct_paths
# ----------------------------------------------------------------------
def test_engine_over_stream_matches_reference(split):
    js, ts, _ = _streams(split, "updates")
    prefixes, items, pairs = query_fixture(split[0]["full"][1])
    jeng, teng = JEngine(js, mode="replicated"), TrieQueryEngine(ts)
    assert teng.device == torch.device("cpu") and teng.epoch == jeng.epoch
    _eq(teng.rule_search_batch(pairs), jeng.rule_search_batch(pairs),
        "engine rule_search")
    _eq(teng.top_k_rules_batch(prefixes, 7, metric="leverage"),
        jeng.top_k_rules_batch(prefixes, 7, metric="leverage"),
        "engine topk")
    for role in ROLES:
        _eq(teng.rules_with(items, role=role, k=7),
            jeng.rules_with(items, role=role, k=7), f"engine {role}")
    assert teng._stream_base() is None and teng.dt is None


def test_stream_refusals(split):
    tries, _ = split
    base = tries["base"][1]
    st = StreamingTrie(base, device="cpu")
    # a mesh shards the frozen side (slice 6): its plan covers the base
    meshed = StreamingTrie(base, mesh=TrieMesh(["cpu"] * 3), device="cpu")
    assert meshed.shard_plan().n_shards == 3
    assert meshed.shard_plan().ranges[-1][1] == base.n_nodes
    with pytest.raises(ValueError, match="plain layout"):
        StreamingTrie(base, layout="compressed", device="cpu")
    assert st.shard_plan() is None and st.owner_shard([0]) is None
    for fn in (TO.trie_reduce, TO.edge_metric_arrays, TO.dfs_rank_arrays,
               TO.item_rank_arrays):
        with pytest.raises(NotImplementedError, match="slice 4"):
            fn(st)
    with pytest.raises(NotImplementedError, match="prefix_ranges"):
        TO.prefix_ranges(st, [[0]])
    with pytest.raises(NotImplementedError, match="trie_reduce"):
        TrieQueryEngine(st).trie_reduce()
    with pytest.raises(ValueError, match="arrays="):
        TO.top_k_rules_batch(st, [[]], 3, arrays={})
    with pytest.raises(ValueError, match="arrays="):
        TO.rules_with(st, [0], arrays={})
    with pytest.raises(ValueError, match="edges="):
        TO.rule_search_batch(st, [((0,), (1,))], edges={})
    with pytest.raises(ValueError, match="answers on cpu"):
        TrieQueryEngine(st, device="meta")
    with pytest.raises(TO.InvalidQueryError):
        TO.rules_with(st, [0.5])


@pytest.mark.parametrize("tag", ["base", "full"])
@pytest.mark.parametrize("max_depth", [0, 1, 3, 8])
def test_reconstruct_paths_matches_reference(split, tag, max_depth):
    jf, tf = split[0][tag]
    ids = np.r_[0:tf.n_nodes, 0, tf.n_nodes - 1].astype(np.int32)
    want = JA.reconstruct_paths(jf.device_arrays(), jnp.asarray(ids),
                                max_depth)
    got = reconstruct_paths(tf.device_arrays(device="cpu"),
                            torch.from_numpy(ids), max_depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if max_depth >= tf.max_depth:
        for nid in range(tf.n_nodes):
            row = [int(x) for x in got[nid] if x >= 0]
            assert tuple(row) == tf.path_items(nid)


def test_reconstruct_paths_refuses_compressed(split):
    jf, tf = split[0]["full"]
    with pytest.raises(ValueError, match="plain layout") as got:
        reconstruct_paths(tf.device_arrays(device="cpu",
                                           layout="compressed"),
                          torch.zeros(1, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="plain layout") as want:
        JA.reconstruct_paths(jf.device_arrays(layout="compressed"),
                             jnp.zeros(1, jnp.int32), 3)
    assert str(got.value) == str(want.value)
