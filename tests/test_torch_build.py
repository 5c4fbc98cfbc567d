"""Port parity for trie construction (paper Steps 2-3) and for the slice as
a whole: the pointer engine and its freeze, the array-native builder on
both of its support paths, the batched annotation, and the three-step
pipeline, each against the reference; then a trie the port builds on the
CPU, served by the port's engine, against the reference's engine on the
reference's build.  The kernel path runs on the CPU here (the plain
version of the bitmap kernel); the reference's runs its Pallas kernel in
interpret mode.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.arm import datasets as JD  # noqa: E402
from repro.arm.fpgrowth import fpgrowth as jax_fpgrowth  # noqa: E402
from repro.arm.rulegen import canonical_sequences  # noqa: E402
from repro.core import array_trie as JA  # noqa: E402
from repro.core import build_arrays as JB  # noqa: E402
from repro.core import builder as JBu  # noqa: E402
from repro.core.trie import TrieOfRules as JaxPointer  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.serve.trie_engine import TrieQueryEngine as JaxEngine  # noqa: E402
from repro_torch.arm.transactions import TransactionDB  # noqa: E402
from repro_torch.core import array_trie as TA  # noqa: E402
from repro_torch.core import build_arrays as TB  # noqa: E402
from repro_torch.core import builder as TBu  # noqa: E402
from repro_torch.core.trie import TrieOfRules  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.serve import TrieQueryEngine  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
METRICS = ("support", "confidence", "lift")


def _port_db(jdb):
    return TransactionDB([sorted(t) for t in jdb.transactions], jdb.n_items)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_trie(got, want, metrics="bitwise"):
    """Every field of the port's ``FrozenTrie`` against another frozen
    trie's: structure bitwise; the metric columns bitwise, or to rtol 1e-6
    / atol 1e-7 with ``metrics="close"`` (f32 kernel path against the f64
    host path)."""
    for f in dataclasses.fields(JA.FrozenTrie):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if not isinstance(w, np.ndarray):
            assert g == w, f.name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        if f.name in METRICS and metrics == "close":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f.name)


@pytest.fixture(scope="module")
def grocery():
    jdb = JD.grocery_db()
    tdb = _port_db(jdb)
    itemsets = jax_fpgrowth(jdb, 0.005)
    return tdb, jdb, canonical_sequences(itemsets.keys(), jdb)


def _paper(minsup=0.25):
    jdb = JD.paper_example_db()
    return _port_db(jdb), jdb, canonical_sequences(
        jax_fpgrowth(jdb, minsup).keys(), jdb)


# hand-made sequence sets: shared prefixes, a duplicate item inside a
# sequence (the pointer insert walks a 2/2/5 path), repeats, singletons,
# out-of-order items and nothing at all
MANUAL = {
    "shared": [(2, 0), (2, 0, 5), (2, 5), (0,), (5, 12)],
    "duplicate_item": [(2, 2, 5), (2, 5), (2,)],
    "repeats_and_order": [(5, 2), (2, 5), (2, 5), (12, 0, 2), (3,)],
    "empty": [],
}


@pytest.mark.parametrize("source", ["paper", "grocery", *MANUAL])
def test_pointer_engine_and_freeze_match_reference(source, grocery):
    """``TrieOfRules.build`` + ``annotate`` + ``FrozenTrie.freeze`` in
    both packages, field for field, bitwise."""
    if source == "grocery":
        tdb, jdb, seqs = grocery
    else:
        tdb, jdb, seqs = _paper()
        seqs = MANUAL.get(source, seqs)
    ptr = TrieOfRules(item_order=tdb.frequency_order()).build(seqs)
    ptr.annotate(tdb.support_fn())
    jptr = JaxPointer(item_order=jdb.frequency_order()).build(seqs)
    jptr.annotate(jdb.support_fn())
    assert len(ptr) == len(jptr)
    assert ptr.depth1_subtree_sizes() == jptr.depth1_subtree_sizes()
    for seq in seqs[:20]:
        got, want = ptr.search_rule(seq[:1], seq[1:] or seq[:1]), \
            jptr.search_rule(seq[:1], seq[1:] or seq[:1])
        assert (got is None) == (want is None)
        if got is not None:
            assert got.as_dict() == want.as_dict()
    assert_same_trie(TA.FrozenTrie.freeze(ptr), JA.FrozenTrie.freeze(jptr))


@pytest.mark.parametrize("source", ["paper", "grocery", *MANUAL])
def test_build_frozen_trie_host_path(source, grocery):
    """``use_kernel=False``: bitwise equal to the reference's host path,
    and to the port's own pointer freeze (structure bitwise, metrics to
    1e-6)."""
    if source == "grocery":
        tdb, jdb, seqs = grocery
    else:
        tdb, jdb, seqs = _paper()
        seqs = MANUAL.get(source, seqs)
    got, build_s, annotate_s = TB.build_frozen_trie(tdb, seqs,
                                                    use_kernel=False)
    assert build_s >= 0 and annotate_s >= 0
    want, _, _ = JB.build_frozen_trie(jdb, seqs, use_kernel=False)
    assert_same_trie(got, want)
    ptr = TrieOfRules(item_order=tdb.frequency_order()).build(seqs)
    ptr.annotate(tdb.support_fn())
    assert_same_trie(got, TA.FrozenTrie.freeze(ptr), metrics="close")


@pytest.mark.parametrize("source", ["paper", "grocery", "shared",
                                    "duplicate_item"])
def test_build_frozen_trie_kernel_path(source, grocery):
    """``use_kernel=True`` on the CPU: every column bitwise equal to the
    reference's kernel path (its Pallas kernel in interpret mode; both
    are f32 IEEE divisions of the same exact counts), and to the host
    path within the f32-vs-f64 tolerance."""
    if source == "grocery":
        tdb, jdb, seqs = grocery
    else:
        tdb, jdb, seqs = _paper()
        seqs = MANUAL.get(source, seqs)
    got, _, _ = TB.build_frozen_trie(tdb, seqs, use_kernel=True,
                                     device="cpu")
    want, _, _ = JB.build_frozen_trie(jdb, seqs, use_kernel=True)
    assert_same_trie(got, want)
    host, _, _ = TB.build_frozen_trie(tdb, seqs, use_kernel=False)
    assert_same_trie(got, host, metrics="close")
    # None means the kernel path
    default, _, _ = TB.build_frozen_trie(tdb, seqs, device="cpu")
    assert_same_trie(default, got)


def test_annotate_candidates_matches_reference(grocery):
    """All five columns bitwise, leverage and conviction included."""
    tdb, jdb, seqs = grocery
    mat, lens = TB.pack_sequences(seqs)
    _, item_rank = TA.item_tables(tdb.frequency_order())
    mat = TB.canonicalize_matrix(mat, item_rank)
    arrs = TB.trie_arrays(mat, (mat >= 0).sum(axis=1))
    args = (arrs["cand"], arrs["node_depth"][1:], arrs["node_parent"][1:],
            arrs["node_item"][1:], tdb.item_counts(), tdb.n_transactions)
    got = TO.annotate_candidates(*args, item_bitmaps=tdb.item_bitmaps,
                                 device="cpu")
    want = JO.annotate_candidates(*args, item_bitmaps=jdb.item_bitmaps)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy().view(np.int32),
                                      np.asarray(want[key]).view(np.int32),
                                      err_msg=key)
    # the dense-input form gives the same columns
    dense = TO.dense_from_bitmaps(tdb.item_bitmaps)[:tdb.n_transactions]
    again = TO.annotate_candidates(*args, dense_tx=dense, device="cpu")
    for key in want:
        assert torch.equal(again[key], got[key]), key


@pytest.mark.parametrize("engine", ["pointer", "arrays", "both"])
@pytest.mark.parametrize("miner", ["apriori", "fpgrowth", "fpmax"])
def test_build_trie_of_rules_matches_reference(engine, miner):
    """The three-step pipeline on the paper's example DB: itemsets and
    sequences equal; the host paths (``use_kernel=False``) bitwise; the
    port's default (the kernel path, here on the CPU) against the
    reference's host default within the f32-vs-f64 tolerance."""
    tdb, jdb, _ = _paper()
    want = JBu.build_trie_of_rules(jdb, 0.25, miner=miner, engine=engine,
                                   use_kernel=False)
    want_frozen = want.frozen        # before freeze() caches one
    want_freeze = want.freeze()
    for use_kernel, metrics in ((False, "bitwise"), (None, "close")):
        got = TBu.build_trie_of_rules(tdb, 0.25, miner=miner, engine=engine,
                                      use_kernel=use_kernel, device="cpu")
        assert got.engine == engine
        assert got.itemsets == want.itemsets
        assert got.sequences == want.sequences
        assert (got.trie is None) == (want.trie is None)
        if want.trie is not None:
            assert_same_trie(TA.FrozenTrie.freeze(got.trie),
                             JA.FrozenTrie.freeze(want.trie))
        assert (got.frozen is None) == (want_frozen is None)
        if want_frozen is not None:
            assert_same_trie(got.frozen, want_frozen, metrics=metrics)
        # a pointer engine's freeze carries the host f64 columns
        assert_same_trie(got.freeze(), want_freeze, metrics=(
            metrics if want_frozen is not None else "bitwise"))
        assert got.mine_seconds >= 0 and got.construct_seconds >= 0
    table, rules, secs = TBu.build_flat_table(tdb, want.itemsets)
    jtable, jrules, _ = JBu.build_flat_table(jdb, want.itemsets)
    assert len(table) == len(jtable) and secs >= 0
    assert [(r.key(), r.metrics.as_dict()) for r in rules] == \
        [(r.key(), r.metrics.as_dict()) for r in jrules]


def test_build_trie_of_rules_rejects_unknown_engine():
    tdb, _, _ = _paper()
    with pytest.raises(ValueError, match="engine"):
        TBu.build_trie_of_rules(tdb, 0.25, engine="nope")


def test_kernel_path_needs_a_device_when_no_gpu():
    """With no card, the kernel path asked for the default device raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device works")
    tdb, _, seqs = _paper()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.build_frozen_trie(tdb, seqs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TBu.build_trie_of_rules(tdb, 0.25, miner="apriori", engine="arrays")
    # the host paths need no device
    TBu.build_trie_of_rules(tdb, 0.25, miner="fpgrowth", engine="arrays",
                            use_kernel=False)


def test_slice_grocery_build_served_like_reference(grocery):
    """The slice as a whole: mine (apriori, kernel path), build and
    annotate a grocery trie with the port on the CPU and serve it through
    the port's engine; the reference builds the same trie (its kernel
    path) and serves it through its engine; every answer equal."""
    tdb, jdb, _ = grocery
    got = TBu.build_trie_of_rules(tdb, 0.005, miner="apriori",
                                  engine="arrays", device="cpu")
    want = JBu.build_trie_of_rules(jdb, 0.005, miner="fpgrowth",
                                   engine="arrays", use_kernel=True)
    assert got.itemsets == want.itemsets
    assert_same_trie(got.frozen, want.frozen)
    fz, jf = got.frozen, want.frozen
    teng = TrieQueryEngine(fz, device="cpu")
    jeng = JaxEngine(jf, mode="replicated")

    def same(g, w):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]),
                                          err_msg=key)

    rng = np.random.RandomState(5)
    nodes = rng.randint(1, fz.n_nodes, size=200)
    pairs = []
    for v in nodes:
        path = list(fz.path_items(int(v)))
        cut = int(rng.randint(0, len(path)))
        pairs.append((path[:cut], path[cut:]))
    pairs += [([0], [168]), ([], [3, 4]), ([200], [1])]
    res = teng.rule_search_batch(pairs)
    same(res, jeng.rule_search_batch(pairs))
    assert res["found"][:200].all()
    prefixes = [[], [int(fz.item_order[0])], list(fz.path_items(int(nodes[0]))),
                [999]]
    for k, metric in ((10, "confidence"), (100, "lift"), (7, "conviction")):
        same(teng.top_k_rules_batch(prefixes, k, metric=metric),
             jeng.top_k_rules_batch(prefixes, k, metric=metric))
    items = [int(x) for x in rng.randint(0, tdb.n_items, size=30)] + [-1, 500]
    for role in ("consequent", "antecedent", "any"):
        same(teng.rules_with(items, role=role, k=10, metric="leverage"),
             jeng.rules_with(items, role=role, k=10, metric="leverage"))
    red = teng.trie_reduce()
    jred = JA.traverse_reduce(jf.device_arrays())
    assert float(red["n_rules"]) == float(jred["n_rules"]) == fz.n_nodes - 1
    assert float(red["confidence_max"]) == float(jred["confidence_max"])
    np.testing.assert_allclose(float(red["support_sum"]),
                               float(jred["support_sum"]), rtol=1e-6)


def test_construction_imports_and_runs_without_jax_or_repro():
    """Mining, building and annotating run with ``jax`` and ``repro``
    made unimportable, so no import of either hides inside a function of
    the construction path."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.arm, repro_torch.core.synthetic\n"
        "from repro_torch.arm.datasets import paper_example_db\n"
        "from repro_torch.core import build_trie_of_rules\n"
        "db = paper_example_db()\n"
        "for engine in ('pointer', 'arrays', 'both'):\n"
        "    for miner in ('apriori', 'fpgrowth', 'fpmax'):\n"
        "        r = build_trie_of_rules(db, 0.25, miner=miner, "
        "engine=engine, device='cpu')\n"
        "        assert r.freeze().n_nodes > 1\n"
        "from repro_torch.core import build_flat_table\n"
        "build_flat_table(db, r.itemsets)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
