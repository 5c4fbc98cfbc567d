"""Port parity for mining (paper Step 1) and rule generation: the port's
datasets, miners, rule generation and flat table against the reference's
on the same transactions.  Apriori's kernel path runs on the CPU here
(``use_kernel=True, device="cpu"``: the plain version of the bitmap
kernel, one call per level).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.arm import datasets as JD  # noqa: E402
from repro.arm import rulegen as JR  # noqa: E402
from repro.arm.apriori import apriori as jax_apriori  # noqa: E402
from repro.arm.fpgrowth import fpgrowth as jax_fpgrowth  # noqa: E402
from repro.arm.fpgrowth import fpmax as jax_fpmax  # noqa: E402
from repro.arm.transactions import TransactionDB as JaxDB  # noqa: E402
from repro.core.flat_table import FlatRuleTable as JaxTable  # noqa: E402
from repro_torch.arm import datasets as TD  # noqa: E402
from repro_torch.arm import rulegen as TR  # noqa: E402
from repro_torch.arm.apriori import apriori  # noqa: E402
from repro_torch.arm.fpgrowth import fpgrowth, fpmax  # noqa: E402
from repro_torch.arm.transactions import TransactionDB  # noqa: E402
from repro_torch.core.flat_table import FlatRuleTable  # noqa: E402
from repro_torch.kernels.support_count import support_count_bitmap  # noqa: E402


def _port_db(jdb):
    """The port's DB over the reference DB's own transactions."""
    return TransactionDB([sorted(t) for t in jdb.transactions], jdb.n_items)


def _same_db(tdb, jdb):
    assert tdb.n_transactions == jdb.n_transactions
    assert tdb.n_items == jdb.n_items
    assert tdb.transactions == jdb.transactions
    assert tdb.item_bitmaps.dtype == jdb.item_bitmaps.dtype
    np.testing.assert_array_equal(tdb.item_bitmaps, jdb.item_bitmaps)
    np.testing.assert_array_equal(tdb.item_counts(), jdb.item_counts())
    assert tdb.frequency_order() == jdb.frequency_order()


@pytest.fixture(scope="module")
def retail():
    """The retail stand-in, generated once per module by each package."""
    return TD.online_retail_db(), JD.online_retail_db()


@pytest.fixture(scope="module")
def grocery():
    return TD.grocery_db(), JD.grocery_db()


@pytest.mark.parametrize("name", ["paper_example", "grocery", "retail"])
def test_datasets_match_reference(name, grocery, retail):
    if name == "paper_example":
        tdb, jdb = TD.paper_example_db(), JD.paper_example_db()
    else:
        tdb, jdb = {"grocery": grocery, "retail": retail}[name]
    _same_db(tdb, jdb)
    _same_db(_port_db(jdb), jdb)


def test_dataset_specs_and_seeds_match_reference():
    assert TD.GROCERY.__dict__ == JD.GROCERY.__dict__
    assert TD.ONLINE_RETAIL.__dict__ == JD.ONLINE_RETAIL.__dict__
    _same_db(TD.grocery_db(seed=7), JD.grocery_db(seed=7))


@pytest.mark.parametrize("minsup", [0.2, 0.4, 0.6])
def test_miners_match_reference_paper_example(minsup):
    jdb = JD.paper_example_db()
    tdb = _port_db(jdb)
    want = jax_apriori(jdb, minsup)
    assert want == jax_fpgrowth(jdb, minsup)
    assert apriori(tdb, minsup) == want
    assert apriori(tdb, minsup, use_kernel=True, device="cpu") == want
    assert apriori(tdb, minsup, use_kernel=True, device="cpu",
                   max_len=2) == jax_apriori(jdb, minsup, max_len=2)
    assert fpgrowth(tdb, minsup) == want
    assert fpmax(tdb, minsup) == jax_fpmax(jdb, minsup)


@pytest.mark.parametrize("miner", ["apriori", "apriori_kernel", "fpgrowth",
                                   "fpmax"])
def test_miners_match_reference_grocery(miner, grocery):
    tdb, jdb = grocery
    minsup = 0.005
    if miner == "fpmax":
        assert fpmax(tdb, minsup) == jax_fpmax(jdb, minsup)
        return
    want = jax_fpgrowth(jdb, minsup)
    if miner == "apriori":
        got = apriori(tdb, minsup)
    elif miner == "apriori_kernel":
        got = apriori(tdb, minsup, use_kernel=True, device="cpu")
    else:
        got = fpgrowth(tdb, minsup)
    assert len(got) == len(want) > 900
    assert got == want


def test_apriori_kernel_path_calls_support_count_once_per_level(
        monkeypatch):
    """Each counting level is one ``ops.support_count`` call."""
    from repro_torch.kernels import ops as TO

    calls = []
    real = TO.support_count

    def spy(*a, **kw):
        calls.append(np.asarray(a[0]).shape)
        return real(*a, **kw)

    monkeypatch.setattr(TO, "support_count", spy)
    tdb = TD.paper_example_db()
    before = support_count_bitmap.launches
    got = apriori(tdb, 0.4, use_kernel=True, device="cpu")
    assert got == apriori(tdb, 0.4)
    # levels 2..max_size, and one more when its candidates all fail
    max_size = max(len(s) for s in got)
    assert len(calls) in (max_size - 1, max_size)
    assert [k for _, k in calls] == list(range(2, len(calls) + 2))
    assert support_count_bitmap.launches == before   # CPU: plain version


@pytest.mark.parametrize("minsup", [0.2, 0.4])
def test_rulegen_matches_reference(minsup):
    jdb = JD.paper_example_db()
    tdb = _port_db(jdb)
    itemsets = jax_fpgrowth(jdb, minsup)
    seqs = TR.canonical_sequences(itemsets.keys(), tdb)
    assert seqs == JR.canonical_sequences(itemsets.keys(), jdb)
    mat, lens = TR.canonical_matrix(itemsets.keys(), tdb)
    jmat, jlens = JR.canonical_matrix(itemsets.keys(), jdb)
    np.testing.assert_array_equal(mat, jmat)
    np.testing.assert_array_equal(lens, jlens)
    assert TR.distinct_paths(seqs) == JR.distinct_paths(seqs)
    assert TR.sample_rule_sequences(tdb, 40, seed=3) == \
        JR.sample_rule_sequences(jdb, 40, seed=3)
    for min_conf in (0.0, 0.6):
        rules = TR.prefix_split_rules(itemsets, tdb, min_confidence=min_conf)
        want = JR.prefix_split_rules(itemsets, jdb, min_confidence=min_conf)
        assert [(r.antecedent, r.consequent, r.metrics.as_dict())
                for r in rules] == \
            [(r.antecedent, r.consequent, r.metrics.as_dict()) for r in want]
        table, jtable = FlatRuleTable.from_rules(rules), \
            JaxTable.from_rules(want)
        assert len(table) == len(jtable)
        assert table.memory_cells() == jtable.memory_cells()
        for metric in ("support", "confidence", "lift"):
            assert [r.key() for r in table.top_n(5, metric)] == \
                [r.key() for r in jtable.top_n(5, metric)]
        for r in want[:10]:
            got = table.search_rule(r.antecedent, r.consequent)
            assert got is not None
            assert got.as_dict() == jtable.search_rule(
                r.antecedent, r.consequent).as_dict()
        assert table.search_rule((99,), (98,)) is None


# ----------------------------------------------------------------------
# hypothesis properties over both packages' DB strategies
# ----------------------------------------------------------------------
try:
    from hypothesis import given, settings

    from repro.core.synthetic import db_and_minsup as jax_db_and_minsup
    from repro_torch.core.synthetic import db_and_minsup

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @settings(deadline=None)
    @given(db_and_minsup())
    def test_port_miners_agree_random_dbs(case):
        """On the port's own strategy: host apriori, kernel-path apriori
        and fpgrowth give one dict, fpmax its maximal frontier, and the
        reference agrees on the same transactions."""
        tdb, minsup = case
        assert isinstance(tdb, TransactionDB)
        fp = fpgrowth(tdb, minsup)
        assert apriori(tdb, minsup) == fp
        assert apriori(tdb, minsup, use_kernel=True, device="cpu") == fp
        fm = fpmax(tdb, minsup)
        assert fm == {s: c for s, c in fp.items()
                      if not any(s < t for t in fp)}
        jdb = JaxDB([sorted(t) for t in tdb.transactions], tdb.n_items)
        assert jax_fpgrowth(jdb, minsup) == fp

    @settings(deadline=None)
    @given(jax_db_and_minsup())
    def test_reference_dbs_mine_alike_in_port(case):
        """On the reference's strategy: the port's DB over the same
        transactions has the same bitmaps and mines the same itemsets;
        its support_batch paths agree with the reference's host path on
        every mined itemset."""
        jdb, minsup = case
        tdb = _port_db(jdb)
        _same_db(tdb, jdb)
        want = jax_apriori(jdb, minsup)
        assert apriori(tdb, minsup, use_kernel=True, device="cpu") == want
        assert fpgrowth(tdb, minsup) == want
        assert fpmax(tdb, minsup) == jax_fpmax(jdb, minsup)
        if want:
            mat, lens = tdb.candidate_matrix([sorted(s) for s in want], 12)
            counts = jdb.support_batch(mat, lens)
            np.testing.assert_array_equal(tdb.support_batch(mat, lens),
                                          counts)
            np.testing.assert_array_equal(
                tdb.support_batch(mat, lens, use_kernel=True, device="cpu"),
                counts)
            assert counts.tolist() == [want[frozenset(s)] for s in
                                       (tuple(r[r >= 0]) for r in mat)]
