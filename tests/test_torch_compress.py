"""Port parity for the path-compressed, quantized layout: the chain-run
detector, the compressed encoding and the column quantization against the
reference's, field for field; every op on compressed tries (f32, int32 +
bf16, int32 + int8 and bf16 support) against the reference's ops, whose
kernels run in Pallas interpret mode, bitwise (``trie_reduce`` sums to
1e-6 relative); compressed f32 against the plain layout inside the port;
and the span search's plain version against the reference's span kernel
and its full-table oracle.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.arm import datasets as JD  # noqa: E402
from repro.core import array_trie as JA  # noqa: E402
from repro.core import builder as JBu  # noqa: E402
from repro.core import synthetic as JS  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.kernels.rule_search import rule_search_span_pallas  # noqa: E402
from repro_torch.core import array_trie as TA  # noqa: E402
from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    dequantize_int8, quantize_int8,
)
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.kernels.metrics_inkernel import (  # noqa: E402
    STORAGE_PAIRS, dequantize_metrics, storage_codes,
)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ROLES = ("any", "antecedent", "consequent")
N_TX = 100_000
QUANT = {
    "f32": dict(),
    "i32+bf16": dict(quantize=True, n_transactions=N_TX),
    "i32+int8": dict(quantize=True, n_transactions=N_TX, columns="int8"),
    "bf16": dict(quantize=True),
    "bf16+int8": dict(quantize=True, columns="int8"),
}


def _port(fz):
    """The port's FrozenTrie over a reference FrozenTrie's fields."""
    return TA.FrozenTrie.from_arrays({
        f.name: np.asarray(getattr(fz, f.name))
        for f in dataclasses.fields(JA.FrozenTrie)
    })


def _np(x):
    """numpy view of a port tensor or reference array; bf16 as its bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _same(got, want, what=""):
    """Bitwise equality, dtype and shape included."""
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                       w.dtype)
    if g.dtype == np.float32:
        g, w = g.view(np.uint32), w.view(np.uint32)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _same_dict(got, want, what=""):
    assert set(got) == set(want), what
    for key in want:
        _same(got[key], want[key], f"{what} {key}")


def _hand_runs():
    """A hand-built trie: a root with two runs (one of them branching at
    its tail), a leaf child of the root and a duplicate item on a run."""
    from repro.core.trie import TrieOfRules

    t = TrieOfRules()
    for seq in ([0, 1, 2, 3, 4], [0, 1, 2, 3, 5], [0, 1, 2, 3, 5, 6, 7],
                [2], [3, 3, 3, 1], [4, 0, 1]):
        t.insert([int(x) for x in seq])
    return JA.FrozenTrie.freeze(t)


def _single_chain():
    arrs = JS.synthetic_chain_trie(60, chain_fraction=1.0, root_fanout=1,
                                   chain_len=80, seed=1)
    return JS.frozen_from_arrays(arrs)


def _root_only():
    return JS.frozen_from_arrays(JS.synthetic_csr_trie(0, seed=0))


@pytest.fixture(scope="module")
def grocery():
    db = JD.grocery_db()
    fz = JBu.build_trie_of_rules(db, 0.01, miner="fpgrowth", engine="arrays",
                                 use_kernel=False).frozen
    return fz, db.n_transactions


@pytest.fixture(scope="module")
def tries(grocery):
    """Reference FrozenTries of every shape the structure tests cover."""
    return {
        "chain300": JS.frozen_from_arrays(
            JS.synthetic_chain_trie(300, chain_fraction=0.7, seed=0)),
        "chain3000": JS.frozen_from_arrays(
            JS.synthetic_chain_trie(3000, chain_fraction=0.75, seed=3)),
        "branchy": JS.frozen_from_arrays(
            JS.synthetic_chain_trie(800, chain_fraction=0.0, seed=2)),
        "grocery": grocery[0],
        "root_only": _root_only(),
        "single_chain": _single_chain(),
        "hand_runs": _hand_runs(),
    }


SHAPES = ("chain300", "chain3000", "branchy", "grocery", "root_only",
          "single_chain", "hand_runs")


# ----------------------------------------------------------------------
# structure: detector, encoding, round trip
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_chain_spans_and_encoding_match_reference(tries, shape):
    jf = tries[shape]
    tf = _port(jf)
    cc = np.diff(np.asarray(jf.child_offsets, np.int64))
    d2n = np.asarray(jf.dfs_to_node, np.int64)
    for got, want in zip(TA.chain_spans(cc[d2n]), JA.chain_spans(cc[d2n])):
        _same(got, want, "chain_spans")
    dfs = np.asarray(jf.dfs_order, np.int64)
    args = (cc[d2n], dfs[jf.edge_parent], jf.edge_item, dfs[jf.edge_child])
    got, want = TA.compress_pos_space(*args), JA.compress_pos_space(*args)
    assert set(got) == set(want)
    for key in want:
        if key == "max_fanout":
            assert got[key] == want[key]
        else:
            _same(got[key], want[key], key)
    assert tf.span_fraction() == jf.span_fraction()
    tc, jc = tf.compress(), jf.compress()
    for f in dataclasses.fields(JA.CompressedTrie):
        g, w = getattr(tc, f.name), getattr(jc, f.name)
        if isinstance(w, (int, float)):
            assert g == w and type(g) is type(w), f.name
        else:
            _same(g, w, f.name)
    for name in ("n_nodes", "n_edges", "n_compressed_edges",
                 "span_fraction"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert tc.nbytes() == jc.nbytes()


@pytest.mark.parametrize("shape", SHAPES)
def test_expand_edges_round_trip(tries, shape):
    """The spans re-expand to the plain edge table in DFS-position space,
    as the reference's do."""
    jf = tries[shape]
    tc = _port(jf).compress()
    for got, want in zip(tc.expand_edges(), jf.compress().expand_edges()):
        _same(got, want)
    dfs = np.asarray(jf.dfs_order, np.int64)
    parent, item, child = tc.expand_edges()
    order = np.argsort(dfs[jf.edge_child])
    np.testing.assert_array_equal(parent, dfs[jf.edge_parent][order])
    np.testing.assert_array_equal(item, np.asarray(jf.edge_item)[order])
    np.testing.assert_array_equal(child, dfs[jf.edge_child][order])


def test_auto_layout(tries):
    """``auto`` compresses the chain-heavy trie and keeps the mined
    grocery trie plain, as the reference does."""
    for shape, layout in (("chain3000", "compressed"), ("grocery", "plain"),
                          ("root_only", "plain")):
        jf = tries[shape]
        got = _port(jf).device_arrays(device="cpu", layout="auto")
        assert got.layout == jf.device_arrays(layout="auto").layout == layout
    with pytest.raises(ValueError):
        _port(tries["chain300"]).device_arrays(device="cpu", layout="dense")


# ----------------------------------------------------------------------
# quantization
# ----------------------------------------------------------------------
def test_int8_codes_match_reference():
    from repro.distributed.compression import quantize_int8 as jq

    rng = np.random.RandomState(0)
    for x in (rng.rand(5000).astype(np.float32) * 2,
              (rng.randn(999) * 3).astype(np.float32),
              np.zeros(7, np.float32), np.array([2.5, -2.5, 0.5], np.float32)):
        wq, ws = jq(jnp.asarray(x))
        gq, gs = quantize_int8(torch.from_numpy(x))
        _same(gq, wq, "codes")
        _same(gs, np.float32(ws), "scale")
        _same(dequantize_int8(gq, gs), np.asarray(wq, np.float32) * ws)


@pytest.mark.parametrize("quant", ["i32+bf16", "i32+int8", "bf16",
                                   "bf16+int8"])
@pytest.mark.parametrize("shape", ["chain3000", "grocery"])
def test_quantize_metric_columns_match_reference(tries, grocery, shape,
                                                 quant):
    jf = tries[shape]
    n_tx = grocery[1] if shape == "grocery" else N_TX
    kw = {"n_transactions": 0 if quant.startswith("bf16") else n_tx,
          "columns": "int8" if quant.endswith("int8") else "bf16"}
    cols = [np.asarray(getattr(jf, c), np.float32)
            for c in ("support", "confidence", "lift")]
    got = TA.quantize_metric_columns(*cols, **kw)
    want = JA.quantize_metric_columns(*cols, **kw)
    for g, w in zip(got[:3], want[:3]):
        _same(g, w)
    assert got[3:] == want[3:]
    assert all(type(g) is type(w) for g, w in zip(got[3:], want[3:]))
    tc = _port(jf).compress(quantize=True, **kw)
    jc = jf.compress(quantize=True, **kw)
    for f in ("support_pos", "confidence_pos", "lift_pos"):
        _same(getattr(tc, f), getattr(jc, f), f)
    assert (tc.n_transactions, tc.confidence_scale, tc.lift_scale) == \
        (jc.n_transactions, jc.confidence_scale, jc.lift_scale)
    assert tc.nbytes() == jc.nbytes()


@pytest.mark.parametrize("quant", sorted(QUANT))
@pytest.mark.parametrize("shape", ["chain3000", "root_only", "grocery"])
def test_device_trie_nbytes_matches_reference(tries, shape, quant):
    jf = tries[shape]
    td = _port(jf).device_arrays(device="cpu", layout="compressed",
                                 **QUANT[quant])
    jd = jf.device_arrays(layout="compressed", **QUANT[quant])
    assert td.nbytes() == jd.nbytes()
    assert td.layout == "compressed"
    assert _port(jf).device_arrays(device="cpu").nbytes() == \
        jf.device_arrays().nbytes()


def test_dequantize_metrics_matches_reference():
    from repro.kernels.metrics_inkernel import dequantize_metrics as jdq

    rng = np.random.RandomState(3)
    counts = rng.randint(0, 18_000, size=4000).astype(np.int32)
    f32 = rng.rand(4000).astype(np.float32)
    for n_tx in (18_000, 100_000, 7, 0):
        _same(dequantize_metrics(torch.from_numpy(counts), torch.zeros(1),
                                 torch.zeros(1), n_tx)[0],
              jdq(jnp.asarray(counts), jnp.zeros(1), jnp.zeros(1), n_tx)[0])
    bf = torch.from_numpy(f32).to(torch.bfloat16)
    q, s = quantize_int8(torch.from_numpy(f32))
    got = dequantize_metrics(bf, q, bf, 0, float(s), 1.0)
    want = jdq(jnp.asarray(f32).astype(jnp.bfloat16), jnp.asarray(q.numpy()),
               jnp.asarray(f32).astype(jnp.bfloat16), 0, float(s), 1.0)
    for g, w in zip(got, want):
        _same(g, w)
    f = torch.from_numpy(f32)
    assert dequantize_metrics(f, f, f)[0] is f
    with pytest.raises(TypeError):
        storage_codes("x", f.double(), f, f)
    with pytest.raises(TypeError):
        storage_codes("x", f, f.to(torch.bfloat16), f)


@pytest.mark.parametrize("sup", [torch.float32, torch.int32,
                                 torch.bfloat16])
@pytest.mark.parametrize("col", [torch.float32, torch.bfloat16, torch.int8])
def test_storage_codes_take_only_the_pairs_a_layout_makes(sup, col):
    """The kernels instantiate the five (support, confidence/lift) storage
    pairs that quantize_metric_columns makes; any other pair raises before
    a launch."""
    s, c = torch.zeros(4, dtype=sup), torch.zeros(4, dtype=col)
    tf = _port(_single_chain())
    made = set()
    for kw in QUANT.values():
        dt = tf.device_arrays(device="cpu", layout="compressed", **kw)
        assert dt.lift.dtype == dt.confidence.dtype
        made.add((dt.support.dtype, dt.confidence.dtype))
    assert made == set(STORAGE_PAIRS)
    if (sup, col) in made:
        assert storage_codes("x", s, c, c) == (
            [torch.float32, torch.int32, torch.bfloat16].index(sup),
            [torch.float32, torch.bfloat16, torch.int8].index(col))
    else:
        with pytest.raises(TypeError):
            storage_codes("x", s, c, c)


# ----------------------------------------------------------------------
# every op against the reference's ops (Pallas interpret mode)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def chain_pairs():
    """Per quantization: (reference compressed DeviceTrie, port compressed
    DeviceTrie, arrays, queries) over one chain-heavy trie."""
    arrs = JS.synthetic_chain_trie(1200, chain_fraction=0.75, seed=3)
    jf = JS.frozen_from_arrays(arrs)
    tf = _port(jf)
    q, al = JS.mixed_queries(np.random.RandomState(0), arrs, 40, 7)
    return {
        tag: (jf.device_arrays(layout="compressed", **kw),
              tf.device_arrays(device="cpu", layout="compressed", **kw),
              arrs, (q, al))
        for tag, kw in QUANT.items()
    }


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_search_ops_match_reference(chain_pairs, quant):
    jd, td, arrs, (q, al) = chain_pairs[quant]
    _same_dict(TO.rule_search(td, q, al),
               JO.rule_search(jd, jnp.asarray(q), jnp.asarray(al)),
               "rule_search")
    _same_dict(TO.rule_search_batch(td, q, al),
               JO.rule_search_batch(jd, q, al), "rule_search_batch")
    _same_dict(
        TA.batched_rule_search(td, torch.from_numpy(q), torch.from_numpy(al)),
        JA.batched_rule_search(jd, jnp.asarray(q), jnp.asarray(al)),
        "batched_rule_search")


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_rank_ops_match_reference(chain_pairs, quant):
    jd, td, arrs, _ = chain_pairs[quant]
    mid = int(arrs["node_item"][7])
    prefixes = [[], [0], [9999], [0, mid], [-3], [2, 2]]
    for got, want in zip(TO.prefix_ranges(td, prefixes),
                         JO.prefix_ranges(jd, prefixes)):
        _same(got, want, "prefix_ranges")
    for metric in ("lift", "support"):
        _same_dict(TO.top_k_rules_batch(td, prefixes, 9, metric=metric),
                   JO.top_k_rules_batch(jd, prefixes, 9, metric=metric),
                   f"top_k_rules_batch {metric}")
    _same_dict(TO.top_k_rules(td, 5, prefix=[0], metric="lift"),
               JO.top_k_rules(jd, 5, prefix=[0], metric="lift"),
               "top_k_rules")


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_item_ops_and_reduce_match_reference(chain_pairs, quant):
    jd, td, _, _ = chain_pairs[quant]
    items = [0, 1, 2, 3, 9999, 1, -1]
    for role in ROLES:
        _same_dict(TO.rules_with(td, items, role=role, k=6),
                   JO.rules_with(jd, items, role=role, k=6),
                   f"rules_with {role}")
    got, want = TO.trie_reduce(td), JO.trie_reduce(jd)
    oracle_t, oracle_j = TA.traverse_reduce(td), JA.traverse_reduce(jd)
    for key in want:
        for g, w in ((got[key], want[key]), (oracle_t[key], oracle_j[key])):
            assert float(g) == pytest.approx(float(w), rel=1e-6, abs=0)
    for key in ("n_rules", "confidence_max"):
        assert float(got[key]) == float(want[key])
        assert float(oracle_t[key]) == float(oracle_j[key])


def test_reference_root_answer_for_absent_items(chain_pairs):
    """A fault of the reference, pinned (ROADMAP Queue 3): at min_depth=0
    an absent item sanitizes to -1, and on the compressed layout the
    consequent role's self-hit test ``node_item == item`` then finds the
    root (node_item -1), while the plain layout ranks the empty posting
    slice and finds nothing.  The port answers as the reference on both;
    antecedent and any find nothing on either."""
    jd, td, arrs, _ = chain_pairs["f32"]
    jf = JS.frozen_from_arrays(arrs)
    items = [0, 9999, -1]
    for layout, jt, tt in (("compressed", jd, td),
                           ("plain", jf, _port(jf))):
        for role in ROLES:
            want = JO.rules_with(jt, items, role=role, k=3, min_depth=0)
            got = TO.rules_with(tt, items, role=role, k=3, min_depth=0,
                                device="cpu")
            _same_dict(got, want, f"{layout} rules_with {role}")
            absent = np.asarray(want["node"])[1:]
            if layout == "compressed" and role == "consequent":
                np.testing.assert_array_equal(absent, [[0, -1, -1]] * 2)
            else:
                assert (absent == -1).all(), (layout, role)
            assert (np.asarray(want["node"])[0] >= 0).any()


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_use_kernel_false_matches_kernel_path(chain_pairs, quant):
    """The ops' plain-version switch and the kernel wrappers' CPU route
    answer alike on quantized columns."""
    _, td, _, _ = chain_pairs[quant]
    for use_kernel in (True, False):
        a = TO.top_k_rules_batch(td, [[], [1]], 8, metric="leverage",
                                 use_kernel=use_kernel)
        b = TO.rules_with(td, [1, 2], role="consequent", k=8,
                          use_kernel=use_kernel)
        if use_kernel:
            first = (a, b)
        else:
            _same_dict(a, first[0])
            _same_dict(b, first[1])


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_span_plain_version_matches_kernel_and_full_table(chain_pairs,
                                                          quant):
    """The port's bucket-search plain version equals the reference's span
    kernel (interpret mode) and its full-table oracle, con_support and
    DFS positions included."""
    jd, td, _, (q, al) = chain_pairs[quant]
    dq = TO._dequant_statics(td)
    e = TO.edge_metric_arrays(td)
    got = TREF.rule_search_span_ref(
        e["child_offsets"], e["edge_item"], e["edge_pos"], e["edge_span"],
        e["edge_tail"], e["node_item"], e["support"], e["confidence"],
        e["lift"], torch.from_numpy(q), torch.from_numpy(al),
        max_fanout=e["max_fanout"], **dq)
    cols = (jd.support, jd.confidence, jd.lift)
    kernel = rule_search_span_pallas(
        jd.child_offsets, jd.edge_item, jd.edge_child, jd.edge_span,
        jd.edge_tail, jd.node_item, *cols, jnp.asarray(q), jnp.asarray(al),
        max_fanout=jd.max_fanout, interpret=True, **dq)
    oracle = JREF.rule_search_span_ref(
        jd.edge_parent, jd.edge_item, jd.edge_child, jd.edge_span,
        jd.edge_tail, jd.node_item, *cols, jnp.asarray(q), jnp.asarray(al),
        **dq)
    _same_dict(got, kernel, "vs span kernel")
    _same_dict(got, oracle, "vs full-table oracle")


# ----------------------------------------------------------------------
# inside the port: compressed f32 == plain, bounded quantized error
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["chain3000", "branchy", "grocery",
                                   "single_chain", "hand_runs"])
def test_compressed_equals_plain_in_port(tries, shape):
    jf = tries[shape]
    tf = _port(jf)
    plain = tf.device_arrays(device="cpu")
    comp = tf.device_arrays(device="cpu", layout="compressed")
    arrs = {"node_item": np.asarray(jf.node_item),
            "node_parent": np.asarray(jf.node_parent),
            "edge_item": np.asarray(jf.edge_item)}
    q, al = TS.mixed_queries(np.random.RandomState(4), arrs, 90, 8)
    _same_dict(TO.rule_search_batch(comp, q, al),
               TO.rule_search_batch(plain, q, al), "search")
    n_items = int(np.asarray(jf.item_offsets).shape[0]) - 1
    first = int(jf.edge_item[0]) if jf.n_edges else 0
    prefixes = [[], [first], [n_items + 4],
                list(tf.path_items(tf.n_nodes - 1))[:2]]
    for metric in TO.RANK_METRICS:
        _same_dict(TO.top_k_rules_batch(comp, prefixes, 7, metric=metric),
                   TO.top_k_rules_batch(plain, prefixes, 7, metric=metric),
                   f"top_k {metric}")
    items = list(range(min(n_items, 6))) + [n_items + 1, -1]
    for role in ROLES:
        got = TO.rules_with(comp, items, role=role, k=9)
        want = TO.rules_with(plain, items, role=role, k=9)
        # pos is a posting index on the plain consequent route and a DFS
        # position on the compressed one; node and value are the contract
        for key in ("values", "node"):
            _same(got[key], want[key], f"rules_with {role} {key}")
    got, want = TO.trie_reduce(comp), TO.trie_reduce(plain)
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6,
                                                abs=0)


@pytest.mark.parametrize("columns", ["bf16", "int8"])
def test_quantized_search_within_documented_bounds(columns):
    """As the reference's ``test_ops_within_documented_bounds``: structure
    exact, metric values within rtol 2e-2 (bf16) / 6e-2 (int8) of the f32
    plain layout, and the support ranking's winners unchanged."""
    arrs = TS.synthetic_chain_trie(1000, chain_fraction=0.7, seed=0)
    fz = TS.frozen_from_arrays(arrs)
    plain = fz.device_arrays(device="cpu")
    quant = fz.device_arrays(device="cpu", layout="compressed", quantize=True,
                             n_transactions=N_TX, columns=columns)
    q, al = TS.mixed_queries(np.random.RandomState(7), arrs, 24, 7)
    rp, rq = TO.rule_search(plain, q, al), TO.rule_search(quant, q, al)
    _same(rq["found"], rp["found"])
    _same(rq["node"], rp["node"])
    m = rp["found"].numpy()
    rtol = 2e-2 if columns == "bf16" else 6e-2
    for key in ("support", "confidence", "lift"):
        np.testing.assert_allclose(rq[key].numpy()[m], rp[key].numpy()[m],
                                   rtol=rtol, err_msg=key)
    _same(TO.top_k_rules(quant, 5, metric="support")["node"],
          TO.top_k_rules(plain, 5, metric="support")["node"])


# ----------------------------------------------------------------------
# degenerate inputs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("quant", ["f32", "i32+int8"])
def test_empty_and_zero_width_batches(chain_pairs, quant):
    _, td, _, _ = chain_pairs[quant]
    out = TO.rule_search(td, np.zeros((0, 4), np.int32),
                         np.zeros((0,), np.int32))
    assert all(v.shape == (0,) for v in out.values())
    out = TO.rule_search(td, np.zeros((5, 0), np.int32),
                         np.zeros((5,), np.int32))
    assert not out["found"].any() and (out["node"] == -1).all()
    e = TO.edge_metric_arrays(td)
    span = TREF.rule_search_span_ref(
        *[e[k] for k in ("child_offsets", "edge_item", "edge_pos",
                         "edge_span", "edge_tail", "node_item", "support",
                         "confidence", "lift")],
        torch.zeros((3, 0), dtype=torch.int32),
        torch.zeros((3,), dtype=torch.int32))
    assert (span["pos"] == -1).all() and not span["found"].any()
    assert TO.top_k_rules_batch(td, [], 4)["values"].shape == (0, 4)
    assert TO.rules_with(td, [], k=3)["node"].shape == (0, 3)


@pytest.mark.parametrize("quant", ["f32", "i32+bf16"])
def test_single_node_trie(quant):
    """The root-only trie compressed: nothing found, empty rankings, a
    zero reduction, as the reference answers.  Its item table is empty,
    where the reference's ``rules_with`` raises (ROADMAP Queue 3) and the
    port answers empty rows."""
    jf = _root_only()
    jd = jf.device_arrays(layout="compressed", **QUANT[quant])
    td = _port(jf).device_arrays(device="cpu", layout="compressed",
                                 **QUANT[quant])
    q = np.array([[0, 1], [-1, -1]], np.int32)
    al = np.array([1, 0], np.int32)
    _same_dict(TO.rule_search(td, q, al),
               JO.rule_search(jd, jnp.asarray(q), jnp.asarray(al)))
    _same_dict(TO.top_k_rules_batch(td, [[], [0]], 3),
               JO.top_k_rules_batch(jd, [[], [0]], 3))
    for role in ROLES:
        out = TO.rules_with(td, [0, 5], role=role, k=2)
        assert (out["node"] == -1).all() and (out["pos"] == -1).all()
        assert (out["values"] == -torch.inf).all()
    with pytest.raises(IndexError):
        JO.rules_with(jd, [0, 5], k=2)
    got, want = TO.trie_reduce(td), JO.trie_reduce(jd)
    for key in want:
        assert float(got[key]) == float(want[key]) == 0.0


# ----------------------------------------------------------------------
# the reference's core oracle and its compilation context
# ----------------------------------------------------------------------
def test_reference_oracle_widening_depends_on_jit(chain_pairs):
    """Reference fault (ROADMAP Queue 3): ``repro.core.array_trie.
    _dequantized_columns`` writes ``count / f32(n)``.  Its jitted callers
    (``batched_rule_search``, ``traverse_reduce``) compile that to a
    multiply by the f32 reciprocal, and an eager call divides, so the
    reference's oracle answers two ways.  The port multiplies, as every
    kernel and the jitted reference do."""
    jd, td, _, _ = chain_pairs["i32+bf16"]
    eager = np.asarray(JA._dequantized_columns(jd)[0])
    jitted = np.asarray(jax.jit(lambda t: JA._dequantized_columns(t)[0])(jd))
    counts = np.asarray(jd.support)
    inv = np.float32(1.0 / N_TX)
    np.testing.assert_array_equal(jitted, counts.astype(np.float32) * inv)
    np.testing.assert_array_equal(eager, counts.astype(np.float32)
                                  / np.float32(N_TX))
    assert not np.array_equal(eager, jitted)
    _same(TA._dequantized_columns(td)[0], jitted)


@pytest.mark.parametrize("quant", ["f32", "i32+int8"])
def test_compressed_descend_matches_reference(chain_pairs, quant):
    """``compressed_descend`` resolves rows as the reference's does (every
    negative item pads), and with ``pad=-1`` treats another negative item
    as live and absent: the descent ``prefix_ranges`` runs."""
    jd, td, arrs, (q, _) = chain_pairs[quant]
    rows = np.concatenate([q, np.full((4, q.shape[1]), -1, np.int32)])
    rows[-3, 0] = -9
    rows[-2, :2] = [int(arrs["edge_item"][0]), -9]
    jp, jok = JA.compressed_descend(jd, jnp.asarray(rows))
    tp, tok = TA.compressed_descend(td, torch.from_numpy(rows))
    _same(tp, jp, "pos")
    _same(tok, jok, "found")
    sp, sok = TA.compressed_descend(td, torch.from_numpy(rows), pad=-1)
    strict = (rows < -1).any(axis=1)
    assert not _np(sok)[strict].any()
    _same(sp[~torch.from_numpy(strict)], tp[~torch.from_numpy(strict)])
    _same(sok[~torch.from_numpy(strict)], tok[~torch.from_numpy(strict)])


def test_compressed_path_runs_without_jax_or_repro():
    """Compressing, quantizing and every compressed op run with ``jax`` and
    ``repro`` made unimportable."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from repro_torch.core.synthetic import (frozen_from_arrays,\n"
        "    mixed_queries, synthetic_chain_trie)\n"
        "from repro_torch.kernels import ops\n"
        "arrs = synthetic_chain_trie(400, seed=1)\n"
        "fz = frozen_from_arrays(arrs)\n"
        "q, al = mixed_queries(np.random.RandomState(0), arrs, 12, 6)\n"
        "for kw in ({}, {'quantize': True, 'n_transactions': 1000},\n"
        "           {'quantize': True, 'columns': 'int8'}):\n"
        "    dt = fz.device_arrays(device='cpu', layout='auto', **kw)\n"
        "    assert dt.layout == 'compressed'\n"
        "    assert ops.rule_search_batch(dt, q, al)['found'].any()\n"
        "    ops.top_k_rules_batch(dt, [[], [0]], 5)\n"
        "    for role in ('any', 'antecedent', 'consequent'):\n"
        "        ops.rules_with(dt, [0, 1], role=role, k=4)\n"
        "    ops.trie_reduce(dt)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
