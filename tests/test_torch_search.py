"""The two descent searches' kernel design (``csrc/rule_search.cu``: a
group of lanes per walk reading a bucket in rounds of 16-byte loads, with
pivot rounds for a wide bucket; a span run of up to a group's items in one
round; the root's bucket staged per block; the two walks of a row apart,
met at the end) in its plain mirrors (``kernels/ref.py``), held to the
plain versions ``ref.rule_search_fused_ref`` / ``ref.rule_search_span_ref``
and to the reference's ``rule_search_fused_pallas`` /
``rule_search_span_pallas`` in interpret mode and its full-table oracles.

Tolerance: none.  Every comparison is bitwise, f32 bits included (the
confidence product runs over the same factors in the same order, and the
quantized columns widen with the same multiply).  The tries: hubs with a
root fanout of 256, 1,000 and 5,000 over a fanout-8 body (one-round,
two-round and looped probes), and chain tries with spans longer than a
group, searched with ``synthetic.edge_case_queries`` (absent items,
interior -1, all -1 rows, duplicate rows, ant_len 0 and ant_len at the
row's end).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import synthetic as JS  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.kernels.rule_search import (  # noqa: E402
    rule_search_fused_pallas, rule_search_span_pallas,
)
from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.core.array_trie import bucket_edge_lookup  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rule_search import (  # noqa: E402
    SEARCH_THREADS, rule_search_fused, rule_search_span,
    search_launch_shape,
)

FUSED = ("child_offsets", "edge_item", "edge_child", "edge_conf",
         "edge_sup", "edge_lift")
SPAN = ("child_offsets", "edge_item", "edge_pos", "edge_span", "edge_tail",
        "node_item", "support", "confidence", "lift")
N_TX = 100_000
QUANT = {
    "f32": dict(),
    "i32+bf16": dict(quantize=True, n_transactions=N_TX),
    "i32+int8": dict(quantize=True, n_transactions=N_TX, columns="int8"),
}
# the shipped group, the widest one, and a narrow one that reaches the
# looped probe and the span run's cap at test sizes
GROUPS = (ref.SEARCH_GROUP, 32, 2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(got, want, what, keys=None):
    for key in keys or want:
        g, w = _np(got[key]), _np(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {key}")


def _edge_columns(arrs):
    ec = arrs["edge_child"]
    return {"child_offsets": arrs["child_offsets"],
            "edge_item": arrs["edge_item"], "edge_child": ec,
            "edge_conf": arrs["confidence"][ec],
            "edge_sup": arrs["support"][ec], "edge_lift": arrs["lift"][ec],
            "edge_parent": arrs["edge_parent"]}


@pytest.fixture(scope="module")
def hubs():
    """Per root fanout: the trie's edge columns and edge-case rows."""
    out = {}
    for fan in (256, 1000, 5000):
        arrs = JS.synthetic_csr_trie(fan + 2000, root_fanout=fan, seed=fan)
        q, al = TS.edge_case_queries(np.random.RandomState(fan), arrs, 84,
                                     6)
        out[fan] = (_edge_columns(arrs), int(arrs["max_fanout"]), q, al)
    return out


@pytest.fixture(scope="module")
def chain_arrs():
    """A chain trie whose runs (41-81 steps) pass a group's width."""
    return JS.synthetic_chain_trie(2500, chain_fraction=0.8, chain_len=80,
                                   seed=9)


@pytest.fixture(scope="module")
def chains(chain_arrs):
    """Per quantization: the reference's and the port's compressed tries,
    and edge-case rows of width 40 (two chunks of 32 columns)."""
    jf = JS.frozen_from_arrays(chain_arrs)
    tf = TS.frozen_from_arrays(chain_arrs)
    q, al = TS.edge_case_queries(np.random.RandomState(5), chain_arrs, 63,
                                 40)
    return {tag: (jf.device_arrays(layout="compressed", **kw),
                  tf.device_arrays(device="cpu", layout="compressed", **kw),
                  q, al)
            for tag, kw in QUANT.items()}


def _span_args(td):
    e = TO.edge_metric_arrays(td)
    return [e[k] for k in SPAN], dict(max_fanout=e["max_fanout"],
                                      **TO._dequant_statics(e))


@pytest.mark.parametrize("group", [32, 16, 8, 2, 1])
def test_group_probe_is_the_binary_search(group):
    """Buckets of 0 to 20,000 sorted distinct items, each probed for
    every item it holds and for absent ones: the first equal index is the
    binary search's answer; a bucket of at most 4G - 3 items takes one
    round, one up to (4G + 1)(4G - 3) at most two (one when the pivots
    leave an empty slice), and a wider one more."""
    rng = np.random.RandomState(group)
    sizes = [0, 1, 4 * group - 3, 4 * group - 2, 4 * group + 5,
             (4 * group + 1) * (4 * group - 3),
             (4 * group + 1) * (4 * group - 3) + 1, 20_000]
    lo = np.cumsum([0] + sizes[:-1])
    items = np.concatenate([np.sort(rng.choice(3 * s + 1, size=s,
                                               replace=False))
                            for s in sizes]).astype(np.int32)
    co = np.append(lo, lo[-1] + sizes[-1]).astype(np.int32)
    ei = torch.from_numpy(items)
    parents, probe = [], []
    for b, s in enumerate(sizes):
        want = items[co[b]:co[b + 1]]
        absent = np.setdiff1d(np.arange(-1, 3 * s + 3), want)[:64]
        for it in np.concatenate([want[::max(1, s // 200)], absent]):
            parents.append(b)
            probe.append(int(it))
    p = torch.tensor(parents)
    it = torch.tensor(probe, dtype=torch.int32)
    co_t = torch.from_numpy(co)
    j, rounds = ref.group_probe_ref(ei, co_t[p], co_t[p + 1], it, group)
    want = bucket_edge_lookup(co_t, ei, max(sizes), p, it)
    np.testing.assert_array_equal(j.numpy(), want.numpy())
    assert bool((j >= 0).any()) and bool((j < 0).any())
    n = (co_t[p + 1] - co_t[p]).long()
    one = n <= 4 * group - 3
    two = ~one & (n <= (4 * group + 1) * (4 * group - 3))
    assert bool((rounds[one] == (n[one] > 0).long()).all())
    assert bool((rounds[two] <= 2).all()) and int(rounds[two].max()) == 2
    assert int(rounds[~one & ~two].max()) >= 3


@pytest.mark.parametrize("fan", [256, 1000, 5000])
@pytest.mark.parametrize("group", GROUPS)
def test_fused_mirror_is_the_plain_version(hubs, fan, group):
    cols, max_fanout, q, al = hubs[fan]
    args = [torch.from_numpy(cols[k]) for k in FUSED] + [
        torch.from_numpy(q), torch.from_numpy(al)]
    want = ref.rule_search_fused_ref(*args, max_fanout)
    for cap in (ref.SEARCH_ROOT_CAP, 0):
        got, rounds = ref.rule_search_fused_group_ref(*args, group=group,
                                                      root_cap=cap)
        _same(got, want, f"fan {fan} group {group} cap {cap}")
        assert rounds.shape == (q.shape[0],) and bool((rounds >= 1).all())
    # the cases are there: found rows, absent ones, all -1 rows
    assert bool(want["found"].any()) and not bool(want["found"].all())
    assert bool((want["con_support"][3::7] == 0).all())


@pytest.mark.parametrize("fan", [256, 1000, 5000])
def test_fused_against_the_reference(hubs, fan):
    """Against the reference's kernel in interpret mode (up to the
    1,000-wide root: its bucket window makes the 5,000-wide one slow
    there) and its full-table oracle."""
    cols, max_fanout, q, al = hubs[fan]
    got, _ = ref.rule_search_fused_group_ref(
        *[torch.from_numpy(cols[k]) for k in FUSED], torch.from_numpy(q),
        torch.from_numpy(al))
    _same(got, rule_search_fused(
        *[torch.from_numpy(cols[k]) for k in FUSED], torch.from_numpy(q),
        torch.from_numpy(al), max_fanout=max_fanout), "wrapper")
    if max_fanout <= 1000:
        kernel = rule_search_fused_pallas(
            *[jnp.asarray(cols[k]) for k in FUSED], jnp.asarray(q),
            jnp.asarray(al), max_fanout=max_fanout, interpret=True)
        _same(got, kernel, "vs the reference kernel")
    oracle = JREF.rule_search_fused_ref(
        *[jnp.asarray(cols[k]) for k in ("edge_parent", *FUSED[1:])],
        jnp.asarray(q), jnp.asarray(al))
    _same(got, oracle, "vs the full-table oracle", keys=list(oracle))


@pytest.mark.parametrize("quant", sorted(QUANT))
@pytest.mark.parametrize("group", GROUPS)
def test_span_mirror_is_the_plain_version(chains, quant, group):
    _, td, q, al = chains[quant]
    args, kw = _span_args(td)
    args += [torch.from_numpy(q), torch.from_numpy(al)]
    want = ref.rule_search_span_ref(*args, **kw)
    kw.pop("max_fanout")
    for cap in (ref.SEARCH_ROOT_CAP, 0):
        got, rounds = ref.rule_search_span_group_ref(*args, group=group,
                                                     root_cap=cap, **kw)
        _same(got, want, f"{quant} group {group} cap {cap}")
    assert bool(want["found"].any()) and not bool(want["found"].all())


def test_span_runs_take_one_round_each(chains, chain_arrs):
    """A walk down runs longer than a group: a round per group of items
    inside a run, so a narrower group takes more rounds."""
    _, td, _, _ = chains["f32"]
    args, kw = _span_args(td)
    kw.pop("max_fanout")
    nid = int(np.argmax(chain_arrs["node_depth"]))
    path = []
    while nid > 0:
        path.append(int(chain_arrs["node_item"][nid]))
        nid = int(chain_arrs["node_parent"][nid])
    assert len(path) >= 40
    q = torch.tensor([path[::-1][:40]], dtype=torch.int32)
    al = torch.zeros((1,), dtype=torch.int32)
    rounds = {}
    for group in (32, 8, 2):
        out, r = ref.rule_search_span_group_ref(*args, q, al, group=group,
                                                **kw)
        assert bool(out["found"][0])
        rounds[group] = int(r[0])
    assert rounds[32] < rounds[8] < rounds[2]


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_span_against_the_reference(chains, quant):
    """Against the reference's full-table oracle, and its kernel in
    interpret mode on the rows' first 12 columns (its compile time grows
    with the width)."""
    jd, td, q, al = chains[quant]
    args, kw = _span_args(td)
    dq = TO._dequant_statics(td)
    got, _ = ref.rule_search_span_group_ref(
        *args, torch.from_numpy(q), torch.from_numpy(al), **dq)
    _same(got, rule_search_span(*args, torch.from_numpy(q),
                                torch.from_numpy(al), **kw), "wrapper")
    cols = (jd.support, jd.confidence, jd.lift)
    narrow, _ = ref.rule_search_span_group_ref(
        *args, torch.from_numpy(q[:, :12]), torch.from_numpy(al), **dq)
    kernel = rule_search_span_pallas(
        jd.child_offsets, jd.edge_item, jd.edge_child, jd.edge_span,
        jd.edge_tail, jd.node_item, *cols, jnp.asarray(q[:, :12]),
        jnp.asarray(al), max_fanout=jd.max_fanout, interpret=True, **dq)
    _same(narrow, kernel, "vs the reference kernel")
    oracle = JREF.rule_search_span_ref(
        jd.edge_parent, jd.edge_item, jd.edge_child, jd.edge_span,
        jd.edge_tail, jd.node_item, *cols, jnp.asarray(q), jnp.asarray(al),
        **dq)
    _same(got, oracle, "vs the full-table oracle")


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_root_answers_on_the_compressed_layout(chains, quant):
    """The rows that end at the root: all padding, an absent item, and a
    row with no consequent.  Not found, position -1, and consequent-path
    support 0 where the consequent walk stays at the root, as the
    reference's search ops answer."""
    jd, td, _, _ = chains[quant]
    n_items = int(td.edge_item.max()) + 1
    first = int(td.node_item[1])
    q = np.array([[-1, -1, -1], [n_items + 5, -1, -1], [first, -1, -1],
                  [-1, first, -1], [first, n_items + 5, -1]], np.int32)
    al = np.array([0, 0, 1, 3, 0], np.int32)
    args, kw = _span_args(td)
    dq = TO._dequant_statics(td)
    got, _ = ref.rule_search_span_group_ref(
        *args, torch.from_numpy(q), torch.from_numpy(al), **dq)
    np.testing.assert_array_equal(got["found"].numpy(),
                                  [False, False, True, True, False])
    np.testing.assert_array_equal(got["pos"].numpy()[[0, 1, 4]], -1)
    np.testing.assert_array_equal(got["con_support"].numpy()[[0, 2, 3]], 0)
    _same(TO.rule_search_batch(td, q, al), JO.rule_search_batch(jd, q, al),
          "rule_search_batch")


def test_launch_shape():
    """Two walks a row of SEARCH_GROUP lanes each: a block holds
    SEARCH_THREADS / (2 SEARCH_GROUP) rows, and the query path's 4096 rows
    take one wave of the H100's 132 SMs at 2048 threads an SM."""
    shape = search_launch_shape(4096)
    assert shape["threads"] == SEARCH_THREADS
    assert shape["rows"] * 2 * ref.SEARCH_GROUP == SEARCH_THREADS
    assert shape["blocks"] * shape["rows"] >= 4096
    assert (shape["blocks"] - 1) * shape["rows"] < 4096
    assert shape["blocks"] * SEARCH_THREADS <= 132 * 2048
    assert search_launch_shape(1)["blocks"] == 1
    assert search_launch_shape(0)["blocks"] == 0
