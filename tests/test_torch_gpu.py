"""The port's hand-written kernels on the card, each against its plain
PyTorch version, bitwise (the trie_reduce sums to 1e-6 relative), with
its launch counter.  Marked ``gpu``: they skip where no CUDA GPU is
visible.  This module imports neither JAX nor the reference package, so
on a GPU host without JAX it runs alone:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \
        -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.item_index import rules_with_member  # noqa: E402
from repro_torch.kernels.rank import topk_rank_batch  # noqa: E402
from repro_torch.kernels.rule_search import rule_search_fused  # noqa: E402
from repro_torch.kernels.trie_reduce import trie_reduce_columns  # noqa: E402
from repro_torch.serve import TrieQueryEngine  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA and Triton kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small():
    """A 6K-node irregular trie with tie-forced confidences."""
    arrs = TS.random_csr_trie(np.random.RandomState(31), 6000, 30)
    arrs["confidence"] = np.round(arrs["confidence"], 1).astype(np.float32)
    arrs["edge_conf"] = arrs["confidence"][arrs["edge_child"]]
    return arrs, TS.frozen_from_arrays(arrs)


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.fixture(params=[None, 2])
def target_blocks(request, monkeypatch):
    """The default launch shape, and one that packs many tiles into each
    block's chunk (the running top-k path, and for k > 1024 its lists in
    global scratch, that the small trie would not otherwise reach)."""
    from repro_torch.kernels import rank

    if request.param is not None:
        monkeypatch.setattr(rank, "TARGET_BLOCKS", request.param)
    return request.param


def test_rank_kernel(small, cuda, target_blocks):
    _, fz = small
    t = TO.dfs_rank_arrays(fz, device=cuda)
    los, his, _ = TO.prefix_ranges(fz, [[], [1], [2, 5], [77], []],
                                   device=cuda)
    args = (t["support"], t["confidence"], t["lift"], t["depth"], los, his)
    for metric in TO.RANK_METRICS:
        for k in (1, 10, 100, 1100, 5000):
            before = topk_rank_batch.launches
            got = topk_rank_batch(*args, k=k, metric=metric)
            assert topk_rank_batch.launches == before + 1
            _bitwise(got, ref.topk_rank_batch_ref(*args, k=k, metric=metric))


def test_member_kernel(small, cuda, target_blocks):
    _, fz = small
    t = TO.item_rank_arrays(fz, device=cuda)
    plos, phis, qitems = (
        torch.from_numpy(a).to(cuda) for a in TO._posting_slices(
            t["item_offsets"], [0, 4, 29, -1, 4]))
    args = (t["support"], t["confidence"], t["lift"], t["depth"],
            t["node_item"], t["post_lo"], t["post_hi"], plos, phis, qitems)
    for role in TO.ROLES:
        for metric in TO.RANK_METRICS:
            for k in (20, 1100, 5000):
                before = rules_with_member.launches
                got = rules_with_member(*args, k=k, metric=metric, role=role)
                assert rules_with_member.launches == before + 1
                _bitwise(got, ref.rules_with_ref(*args, k=k, metric=metric,
                                                 role=role))


def test_search_and_reduce_kernels(small, cuda):
    arrs, _ = small
    q, al = TS.mixed_queries(np.random.RandomState(4), arrs, 300, 6)
    names = ("child_offsets", "edge_item", "edge_child", "edge_conf",
             "edge_sup", "edge_lift")
    args = [torch.from_numpy(arrs[n]).to(cuda) for n in names] + [
        torch.from_numpy(q).to(cuda), torch.from_numpy(al).to(cuda)]
    before = rule_search_fused.launches
    got = rule_search_fused(*args, max_fanout=arrs["max_fanout"])
    assert rule_search_fused.launches == before + 1
    want = ref.rule_search_fused_ref(*args, max_fanout=arrs["max_fanout"])
    _bitwise([got[k] for k in want], [want[k] for k in want])
    cols = [torch.from_numpy(arrs[n]).to(cuda)
            for n in ("support", "confidence", "node_depth")]
    before = trie_reduce_columns.launches
    got = trie_reduce_columns(*cols)
    assert trie_reduce_columns.launches == before + 1
    want = ref.trie_reduce_ref(*cols)
    _bitwise((got[0], got[2]), (want[0], want[2]))
    for i in (1, 3):
        torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=0)


def test_engine_on_gpu_equals_cpu(small, cuda):
    arrs, fz = small
    gpu, cpu = TrieQueryEngine(fz, device=cuda), \
        TrieQueryEngine(fz, device="cpu")
    q, al = TS.mixed_queries(np.random.RandomState(9), arrs, 200, 6)
    prefixes = [[], [3], [3, 1], [999]]
    outs = [
        (gpu.rule_search_batch(q, al), cpu.rule_search_batch(q, al)),
        (gpu.top_k_rules_batch(prefixes, 25, metric="conviction"),
         cpu.top_k_rules_batch(prefixes, 25, metric="conviction")),
    ]
    for role in TO.ROLES:
        outs.append((gpu.rules_with([0, 7, -1, 7], role=role, k=15),
                     cpu.rules_with([0, 7, -1, 7], role=role, k=15)))
    for g, c in outs:
        _bitwise([g[k].cpu() for k in c], [c[k] for k in c])
    g, c = gpu.trie_reduce(), cpu.trie_reduce()
    assert float(g["n_rules"]) == float(c["n_rules"])
    assert float(g["confidence_max"]) == float(c["confidence_max"])


@pytest.mark.parametrize("n_edges", [0, 1, 40])
def test_tiny_tries_on_gpu_equal_cpu(n_edges, cuda):
    """The root-only trie, a single edge, and a 40-edge trie: empty
    buckets, empty posting lists and k past every range."""
    fz = TS.frozen_from_arrays(TS.synthetic_csr_trie(n_edges, seed=3))
    gpu, cpu = TrieQueryEngine(fz, device=cuda), \
        TrieQueryEngine(fz, device="cpu")
    pairs = [([0], [1]), ([], [0]), ([5], [])]
    prefixes = [[], [0], [7]]
    outs = [(gpu.rule_search_batch(pairs), cpu.rule_search_batch(pairs)),
            (gpu.top_k_rules_batch(prefixes, 50),
             cpu.top_k_rules_batch(prefixes, 50))]
    for role in TO.ROLES:
        outs.append((gpu.rules_with([0, 1, -1], role=role, k=50),
                     cpu.rules_with([0, 1, -1], role=role, k=50)))
    for g, c in outs:
        _bitwise([g[k].cpu() for k in c], [c[k] for k in c])
    g, c = gpu.trie_reduce(), cpu.trie_reduce()
    for key in c:
        assert float(g[key]) == pytest.approx(float(c[key]), rel=1e-6)


def _apriori_levels(db, minsup):
    """Every counting level's candidate matrix of ``apriori(db, minsup)``
    on the kernel path, recorded as apriori makes them (counted on the
    CPU here)."""
    from repro_torch.arm.apriori import apriori

    levels = []
    host_batch = db.support_batch

    def recording(mat, lens=None, **kw):
        levels.append((np.asarray(mat, np.int32), np.asarray(lens, np.int32)))
        return host_batch(mat, lens, **kw)

    db.support_batch = recording
    try:
        apriori(db, minsup, use_kernel=True, device="cpu")
    finally:
        del db.support_batch
    return levels


def _tie_heavy_candidates(rng, n_items, c, k):
    """Rows drawn from a few hot items (many equal counts), with repeated
    items, -1 entries anywhere, rows of no valid item, and lengths <= 0."""
    hot = rng.randint(0, n_items, size=6)
    cand = np.where(rng.rand(c, k) < 0.2, -1,
                    hot[rng.randint(0, 6, size=(c, k))]).astype(np.int32)
    cand[::17] = -1
    lens = rng.randint(-1, k + 1, size=c).astype(np.int32)
    return cand, lens


def test_support_count_kernel(cuda):
    from repro_torch.arm.datasets import grocery_db
    from repro_torch.arm.transactions import TransactionDB
    from repro_torch.kernels.support_count import support_count_bitmap

    db = grocery_db()
    bm = db.device_bitmaps(cuda)
    cases = _apriori_levels(db, 0.005)
    rng = np.random.RandomState(12)
    for k in (1, 3, 40):   # k = 40 walks two 32-item chunks of a row
        cases.append(_tie_heavy_candidates(rng, db.n_items, 3000, k))
    assert len(cases) >= 5
    for mat, lens in cases:
        cand = torch.from_numpy(mat).to(cuda)
        ln = torch.from_numpy(lens).to(cuda)
        before = support_count_bitmap.launches
        got = support_count_bitmap(bm, cand, ln, db.n_transactions)
        assert support_count_bitmap.launches == before + 1
        want = ref.support_count_bitmap_ref(bm, cand, ln, db.n_transactions)
        assert torch.equal(got, want)
        host = db.support_batch(mat, lens)
        np.testing.assert_array_equal(
            np.where(lens > 0, got.cpu().numpy(), db.n_transactions), host)
    # a whole last word (64 transactions) and an empty DB
    for txs, n_items in (([[0, 1], [1]] * 32, 2), ([], 3)):
        small = TransactionDB(txs, n_items)
        mat = np.array([[0, 1], [-1, -1], [1, 1]], np.int32)
        lens = np.array([2, 2, 0], np.int32)
        got = support_count_bitmap(
            small.device_bitmaps(cuda), torch.from_numpy(mat).to(cuda),
            torch.from_numpy(lens).to(cuda), small.n_transactions)
        want = ref.support_count_bitmap_ref(
            small.device_bitmaps("cpu"), torch.from_numpy(mat),
            torch.from_numpy(lens), small.n_transactions)
        assert torch.equal(got.cpu(), want)


def test_build_on_gpu_equals_cpu(cuda):
    """The construction path on the card: 1 launch per counting level and
    1 for the annotation, and the same trie as on the CPU, bitwise."""
    from repro_torch.arm.datasets import grocery_db
    from repro_torch.core.builder import build_trie_of_rules
    from repro_torch.kernels.support_count import support_count_bitmap

    db = grocery_db()
    before = support_count_bitmap.launches
    gpu = build_trie_of_rules(db, 0.005, miner="apriori", engine="arrays",
                              device=cuda)
    levels = len(_apriori_levels(db, 0.005))
    assert support_count_bitmap.launches == before + levels + 1
    cpu = build_trie_of_rules(db, 0.005, miner="apriori", engine="arrays",
                              device="cpu")
    assert gpu.itemsets == cpu.itemsets
    for name in ("node_item", "node_parent", "edge_child", "dfs_order",
                 "item_nodes"):
        np.testing.assert_array_equal(getattr(gpu.frozen, name),
                                      getattr(cpu.frozen, name))
    for name in ("support", "confidence", "lift"):
        np.testing.assert_array_equal(
            getattr(gpu.frozen, name).view(np.int32),
            getattr(cpu.frozen, name).view(np.int32))


# ----------------------------------------------------------------------
# the compressed layout: the span search and the quantized variants
# ----------------------------------------------------------------------
QUANT = {
    "f32": dict(),
    "i32+bf16": dict(quantize=True, n_transactions=100_000),
    "i32+int8": dict(quantize=True, n_transactions=100_000, columns="int8"),
    "bf16": dict(quantize=True),
    "bf16+int8": dict(quantize=True, columns="int8"),
}


@pytest.fixture(scope="module")
def chain():
    """A chain-heavy trie whose branch buckets (48 wide) and root bucket
    (125 wide) are wider than a warp."""
    arrs = TS.synthetic_chain_trie(8000, chain_fraction=0.6, fanout=48,
                                   seed=5)
    return arrs, TS.frozen_from_arrays(arrs)


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_span_search_kernel(chain, cuda, quant):
    from repro_torch.kernels.rule_search import rule_search_span

    arrs, fz = chain
    assert fz.max_fanout > 32
    dt = fz.device_arrays(device=cuda, layout="compressed", **QUANT[quant])
    e = TO.edge_metric_arrays(dt)
    q, al = TS.mixed_queries(np.random.RandomState(6), arrs, 600, 9)
    args = [e[n] for n in ("child_offsets", "edge_item", "edge_pos",
                           "edge_span", "edge_tail", "node_item", "support",
                           "confidence", "lift")]
    args += [torch.from_numpy(q).to(cuda), torch.from_numpy(al).to(cuda)]
    kw = dict(max_fanout=e["max_fanout"], **TO._dequant_statics(e))
    before = rule_search_span.launches
    got = rule_search_span(*args, **kw)
    assert rule_search_span.launches == before + 1
    want = ref.rule_search_span_ref(*args, **kw)
    _bitwise([got[k] for k in want], [want[k] for k in want])
    assert bool(got["found"][0::3].all())


@pytest.mark.parametrize("quant", sorted(QUANT))
def test_quantized_score_and_reduce_kernels(chain, cuda, quant):
    arrs, fz = chain
    dt = fz.device_arrays(device=cuda, layout="compressed", **QUANT[quant])
    dq = TO._dequant_statics(dt)
    t = TO.dfs_rank_arrays(dt)
    assert t["confidence"].data_ptr() == dt.confidence.data_ptr()
    los, his, _ = TO.prefix_ranges(dt, [[], [1], [77], [2, 5]])
    args = (t["support"], t["confidence"], t["lift"], t["depth"], los, his)
    for metric in TO.RANK_METRICS:
        for k in (10, 1100):
            got = topk_rank_batch(*args, k=k, metric=metric, **dq)
            _bitwise(got, ref.topk_rank_batch_ref(*args, k=k, metric=metric,
                                                  **dq))
    ia = TO.item_rank_arrays(dt)
    plos, phis, qitems = (
        torch.from_numpy(a).to(cuda) for a in TO._posting_slices(
            ia["item_offsets"], [0, 4, 29, -1, 4]))
    margs = (ia["support"], ia["confidence"], ia["lift"], ia["depth"],
             ia["node_item"], ia["post_lo"], ia["post_hi"], plos, phis,
             qitems)
    for role in TO.ROLES:
        for metric in ("confidence", "support", "leverage"):
            got = rules_with_member(*margs, k=20, metric=metric, role=role,
                                    **dq)
            _bitwise(got, ref.rules_with_ref(*margs, k=20, metric=metric,
                                             role=role, **dq))
    rq = dict(n_transactions=dq["n_transactions"],
              confidence_scale=dq["confidence_scale"])
    got = trie_reduce_columns(dt.support, dt.confidence, dt.node_depth, **rq)
    want = ref.trie_reduce_ref(dt.support, dt.confidence, dt.node_depth, **rq)
    _bitwise((got[0], got[2]), (want[0], want[2]))
    for i in (1, 3):
        torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=0)


def test_compressed_ops_on_gpu_equal_plain(chain, cuda):
    """Every op on the unquantized compressed trie equals the plain
    layout's on the card, node ids, values and tie order."""
    arrs, fz = chain
    plain = fz.device_arrays(device=cuda)
    comp = fz.device_arrays(device=cuda, layout="compressed")
    q, al = TS.mixed_queries(np.random.RandomState(8), arrs, 300, 9)
    prefixes = [[], [3], [3, 1], [999]]
    outs = [(TO.rule_search_batch(comp, q, al),
             TO.rule_search_batch(plain, q, al)),
            (TO.top_k_rules_batch(comp, prefixes, 25, metric="lift"),
             TO.top_k_rules_batch(plain, prefixes, 25, metric="lift"))]
    for role in TO.ROLES:
        outs.append((TO.rules_with(comp, [0, 7, -1, 7], role=role, k=15),
                     TO.rules_with(plain, [0, 7, -1, 7], role=role, k=15)))
    for c, p in outs:
        keys = [k for k in p if k != "pos"]
        _bitwise([c[k] for k in keys], [p[k] for k in keys])
    c, p = TO.trie_reduce(comp), TO.trie_reduce(plain)
    assert float(c["n_rules"]) == float(p["n_rules"])
    assert float(c["confidence_max"]) == float(p["confidence_max"])
