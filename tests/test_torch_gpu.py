"""The port's hand-written kernels on the card, each against its plain
PyTorch version, bitwise (the trie_reduce sums to 1e-6 relative, and
bitwise against the plain mirror of the kernel's order), with its launch
counter.  Marked ``gpu``: they skip where no CUDA GPU is
visible.  This module imports neither JAX nor the reference package, so
on a GPU host without JAX it runs alone:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \
        -m gpu tests/test_torch_gpu.py
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.item_index import rules_with_member  # noqa: E402
from repro_torch.kernels.rank import topk_rank_batch  # noqa: E402
from repro_torch.kernels.rule_search import rule_search_fused  # noqa: E402
from repro_torch.kernels.trie_reduce import (  # noqa: E402
    launch_shape, trie_reduce_columns, trie_reduce_stats,
    vector_head, vector_nodes,
)
from repro_torch.serve import TrieQueryEngine  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have "
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


@pytest.fixture(params=[None, 2, "split"])
def rank_blocks(request, monkeypatch):
    """The rank kernel's launch shapes: the default plan, few blocks with
    many tiles each (the running top-k path, and for k > 1024 its lists in
    global scratch, that the small trie would not otherwise reach), and
    one block per tile (many blocks a range, whose lists its last block
    merges)."""
    from repro_torch.kernels import rank

    if request.param == 2:
        monkeypatch.setattr(rank, "WORK_BLOCKS", 2)
    elif request.param == "split":
        monkeypatch.setattr(rank, "WORK_BLOCKS", 1 << 16)
        monkeypatch.setattr(rank, "MIN_TILES", 1)
    return request.param


@pytest.fixture(params=[None, 2, "split"])
def member_blocks(request, monkeypatch):
    """The membership kernel's launch shapes: the default plan, few
    blocks with many tiles each, and one block per tile of candidates
    (many blocks a query, whose lists its last block merges)."""
    from repro_torch.kernels import item_index, rank

    if request.param == 2:
        monkeypatch.setattr(rank, "WORK_BLOCKS", 2)
    elif request.param == "split":
        monkeypatch.setattr(rank, "WORK_BLOCKS", 1 << 16)
        monkeypatch.setattr(item_index, "MIN_TILES", 1)
    return request.param


def test_rank_kernel(small, cuda, rank_blocks):
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


@pytest.fixture(scope="module")
def wide():
    """A 2^15-edge hub trie (33 tiles of 1024 positions): enough full
    tiles that whole-trie and depth-1 ranges are seeded at small k."""
    return TS.frozen_from_arrays(TS.synthetic_csr_trie(1 << 15, seed=2))


def test_rank_kernel_duplicate_and_nested_ranges(wide, cuda, rank_blocks):
    """Duplicate, nested, empty and out-of-bounds ranges, ranges inside
    one tile and ranges of exactly k full tiles, on plain and tie-heavy
    columns: every row equals the plain version's bitwise, a duplicate's
    row equals its first copy's, and the call is one launch."""
    t = TO.dfs_rank_arrays(wide, device=cuda)
    n = t["support"].shape[0]
    los, his, _ = TO.prefix_ranges(wide, [[], [1], [2, 5], [1], [], [77]],
                                   device=cuda)
    extra = torch.tensor(
        [[0, n], [3, 1027], [1024, 4096], [1000, 4120], [2048, 2050],
         [5, 5], [-9, 3000], [n - 700, n + 50], [n + 1, n + 9],
         [1024, 4096], [0, n]], dtype=torch.int32, device=cuda)
    los = torch.cat([los, extra[:, 0]])
    his = torch.cat([his, extra[:, 1]])
    plain = [t["support"], t["confidence"], t["lift"]]
    for cols in (plain, [torch.round(c * 10) / 10 for c in plain]):
        args = (*cols, t["depth"], los, his)
        for metric in ("confidence", "lift", "leverage"):
            for k in (1, 3, 10, 100, 1100, 5000):
                before = topk_rank_batch.launches
                got = topk_rank_batch(*args, k=k, metric=metric)
                assert topk_rank_batch.launches == before + 1
                _bitwise(got, ref.topk_rank_batch_ref(*args, k=k,
                                                      metric=metric))
                for a, b in ((0, 4), (0, 6), (6, 16), (1, 3), (8, 15),
                             (11, 14)):
                    _bitwise((got[0][b], got[1][b]), (got[0][a], got[1][a]))


def test_member_kernel(small, cuda, member_blocks):
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


MEMBER_TRIES = {
    "hub": lambda: TS.synthetic_csr_trie(1 << 14, seed=0),
    "chain": lambda: TS.synthetic_chain_trie(6000, chain_fraction=0.75,
                                             seed=3),
}
MEMBER_LAYOUTS = {
    "plain": None,
    "f32": dict(layout="compressed"),
    "i32+bf16": dict(layout="compressed", quantize=True,
                     n_transactions=100_000),
    "i32+int8": dict(layout="compressed", quantize=True,
                     n_transactions=100_000, columns="int8"),
}


@pytest.fixture(scope="module")
def member_tries():
    """A small hub trie and a small chain trie (nested postings: an item
    repeats along some paths)."""
    return {name: TS.frozen_from_arrays(make())
            for name, make in MEMBER_TRIES.items()}


@pytest.mark.parametrize("layout", sorted(MEMBER_LAYOUTS))
@pytest.mark.parametrize("trie", sorted(MEMBER_TRIES))
def test_member_kernel_every_role(member_tries, cuda, trie, layout,
                                  member_blocks):
    """Every role, k in {1, 10, 1500} (1500: the chunk lists in global
    scratch), min_depth in {0, 1}; the longest posting list, absent and
    duplicate items, and the item -1 whose consequent row holds the root
    at min_depth 0, as the reference's self-hit test finds it."""
    fz = member_tries[trie]
    kw = MEMBER_LAYOUTS[layout]
    dt = fz.device_arrays(device=cuda, **(kw or {}))
    ia = TO.item_rank_arrays(dt)
    dq = TO._dequant_statics(ia)
    offsets = ia["item_offsets"]
    longest = int(np.argmax(np.diff(offsets)))
    items = [0, 1, longest, 5, offsets.shape[0] + 3, -1, longest, 2]
    plos, phis, qitems = (torch.from_numpy(a).to(cuda)
                          for a in TO._posting_slices(offsets, items))
    args = (ia["support"], ia["confidence"], ia["lift"], ia["depth"],
            ia["node_item"], ia["post_lo"], ia["post_hi"], plos, phis,
            qitems)
    for role in TO.ROLES:
        for k in (1, 10, 1500):
            for min_depth in (0, 1):
                mk = dict(k=k, metric="confidence", min_depth=min_depth,
                          role=role, **dq)
                before = rules_with_member.launches
                got = rules_with_member(*args, **mk)
                assert rules_with_member.launches == before + 1
                _bitwise(got, ref.rules_with_ref(*args, **mk))
                root = got[1][5, 0].item()
                if role == "consequent" and min_depth == 0:
                    assert root == 0 and (got[1][5, 1:] == -1).all()
                else:
                    assert not (got[1][4:6] >= 0).any()


def _hub_edges(fan, seed):
    """A hub trie with a ``fan``-wide root over a fanout-8 body, with its
    edge-gathered metric columns."""
    arrs = TS.synthetic_csr_trie(fan + 3000, root_fanout=fan, seed=seed)
    ec = arrs["edge_child"]
    for col, name in (("confidence", "edge_conf"), ("support", "edge_sup"),
                      ("lift", "edge_lift")):
        arrs[name] = arrs[col][ec]
    return arrs


def test_search_and_reduce_kernels(small, cuda):
    arrs, _ = small
    q, al = TS.mixed_queries(np.random.RandomState(4), arrs, 300, 6)
    names = ("child_offsets", "edge_item", "edge_child", "edge_conf",
             "edge_sup", "edge_lift")
    # the irregular trie, then hubs whose roots take one, two and three
    # probe rounds (and the staged root, or not), with the edge cases:
    # absent items, interior -1, all -1 and duplicate rows, ant_len 0 and
    # at the row's end, rows wider than a walk's group of lanes
    cases = [(arrs, q, al)]
    for fan in (256, 1000, 5000):
        hub = _hub_edges(fan, fan)
        for width in (6, 40):
            cases.append((hub, *TS.edge_case_queries(
                np.random.RandomState(fan + width), hub, 301, width)))
    for tr, q, al in cases:
        args = [torch.from_numpy(tr[n]).to(cuda) for n in names] + [
            torch.from_numpy(q).to(cuda), torch.from_numpy(al).to(cuda)]
        before = rule_search_fused.launches
        got = rule_search_fused(*args, max_fanout=tr["max_fanout"])
        assert rule_search_fused.launches == before + 1
        want = ref.rule_search_fused_ref(*args, max_fanout=tr["max_fanout"])
        _bitwise([got[k] for k in want], [want[k] for k in want])
        assert bool(want["found"].any())
    cols = [torch.from_numpy(arrs[n]).to(cuda)
            for n in ("support", "confidence", "node_depth")]
    before = trie_reduce_columns.launches
    _check_reduce(cols)
    assert trie_reduce_columns.launches == before + 2


def _check_reduce(cols, **rq):
    """The reduction kernel on ``cols``: all five outputs bitwise its
    mirror ``ref.trie_reduce_split_ref`` at the launch's geometry and a
    repeated call, count and max bitwise the plain version (NaN where
    NaN), sums within 1e-6 relative, the mean bitwise the sums' own
    ``conf_sum / n.clamp(min=1.0)``."""
    got = trie_reduce_stats(*cols, **rq)
    head = vector_head(*cols)[0]
    shape = launch_shape(cols[0].shape[0], vector_nodes(cols[1].dtype), head,
                         _build.sm_count(cols[0].device))
    mirror = ref.trie_reduce_split_ref(*cols, **rq, blocks=shape["blocks"],
                                       threads=shape["threads"],
                                       unroll=shape["unroll"],
                                       head=head)
    _bitwise(got, mirror)
    _bitwise(trie_reduce_stats(*cols, **rq), got)
    want = ref.trie_reduce_ref(*cols, **rq)
    _bitwise((got[0],), (want[0],))
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)) \
        or bool(got[2].isnan() & want[2].isnan())
    for i in (1, 3):
        torch.testing.assert_close(got[i], want[i], rtol=1e-6, atol=0,
                                   equal_nan=True)
    _bitwise((got[4],), (got[3] / got[0].clamp(min=1.0),))
    return got


def test_reduce_kernel_views_sizes_and_values(cuda):
    """Views at storage offsets (a head, and offsets with no common
    aligned node), tries shorter than a vector, every storage pair, dead
    tries and NaN, inf and signed-zero confidences."""
    rng = np.random.RandomState(12)
    pairs = ((torch.float32, torch.float32), (torch.int32, torch.bfloat16),
             (torch.int32, torch.int8), (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.int8))
    for st, ct in pairs:
        rq = dict(n_transactions=1000, confidence_scale=0.0078125)
        for n in (1, 3, 15, 16, 17, 4095, 4097, 300_001):
            m = n + 3
            sup = (torch.from_numpy(rng.randint(0, 1000, m).astype(np.int32))
                   if st == torch.int32 else
                   torch.from_numpy(rng.rand(m).astype(np.float32)).to(st))
            conf = (torch.from_numpy(rng.randint(0, 128, m).astype(np.int8))
                    if ct == torch.int8 else
                    torch.from_numpy(rng.rand(m).astype(np.float32)).to(ct))
            depth = torch.from_numpy(rng.randint(-1, 6, m).astype(np.int32))
            sup, conf, depth = sup.to(cuda), conf.to(cuda), depth.to(cuda)
            for off in ((0, 0, 0), (1, 1, 1), (3, 3, 3), (1, 0, 2)):
                cols = [c[o:o + n] for c, o in zip((sup, conf, depth), off)]
                _check_reduce(cols, **rq)
                _check_reduce([cols[0], cols[1], torch.zeros_like(cols[2])],
                              **rq)
    n = 5000
    sup = torch.rand(n, device=cuda)
    depth = torch.randint(-1, 4, (n,), device=cuda, dtype=torch.int32)
    for case in ("nan", "inf", "-0", "+0 among -0"):
        conf = torch.rand(n, device=cuda)
        if case in ("nan", "inf"):
            conf[::97] = float(case)
        else:
            conf[:] = -0.0
        if case == "+0 among -0":
            conf[4000] = 0.0
            depth[4000] = 1
        got = _check_reduce([sup, conf, depth])
        if case.startswith("+0"):
            assert not bool(torch.signbit(got[2]))
        elif case == "-0":
            assert bool(torch.signbit(got[2])) and float(got[2]) == 0.0


def test_reduce_kernel_is_one_launch(cuda):
    """One launch of one kernel a call (its scratch zeroed once a stream);
    the same bits on another stream."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    arrs = TS.synthetic_csr_trie(100_000, seed=2)
    cols = [torch.from_numpy(arrs[n]).to(cuda)
            for n in ("support", "confidence", "node_depth")]
    first = trie_reduce_stats(*cols)
    torch.cuda.synchronize()
    before = trie_reduce_columns.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trie_reduce_columns(*cols)
        torch.cuda.synchronize()
    assert trie_reduce_columns.launches == before + 1
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "trie_reduce_kernel" in names[0], names
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = trie_reduce_stats(*cols)
    side.synchronize()
    _bitwise(other, first)


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
    _reduce_op_as_before(gpu.dt, g)


def _serve(fz, device, wl):
    """Drain ``wl`` through the scheduler over an engine on ``device``,
    with one injected transient failure, on a virtual clock."""
    from repro_torch.serve import (FaultInjector, FaultyEngine,
                                   ResilientTrieEngine, TrieScheduler,
                                   VirtualClock)

    clock = VirtualClock()
    inj = FaultInjector().fail_transient(2)
    sched = TrieScheduler(ResilientTrieEngine(FaultyEngine(
        TrieQueryEngine(fz, device=device), inj, clock=clock)),
        clock=clock, max_batch=16)
    for w in wl:
        sched.submit(w["op"], w["payload"], w["kwargs"], tenant=w["tenant"])
    return sched.drain(), sched


def test_scheduler_on_gpu_equals_cpu(small, cuda):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import zipfian_workload

    _, fz = small
    wl = zipfian_workload(fz, 200, seed=4)
    reset_launch_counts()
    gpu, gs = _serve(fz, cuda, wl)
    launched = launch_counts()
    cpu, cs = _serve(fz, "cpu", wl)
    assert gs.stats == cs.stats and gs.stats["ok"] == len(wl)
    assert gs.stats["retries"] == 1
    for name in ("topk_rank_batch", "rule_search_fused",
                 "rules_with_member"):
        assert launched[name] > 0, name
    for g, c in zip(gpu, cpu):
        assert (g.id, g.status, g.backend, g.cache_hit, g.retries) == \
            (c.id, c.status, c.backend, c.cache_hit, c.retries)
        assert set(g.result) == set(c.result)
        for key in c.result:
            gv, cv = np.asarray(g.result[key]), np.asarray(c.result[key])
            assert gv.dtype == cv.dtype and gv.tobytes() == cv.tobytes()


def _reduce_op_as_before(dt, got):
    """``ops.trie_reduce`` on the card as it was before the kernel wrote
    the mean: its four values from the four-output wrapper, the mean as
    ``conf_sum / n.clamp(min=1.0)``, bitwise."""
    n, sup_sum, conf_max, conf_sum = trie_reduce_columns(
        dt.support, dt.confidence, dt.node_depth,
        **{k: v for k, v in TO._dequant_statics(dt).items()
           if k != "lift_scale"})
    _bitwise([got[k] for k in ("n_rules", "support_sum", "confidence_max",
                               "mean_conf")],
             [n, sup_sum, conf_max, conf_sum / n.clamp(min=1.0)])


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
    _reduce_op_as_before(gpu.dt, g)


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
    _support_count_shapes(cuda)


def _check_support(cuda, db, mat, lens, staged=None):
    """One call on the card == the plain version == the host sweep, one
    launch counted, and the launch staged or not as ``staged`` says."""
    sc = importlib.import_module("repro_torch.kernels.support_count")
    cand = torch.from_numpy(mat).to(cuda)
    ln = torch.from_numpy(lens).to(cuda)
    bm = db.device_bitmaps(cuda)
    if staged is not None:
        top, d, _, _ = ref.support_slots_ref(torch.from_numpy(mat),
                                             db.n_items)
        shape = sc.launch_shape(d, db.n_words, db.n_items, len(mat),
                                _build.sm_count(torch.cuda.current_device()))
        assert shape["staged"] is staged
    before = sc.support_count_bitmap.launches
    got = sc.support_count_bitmap(bm, cand, ln, db.n_transactions)
    assert sc.support_count_bitmap.launches == before + 1
    assert torch.equal(got, ref.support_count_bitmap_ref(
        bm, cand, ln, db.n_transactions))
    host = db.support_batch(mat, lens)
    np.testing.assert_array_equal(
        np.where(lens > 0, got.cpu().numpy(), db.n_transactions), host)


def _support_count_shapes(cuda):
    """The tile plan's edges on the card: the pre-pass's (largest id, D)
    read and range error, a launch past the staging limit (the unstaged
    variant), W not a multiple of the tile, and a single-word DB."""
    from repro_torch.arm.transactions import TransactionDB

    sc = importlib.import_module("repro_torch.kernels.support_count")
    rng = np.random.RandomState(19)
    # the pre-pass on the card == its plain mirror
    txs = [sorted(set(rng.randint(0, 300, size=12).tolist()))
           for _ in range(1100)]
    db = TransactionDB(txs, 300)
    mat, lens = _tie_heavy_candidates(rng, 300, 2000, 5)
    mat[:40, 0] = rng.randint(0, 300, size=40)
    top, d, bits, _ = sc._distinct_items(torch.from_numpy(mat).to(cuda), 300)
    w_top, w_d, _, w_slot_item = ref.support_slots_ref(
        torch.from_numpy(mat), 300)
    assert (top, d) == (w_top, w_d)
    named = torch.zeros(320, dtype=torch.bool)
    named[w_slot_item.long()] = True
    want = (named.view(10, 32).long() << torch.arange(32)).sum(1)
    assert torch.equal(bits.cpu().long() & 0xFFFFFFFF, want)
    # an id >= I: ValueError before the main launch, none counted
    bad = mat.copy()
    bad[7, 2] = 300
    before = sc.support_count_bitmap.launches
    with pytest.raises(ValueError, match="item 300 out of range"):
        sc.support_count_bitmap(
            db.device_bitmaps(cuda), torch.from_numpy(bad).to(cuda),
            torch.from_numpy(lens).to(cuda), db.n_transactions)
    assert sc.support_count_bitmap.launches == before
    # W = 35 (1100 transactions): a whole tile of 32 words and a partial
    # one; W = 32, one whole tile; W = 22 < BW; a single word
    _check_support(cuda, db, mat, lens, staged=True)
    for n_tx in (1000, 700, 20):
        small = TransactionDB(txs[:n_tx], 300)
        _check_support(cuda, small, mat, lens, staged=True)
    # past the staging limit: every one of limit + 90 items named
    n_items = 12_000
    assert sc.staging_limit(n_items) < n_items
    hot = rng.choice(n_items, size=30, replace=False)
    txs = [sorted(set(hot[rng.rand(30) < 0.5].tolist())
                  | set(rng.randint(0, n_items, size=40).tolist()))
           for _ in range(300)]
    big = TransactionDB(txs, n_items)
    mat = np.full((n_items + 500, 3), -1, np.int32)
    mat[:n_items, 0] = rng.permutation(n_items)
    mat[n_items:, 0] = rng.randint(0, n_items, size=500)
    mat[:, 1] = hot[rng.randint(0, 30, size=len(mat))]
    mat[::3, 2] = mat[::3, 1]      # a repeated item
    mat[1::5, 1] = -1              # a -1 ahead of a valid item
    lens = (mat >= 0).sum(axis=1).astype(np.int32)
    lens[::11] = 0
    _check_support(cuda, big, mat, lens, staged=False)


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
    # runs longer than a walk's group of lanes, rows wider than it, a hub
    # root too wide to stage, and the edge cases of the search rows
    long_runs = TS.synthetic_chain_trie(6000, chain_fraction=0.8,
                                        chain_len=80, seed=9)
    for tr in (long_runs, _hub_edges(5000, 7)):
        dt = TS.frozen_from_arrays(tr).device_arrays(
            device=cuda, layout="compressed", **QUANT[quant])
        e = TO.edge_metric_arrays(dt)
        kw = dict(max_fanout=e["max_fanout"], **TO._dequant_statics(e))
        for width in (9, 40):
            q, al = TS.edge_case_queries(np.random.RandomState(width), tr,
                                         301, width)
            args = [e[n] for n in ("child_offsets", "edge_item", "edge_pos",
                                   "edge_span", "edge_tail", "node_item",
                                   "support", "confidence", "lift")]
            args += [torch.from_numpy(q).to(cuda),
                     torch.from_numpy(al).to(cuda)]
            before = rule_search_span.launches
            got = rule_search_span(*args, **kw)
            assert rule_search_span.launches == before + 1
            want = ref.rule_search_span_ref(*args, **kw)
            _bitwise([got[k] for k in want], [want[k] for k in want])
            assert bool(want["found"].any())


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
    got = _check_reduce([dt.support, dt.confidence, dt.node_depth], **rq)
    op = TO.trie_reduce(dt)
    _bitwise([op[k] for k in ("n_rules", "support_sum", "confidence_max",
                              "mean_conf")], [got[i] for i in (0, 1, 2, 4)])


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
    _reduce_op_as_before(comp, c)
    _reduce_op_as_before(plain, p)


# ----------------------------------------------------------------------
# the seed layout (no CSR offsets): the full-sweep search
# ----------------------------------------------------------------------
SWEEP_COLS = ("edge_parent", "edge_item", "edge_child", "edge_conf",
              "edge_sup", "edge_lift")


def _with_duplicate_pairs(arrs, rng, count):
    """The edge columns with ``count`` extra edges that repeat existing
    (parent, item) pairs, with other children and metrics."""
    cols = {n: arrs[n].copy() for n in SWEEP_COLS}
    pick = rng.randint(0, cols["edge_parent"].shape[0], size=count)
    n = arrs["node_item"].shape[0]
    extra = {
        "edge_parent": cols["edge_parent"][pick],
        "edge_item": cols["edge_item"][pick],
        "edge_child": rng.randint(-2, n, size=count).astype(np.int32),
        "edge_conf": rng.rand(count).astype(np.float32),
        "edge_sup": rng.rand(count).astype(np.float32),
        "edge_lift": (3 * rng.rand(count)).astype(np.float32),
    }
    return {k: np.concatenate([cols[k], extra[k]]) for k in SWEEP_COLS}


@pytest.mark.parametrize("n_rows", [1, 31, 33, 3000])
def test_sweep_kernel(small, cuda, n_rows):
    """Ragged row tiles (1, 31, 33 rows), thousands of rows, an edge
    count that is no multiple of the staged chunk, and repeated (parent,
    item) pairs."""
    from repro_torch.kernels.rule_search import rule_search_sweep

    arrs, _ = small
    rng = np.random.RandomState(n_rows)
    for cols in ({n: arrs[n] for n in SWEEP_COLS},
                 _with_duplicate_pairs(arrs, rng, 700)):
        q, al = TS.mixed_queries(rng, arrs, n_rows, 7)
        args = [torch.from_numpy(cols[n]).to(cuda) for n in SWEEP_COLS]
        args += [torch.from_numpy(q).to(cuda), torch.from_numpy(al).to(cuda)]
        before = rule_search_sweep.launches
        got = rule_search_sweep(*args)
        assert rule_search_sweep.launches == before + 1
        want = ref.rule_search_sweep_ref(*args)
        _bitwise([got[k] for k in want], [want[k] for k in want])
        cpu = ref.rule_search_sweep_ref(*[a.cpu() for a in args])
        _bitwise([got[k].cpu() for k in cpu], [cpu[k] for k in cpu])


K_FP = 0x9E3779B1   # rule_search.cu::sweep_fp's multiplier


def _sweep_case(arrs, case, rng):
    """``(edge columns, queries, ant_len)`` of an edge case of the sweep
    kernel on the small trie."""
    cols = {n: arrs[n].copy() for n in SWEEP_COLS}
    q, al = TS.mixed_queries(rng, arrs, 600, 7)
    if case == "nan":
        # NaN of either sign, -0.0 and negative metrics, and repeated
        # pairs that mix them in one match set
        cols = _with_duplicate_pairs(arrs, rng, 700)
        nan = np.float32(np.nan)
        for name in ("edge_conf", "edge_sup", "edge_lift"):
            c = cols[name]
            pick = rng.randint(0, 5, size=c.shape[0])
            c[pick == 0] = nan
            c[pick == 1] = -nan
            c[pick == 2] = np.float32(-0.0)
            c[pick == 3] = -c[pick == 3]
    elif case == "consequent":
        # the antecedent blanked (ant_len 0), and a -1 gap in every third
        # row
        pos = np.arange(q.shape[1])[None, :]
        q = np.where(pos >= al[:, None], q, -1).astype(np.int32)
        q[::3, 1:] = np.concatenate(
            [np.full((q[::3].shape[0], 1), -1, np.int32), q[::3, 1:-1]], 1)
        al = np.zeros_like(al)
    elif case == "junk":
        q = np.where(q >= 0, q + 10_000, -1).astype(np.int32)
    elif case == "many_splits":
        # three rows: one tile, the table split over dozens of warps
        q, al = q[:3], al[:3]
    elif case == "one_split":
        # a table under one chunk: each tile in one warp
        cols = {n: c[:100] for n, c in cols.items()}
    elif case == "collision":
        # every 5th edge (p, i) gets a twin (p + 1, i - K_FP mod 2^32)
        # with its fingerprint: rows at p with item i hit both
        # fingerprints and must match only the real pair
        pick = np.arange(0, cols["edge_parent"].shape[0], 5)
        twin = {n: c[pick].copy() for n, c in cols.items()}
        twin["edge_parent"] = twin["edge_parent"] + 1
        twin["edge_item"] = ((twin["edge_item"].astype(np.int64) - K_FP)
                             % 2**32).astype(np.uint32).view(np.int32)
        cols = {n: np.concatenate([cols[n], twin[n]]) for n in SWEEP_COLS}
    return cols, q, al


@pytest.mark.parametrize("case", ["nan", "consequent", "junk",
                                  "many_splits", "one_split", "collision"])
def test_sweep_kernel_cases(small, cuda, case):
    """The sweep kernel's edge cases, bitwise against the plain version
    on the card (and on the CPU, but for the bits of a NaN confidence:
    the card's f32 product gives its own canonical NaN there)."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.rule_search import (
        rule_search_sweep, sweep_launch_shape,
    )

    arrs, _ = small
    cols, q, al = _sweep_case(arrs, case, np.random.RandomState(7))
    args = [torch.from_numpy(cols[n]).to(cuda) for n in SWEEP_COLS]
    args += [torch.from_numpy(q).to(cuda), torch.from_numpy(al).to(cuda)]
    shape = sweep_launch_shape(q.shape[0], q.shape[1], args[0].shape[0],
                               sm_count(torch.cuda.current_device()))
    active0 = int((args[-2][:, 0] >= 0).sum())
    plan = ref.sweep_plan_ref(active0, shape["n_chunks"], shape["warps"])
    if case == "many_splits":
        assert 0 < plan["per"] < shape["n_chunks"] // 8
    if case == "one_split":
        assert shape["n_chunks"] == 1
    before = rule_search_sweep.launches
    got = rule_search_sweep(*args)
    assert rule_search_sweep.launches == before + 1
    want = ref.rule_search_sweep_ref(*args)
    _bitwise([got[k] for k in want], [want[k] for k in want])
    cpu = ref.rule_search_sweep_ref(*[a.cpu() for a in args])
    keys = [k for k in cpu if case != "nan" or k != "confidence"]
    _bitwise([got[k].cpu() for k in keys], [cpu[k] for k in keys])
    if case not in ("junk",):
        assert bool(got["found"].any())


def test_sweep_kernel_guards(small, cuda):
    from repro_torch.kernels.rule_search import rule_search_sweep

    arrs, _ = small
    args = [torch.from_numpy(arrs[n]).to(cuda) for n in SWEEP_COLS]
    q = torch.full((5, 4), -1, dtype=torch.int32, device=cuda)
    al = torch.zeros((5,), dtype=torch.int32, device=cuda)
    before = rule_search_sweep.launches
    for cols, rows, lens in ((args, q, al), ([a[:0] for a in args], q, al),
                             (args, q[:, :0], al), (args, q[:0], al[:0])):
        got = rule_search_sweep(*cols, rows, lens)
        want = ref.rule_search_sweep_ref(*[c.cpu() for c in cols],
                                         rows.cpu(), lens.cpu())
        _bitwise([got[k].cpu() for k in want], [want[k] for k in want])
    # only the all-padding rows over a live table launch
    assert rule_search_sweep.launches == before + 1


def test_seed_ops_on_gpu_equal_cpu(small, cuda):
    """Every op on a seed-layout DeviceTrie on the card equals the same
    on the CPU and the CSR layout's answers on the card; one search makes
    two sweep launches and no fused one."""
    import dataclasses

    from repro_torch.kernels import launch_counts, reset_launch_counts

    arrs, fz = small
    seeds = {dev: dataclasses.replace(fz.device_arrays(device=dev),
                                      child_offsets=None, max_fanout=0)
             for dev in (cuda, torch.device("cpu"))}
    gpu, cpu = seeds[cuda], seeds[torch.device("cpu")]
    csr = fz.device_arrays(device=cuda)
    q, al = TS.mixed_queries(np.random.RandomState(10), arrs, 2000, 6)
    prefixes = [[], [3], [3, 1], [999]]
    reset_launch_counts()
    got = TO.rule_search_batch(gpu, q, al)
    counts = launch_counts()
    assert counts["rule_search_sweep"] == 2
    assert counts["rule_search_fused"] == 0
    outs = [(got, TO.rule_search_batch(cpu, q, al),
             TO.rule_search_batch(csr, q, al)),
            (TO.top_k_rules_batch(gpu, prefixes, 25, metric="lift"),
             TO.top_k_rules_batch(cpu, prefixes, 25, metric="lift"),
             TO.top_k_rules_batch(csr, prefixes, 25, metric="lift"))]
    for role in TO.ROLES:
        outs.append(tuple(TO.rules_with(t, [0, 7, -1, 7], role=role, k=15)
                          for t in (gpu, cpu, csr)))
    for g, c, p in outs:
        _bitwise([g[k].cpu() for k in c], [c[k] for k in c])
        _bitwise([g[k] for k in p], [p[k] for k in p])
    g, c = TO.trie_reduce(gpu), TO.trie_reduce(cpu)
    assert float(g["n_rules"]) == float(c["n_rules"])
    assert float(g["confidence_max"]) == float(c["confidence_max"])
    _reduce_op_as_before(gpu, g)


# ----------------------------------------------------------------------
# streaming tries: the frozen side on the card's kernels
# ----------------------------------------------------------------------
def test_stream_on_gpu_equals_cpu(cuda):
    """A stream with novel and updated rules answers on the card as on the
    CPU, bitwise, with the rank, membership and fused search kernels
    launched on its frozen side, and equals the kernels' plain versions
    (``use_kernel=False``) on the card; after a refreeze too."""
    from repro_torch.arm.datasets import grocery_db
    from repro_torch.arm.rulegen import sample_rule_sequences
    from repro_torch.core import StreamingTrie
    from repro_torch.core.build_arrays import build_frozen_trie
    from repro_torch.kernels import launch_counts, reset_launch_counts

    db = grocery_db()
    seqs = sample_rule_sequences(db, 3000, max_len=6, seed=4)
    base, _, _ = build_frozen_trie(db, seqs[:2800], use_kernel=False)
    full, _, _ = build_frozen_trie(db, seqs, use_kernel=False)
    have = {base.path_items(v) for v in range(1, base.n_nodes)}
    novel = sorted((full.path_items(v) for v in range(1, full.n_nodes)
                    if full.path_items(v) not in have), key=len)
    nodes = {full.path_items(v): v for v in range(1, full.n_nodes)}
    upd = sorted(have)[::17]
    paths = novel + upd
    rng = np.random.RandomState(2)
    cols = [np.r_[getattr(full, f)[[nodes[p] for p in novel]],
                  rng.rand(len(upd)).astype(np.float32)]
            for f in ("support", "confidence", "lift")]
    streams = [StreamingTrie(base, device=dev)
               for dev in (cuda, "cpu")]
    for st in streams:
        st.insert(paths, *cols)
    pairs = [(p[: len(p) // 2], p[len(p) // 2:]) for p in paths[::3]
             if len(p) > 1]
    prefixes = [[]] + [list(p[:-1]) for p in novel[::5]] + [[999]]
    items = [p[-1] for p in novel[::4]] + [-1, 5]

    def ops(st, **kw):
        out = [TO.rule_search_batch(st, pairs, **kw)]
        for metric in ("confidence", "conviction"):
            out.append(TO.top_k_rules_batch(st, prefixes, 25, metric=metric,
                                            **kw))
        for role in TO.ROLES:
            out.append(TO.rules_with(st, items, role=role, k=15, **kw))
        return out

    for step in ("delta", "refrozen"):
        reset_launch_counts()
        gpu = ops(streams[0])
        counts = launch_counts()
        for name in ("topk_rank_batch", "rules_with_member",
                     "rule_search_fused"):
            assert counts[name] >= 1, (step, name, counts)
        plain = ops(streams[0], use_kernel=False)
        for g, c, p in zip(gpu, ops(streams[1]), plain):
            _bitwise([g[k].cpu() for k in c], [c[k] for k in c])
            _bitwise([g[k] for k in p], [p[k] for k in p])
        for st in streams:
            st.refreeze()


@pytest.mark.parametrize("layout", ["plain", "compressed"])
def test_sharded_plan_on_gpu_equals_cpu(small, cuda, layout):
    """A P = 2 plan with both shards on ``cuda:0`` gives, bitwise, the
    CPU plan's plain-version answers and the replicated engine's for all
    three ops; the rank, membership and descent kernels launch once per
    shard per op."""
    from repro_torch.distributed.trie_sharding import shard_device_trie
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import TrieMesh

    arrs, fz = small
    n_items = int(arrs["edge_item"].max()) + 1
    q, al = TS.synthetic_search_queries(arrs, 300, 6, seed=3)
    pairs = [([int(x) for x in r[:1] if x >= 0],
              [int(x) for x in r[1:] if x >= 0]) for r in q[:40]]
    prefixes = [[], [0], [1], [n_items + 1], [3]]
    items = [0, 1, 1, n_items + 2, -1, 5, 7]
    gpu = shard_device_trie(fz, TrieMesh([cuda] * 2), layout=layout)
    cpu = shard_device_trie(fz, TrieMesh(["cpu"] * 2), layout=layout)
    # the replicated answers: the FrozenTrie on the CPU (the compressed
    # DeviceTrie has no host canonicalization, so no ragged pairs there)
    repl = fz if layout == "plain" else \
        fz.device_arrays(device="cpu", layout=layout)
    search = "rule_search_span" if layout == "compressed" else \
        "rule_search_fused"

    def run(trie, **kw):
        out = {"search": TO.rule_search_batch(trie, q, al, **kw),
               "topk": TO.top_k_rules_batch(trie, prefixes, 10,
                                            metric="conviction", **kw)}
        if layout == "plain":
            out["pairs"] = TO.rule_search_batch(trie, pairs, **kw)
        for role in ("consequent", "antecedent", "any"):
            out[role] = TO.rules_with(trie, items, role=role, k=8, **kw)
        return out

    want, want_repl = run(cpu), run(repl, device="cpu")
    for _ in range(2):
        reset_launch_counts()
        got = run(gpu)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts[search] == 2 * (2 if layout == "plain" else 1)
        # top-k, plus the consequent role's posting ranks on plain
        assert counts["topk_rank_batch"] == 2 * (2 if layout == "plain"
                                                 else 1)
        assert counts["rules_with_member"] == 2 * (2 if layout == "plain"
                                                   else 3)
        for key in want:
            for f in want[key]:
                g = got[key][f].cpu()
                _bitwise([g], [want[key][f]])
                _bitwise([g], [want_repl[key][f]])


def test_default_mesh_leads_with_the_engine_device(small, cuda):
    """``mode="auto"`` shards over every visible card with the engine's
    own device as the lead, so the engine answers where it was asked to
    (one visible card: the replicated backend on it)."""
    from repro_torch.serve import TrieQueryEngine
    from repro_torch.serve.trie_engine import _default_mesh

    n = torch.cuda.device_count()
    for i in range(n):
        mesh = _default_mesh(torch.device("cuda", i))
        assert mesh.lead == torch.device("cuda", i)
        assert sorted(d.index for d in mesh.devices) == list(range(n))
    _, fz = small
    eng = TrieQueryEngine(fz, device=f"cuda:{n - 1}",
                          shard_threshold_nodes=1)
    assert eng.backend == ("sharded" if n > 1 else "replicated")
    assert torch.device(eng.device) == torch.device("cuda", n - 1)
