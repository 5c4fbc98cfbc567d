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
