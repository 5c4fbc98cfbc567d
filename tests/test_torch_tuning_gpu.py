"""The launch knobs on the card: each wrapper's kernel at edge values of
its knob (``tuning_overrides``) against its plain PyTorch version,
bitwise (the trie_reduce sums bitwise against the plain mirror of the
kernel's order at the launch's block count), the reduction's scratch
growing with the grid, and ``REPRO_TORCH_FORCE_INTERPRET`` never running
a plain version on the card.
Marked ``gpu``: they skip where no CUDA GPU is visible.  This module
imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \\
        -m gpu tests/test_torch_tuning_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.arm.datasets import grocery_db  # noqa: E402
from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels.item_index import rules_with_member  # noqa: E402
from repro_torch.kernels.rank import topk_rank_batch  # noqa: E402
from repro_torch.kernels.rule_search import rule_search_sweep  # noqa: E402
from repro_torch.kernels.support_count import (  # noqa: E402
    launch_shape as support_shape, support_count_bitmap,
)
from repro_torch.kernels.trie_reduce import (  # noqa: E402
    _scratch, launch_shape, trie_reduce_stats, vector_head, vector_nodes,
)
from repro_torch.kernels.tuning import tuning_overrides  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have "
                    "no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def hub():
    """A 2^15-edge hub trie (33 tiles of 1024 positions)."""
    return TS.frozen_from_arrays(TS.synthetic_csr_trie(1 << 15, seed=2))


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


# few blocks with many tiles each (the running top-k path, and past
# k = 1024 its lists in global scratch), and one block a tile
SELECTION = [dict(select_work_blocks=2),
             dict(select_work_blocks=1 << 16, rank_min_tiles=1,
                  member_min_tiles=1),
             dict(select_work_blocks=256, rank_min_tiles=32,
                  member_min_tiles=32)]


@pytest.mark.parametrize("knobs", SELECTION)
def test_rank_and_member_at_selection_knobs(hub, cuda, knobs):
    t = TO.dfs_rank_arrays(hub, device=cuda)
    los, his, _ = TO.prefix_ranges(hub, [[], [1], [2, 5], [1], [77]],
                                   device=cuda)
    args = (t["support"], t["confidence"], t["lift"], t["depth"], los, his)
    ia = TO.item_rank_arrays(hub, device=cuda)
    rows = [torch.from_numpy(a).to(cuda) for a in TO._posting_slices(
        ia["item_offsets"], [0, 1, 4, 29, -1, 4])]
    m_args = (ia["support"], ia["confidence"], ia["lift"], ia["depth"],
              ia["node_item"], ia["post_lo"], ia["post_hi"], *rows)
    with tuning_overrides(**knobs):
        for k in (1, 10, 100, 1100):
            before = topk_rank_batch.launches
            got = topk_rank_batch(*args, k=k, metric="confidence")
            assert topk_rank_batch.launches == before + 1
            _bitwise(got, ref.topk_rank_batch_ref(*args, k=k,
                                                  metric="confidence"))
            for role in TO.ROLES:
                before = rules_with_member.launches
                got = rules_with_member(*m_args, k=k, role=role)
                assert rules_with_member.launches == before + 1
                _bitwise(got, ref.rules_with_ref(*m_args, k=k, role=role))


@pytest.mark.parametrize("knobs", [
    dict(reduce_blocks_per_sm=1), dict(reduce_blocks_per_sm=8),
    dict(reduce_single_block_tiles=1), dict(reduce_single_block_tiles=8)])
def test_reduce_at_grid_knobs(cuda, knobs):
    """The reduction at each grid knob on column sizes around its edges:
    bitwise its mirror at the launch's block count; the scratch grows when
    a grid outgrows it."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n = 1 << 21
    cols = (torch.rand((n,), generator=g, device=cuda),
            torch.rand((n,), generator=g, device=cuda),
            torch.randint(0, 6, (n,), generator=g, device=cuda,
                          dtype=torch.int32))
    _scratch.clear()
    with tuning_overrides(**knobs):
        for m in (4096, 4096 * 3, 4096 * 8 + 5, 1 << 20, n):
            part = tuple(c[:m] for c in cols)
            got = trie_reduce_stats(*part)
            head = vector_head(*part)[0]
            shape = launch_shape(m, vector_nodes(part[1].dtype), head,
                                 _build.sm_count(cuda))
            _bitwise(got, ref.trie_reduce_split_ref(
                *part, blocks=shape["blocks"], threads=shape["threads"],
                unroll=shape["unroll"], head=head))
            want = ref.trie_reduce_ref(*part)
            _bitwise((got[0], got[2]), (want[0], want[2]))
            for buf in _scratch.values():
                assert buf.numel() * 4 >= 16 * (1 + shape["blocks"])


@pytest.mark.parametrize("per_sm", [1, 2, 8])
def test_sweep_at_blocks_per_sm(hub, cuda, per_sm):
    arrs = TS.synthetic_csr_trie(1 << 15, seed=2)
    q, al = TS.synthetic_search_queries(arrs, 512, 6, seed=3)
    sw = TO.edge_metric_arrays(hub.device_arrays(device=cuda))
    cols = [sw[k] for k in ("edge_parent", "edge_item", "edge_child",
                            "edge_conf", "edge_sup", "edge_lift")]
    args = (*cols, torch.from_numpy(q).to(cuda), torch.from_numpy(al).to(cuda))
    with tuning_overrides(sweep_blocks_per_sm=per_sm):
        got = rule_search_sweep(*args)
    want = ref.rule_search_sweep_ref(*args)
    _bitwise([got[k] for k in want], [want[k] for k in want])
    assert bool(got["found"].any())


@pytest.mark.parametrize("bw", [4, 8, 16])
def test_support_at_max_bw(cuda, bw):
    db = grocery_db()
    rng = np.random.RandomState(bw)
    mat = rng.randint(-1, db.n_items, size=(3000, 4)).astype(np.int32)
    lens = rng.randint(0, 5, size=3000).astype(np.int32)
    d = ref.support_slots_ref(torch.from_numpy(mat), db.n_items)[1]
    bm = db.device_bitmaps(cuda)
    with tuning_overrides(support_max_bw=bw):
        assert support_shape(d, db.n_words, db.n_items, 3000, 132)["bw"] \
            <= bw
        got = support_count_bitmap(bm, torch.from_numpy(mat).to(cuda),
                                   torch.from_numpy(lens).to(cuda),
                                   db.n_transactions)
    assert torch.equal(got, ref.support_count_bitmap_ref(
        bm, torch.from_numpy(mat).to(cuda), torch.from_numpy(lens).to(cuda),
        db.n_transactions))


def test_force_interpret_never_runs_plain_on_the_card(hub, cuda,
                                                      monkeypatch):
    """Asking for the plain versions raises on CUDA tensors, with no
    launch; asking for the kernels launches."""
    t = TO.dfs_rank_arrays(hub, device=cuda)
    los, his, _ = TO.prefix_ranges(hub, [[], [1]], device=cuda)
    args = (t["support"], t["confidence"], t["lift"], t["depth"], los, his)
    monkeypatch.setenv("REPRO_TORCH_FORCE_INTERPRET", "1")
    before = topk_rank_batch.launches
    with pytest.raises(ValueError, match="REPRO_TORCH_FORCE_INTERPRET"):
        topk_rank_batch(*args, k=10)
    assert topk_rank_batch.launches == before
    monkeypatch.setenv("REPRO_TORCH_FORCE_INTERPRET", "compiled")
    got = topk_rank_batch(*args, k=10)
    assert topk_rank_batch.launches == before + 1
    _bitwise(got, ref.topk_rank_batch_ref(*args, k=10))
