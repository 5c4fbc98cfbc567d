"""The rank kernel's design (``csrc/rank.cu``), step by step, through its
plain mirrors in ``ref``: range dedup and its scatter back, the per-tile
keys, the seeded threshold (an upper bound of every range's k-th key, so
it never drops an answer), the tiles a range reads, the plan that gives
every read tile to exactly one block, and the whole planned selection.
Each is held to ``ref.topk_rank_batch_ref`` and to the reference's
``topk_rank_batch_pallas(interpret=True)``, bitwise, on hand-made columns
(equal scores across a tile boundary, all-``-inf`` tiles, ``min_depth``
masking, a range inside one tile, a range with exactly k full tiles) and
on synthetic tries.  The kernel itself is held to these on the card in
``test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rank import topk_rank_batch_pallas  # noqa: E402
from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import rank  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TILE = rank.TILE
GROUP = rank.GROUP
EMPTY = ref.EMPTY_KEY


def _same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)


def _columns(rng, n, decimals=None, depth_max=3):
    """f32 support, confidence and lift, int32 depth (the root at 0)."""
    cols = [rng.rand(n).astype(np.float32) for _ in range(2)]
    cols.append((3 * rng.rand(n)).astype(np.float32))
    if decimals is not None:
        cols = [np.round(c, decimals).astype(np.float32) for c in cols]
    depth = rng.randint(1, depth_max + 1, size=n).astype(np.int32)
    depth[0] = 0
    return [torch.from_numpy(c) for c in cols] + [torch.from_numpy(depth)]


def _ranges(pairs):
    a = np.asarray(pairs, np.int32).reshape(-1, 2)
    return torch.from_numpy(a[:, 0].copy()), torch.from_numpy(a[:, 1].copy())


def _pallas(cols, los, his, **kw):
    return topk_rank_batch_pallas(
        *[jnp.asarray(c.numpy()) for c in cols], jnp.asarray(los.numpy()),
        jnp.asarray(his.numpy()), interpret=True, **kw)


def _hand_made(name):
    """(columns, ranges, k, min_depth) of one hand-made case on six
    1024-position tiles."""
    rng = np.random.RandomState(len(name))
    n = 6 * TILE
    sup, conf, lift, depth = _columns(rng, n)
    ranges, k, min_depth = [(0, n)], 3, 1
    if name == "ties_across_tile_boundary":
        # one score over tiles 1-2 and the boundary between them: the
        # tile keys tie in score and differ in position only
        conf[TILE - 40:3 * TILE + 40] = 0.75
        conf[:TILE - 40] = 0.25
        conf[3 * TILE + 40:] = 0.25
        ranges = [(0, n), (TILE - 7, 3 * TILE + 9), (TILE, 3 * TILE),
                  (2 * TILE - 3, 2 * TILE + 3)]
        k = 2
    elif name == "all_inf_tiles":
        # tiles 0-3 masked out: four empty tile keys among six full tiles,
        # so the third smallest is empty and no range is seeded
        depth[: 4 * TILE] = 0
        ranges = [(0, n), (TILE, 5 * TILE + 1), (0, 4 * TILE)]
    elif name == "min_depth_mask":
        # the best score of every tile lies below min_depth: masked, it
        # must neither answer nor seed
        conf = torch.from_numpy(np.round(conf.numpy(), 2))
        for t in range(6):
            best = t * TILE + int(torch.argmax(conf[t * TILE:(t + 1) * TILE]))
            depth[best] = 1
        min_depth = 2
        ranges = [(0, n), (5, n - 5), (TILE, 4 * TILE)]
        k = 4
    elif name == "range_inside_one_tile":
        ranges = [(TILE + 100, 2 * TILE - 50), (3 * TILE, 3 * TILE + 1),
                  (4 * TILE + 1000, 4 * TILE + 1010)]
        k = 5
    elif name == "exactly_k_full_tiles":
        # three full tiles and k = 3: the seed is the largest of their
        # three tile keys; then with two partial edge tiles around them
        ranges = [(TILE, 4 * TILE), (TILE - 24, 4 * TILE + 24),
                  (2 * TILE, 5 * TILE), (TILE, 3 * TILE)]
    elif name == "duplicates_nested_and_empty":
        ranges = [(0, n), (TILE, 2 * TILE), (0, n), (300, 200), (7, 7),
                  (-5, 3 * TILE), (2 * TILE, n + 100), (TILE, 2 * TILE),
                  (n + 3, n + 9), (0, n)]
        k = 4
    return [sup, conf, lift, depth], _ranges(ranges), k, min_depth


HAND_MADE = ("ties_across_tile_boundary", "all_inf_tiles", "min_depth_mask",
             "range_inside_one_tile", "exactly_k_full_tiles",
             "duplicates_nested_and_empty")


def _keys_and_tiles(cols, min_depth, metric="confidence"):
    score = ref.masked_scores_ref(*cols, metric=metric, min_depth=min_depth)
    keys = ref.topk_keys_ref(score)
    return (score, keys, ref.tile_keys_ref(keys, TILE),
            ref.tile_keys_ref(keys, GROUP))


def _full(lo, hi, size):
    return (hi // size) - (-(-lo // size))


@pytest.mark.parametrize("name", HAND_MADE)
def test_seeded_threshold_never_drops_an_answer(name):
    """Every answer's key is below its range's seeded threshold, lies in
    a tile the range reads, and a range reads at most k + 2 tiles; the
    seed is exactly the k-th smallest key of the range's full tiles, else
    of its full groups; the hand-made cases pin when a range is seeded and
    from which."""
    cols, (los, his), k, min_depth = _hand_made(name)
    n = cols[0].shape[0]
    _, keys, tkeys, gkeys = _keys_and_tiles(cols, min_depth)
    lo, hi, _ = ref.dedup_ranges_ref(los, his, n)
    thr = ref.seed_thresholds_ref(tkeys, gkeys, lo, hi, k, TILE, GROUP)
    read = ref.tiles_read_ref(tkeys, lo, hi, thr, TILE)
    _, pos = ref.topk_rank_batch_ref(*cols, lo, hi, k=k, min_depth=min_depth)
    level = []
    for r in range(lo.shape[0]):
        live = pos[r][pos[r] >= 0].long()
        assert (keys[live] < thr[r]).all()
        assert set((live // TILE).tolist()) <= set(read[r].tolist())
        assert read[r].shape[0] <= min(k + 2, -(-n // TILE))
        a, b = int(lo[r]), int(hi[r])
        use = next(((kk, size) for kk, size in ((tkeys, TILE),
                                                 (gkeys, GROUP))
                    if _full(a, b, size) >= k), None)
        level.append(None if use is None else use[1])
        if use is None:
            assert int(thr[r]) == EMPTY
            continue
        f0 = -(-a // use[1])
        seed = int(torch.sort(use[0][f0:b // use[1]]).values[k - 1])
        assert int(thr[r]) == (EMPTY if seed == EMPTY else seed + 1)
        if seed != EMPTY:
            assert live.shape[0] == k
    seeded = [int(t) != EMPTY for t in thr]
    if name == "exactly_k_full_tiles":
        # three of the four ranges hold k full tiles, one only k - 1 and
        # is seeded from its groups
        assert all(seeded)
        assert level == [TILE if f >= k else GROUP
                         for f in _full(lo, hi, TILE).tolist()]
        assert level.count(GROUP) == 1
    if name == "all_inf_tiles":
        # k full tiles, the k-th of their keys empty: no seed
        assert not any(seeded) and level == [TILE] * 3
    if name == "range_inside_one_tile":
        # 26 full groups seed the first range; the others hold none
        assert seeded == [True, False, False] and level[0] == GROUP
    if name == "min_depth_mask":
        assert seeded[int(torch.argmax(hi - lo))]


@pytest.mark.parametrize("name", HAND_MADE)
def test_planned_mirror_equals_plain_and_reference(name):
    """The whole planned selection (dedup, seed, tiles, plan, blocks,
    merge, scatter back) equals the plain ranking and the reference's
    interpret-mode kernel bitwise, with the default plan and with one
    tile a block."""
    cols, (los, his), k, min_depth = _hand_made(name)
    want = ref.topk_rank_batch_ref(*cols, los, his, k=k, min_depth=min_depth)
    _same(want, _pallas(cols, los, his, k=k, min_depth=min_depth))
    for work_blocks, min_tiles in ((rank.WORK_BLOCKS, rank.MIN_TILES),
                                   (1 << 12, 1), (1, 1)):
        got = ref.topk_rank_planned_ref(
            *cols, los, his, k=k, min_depth=min_depth, tile=TILE,
            group=GROUP, work_blocks=work_blocks, min_tiles=min_tiles)
        _same(got, want)


@pytest.mark.parametrize("tile", [1, 7, TILE])
def test_tile_keys_bound_every_position(tile):
    """A tile's key is the least key of its positions (the partial last
    tile too), so it bounds each of them; an all-``-inf`` tile's key is
    empty; +0.0 and -0.0 share a key; key order is top-k order."""
    rng = np.random.RandomState(tile)
    n = 3 * TILE + 5
    score = torch.from_numpy(np.round(rng.randn(n), 1).astype(np.float32))
    score[:2 * tile] = -torch.inf
    score[2 * tile + 1] = -0.0
    keys = ref.topk_keys_ref(score)
    assert (keys[:2 * tile] == EMPTY).all()
    assert int(keys[2 * tile + 1]) - (2 * tile + 1) == int(
        ref.topk_keys_ref(torch.zeros(1))[0])
    tkeys = ref.tile_keys_ref(keys, tile)
    assert tkeys.shape[0] == -(-n // tile)
    assert (tkeys[:2] == EMPTY).all()
    for t in range(tkeys.shape[0]):
        part = keys[t * tile:(t + 1) * tile]
        assert int(tkeys[t]) == int(part.min())
    order = torch.argsort(keys, stable=True)[: n - 2 * tile]
    _, want = ref._ordered_topk(score[None], n - 2 * tile)
    assert torch.equal(order.to(torch.int32), want[0])


@pytest.mark.parametrize("case", [
    dict(q=256, dup=32, n=1 << 20), dict(q=5, dup=2, n=3000),
    dict(q=1, dup=1, n=10), dict(q=64, dup=64, n=5000)])
def test_dedup_ranges_scatter_back(case):
    """Equal ranges collapse to one (after clamping; every empty range is
    one), and the distinct ranges' rows gathered by ``inverse`` are the
    rows of a ranking without dedup."""
    rng = np.random.RandomState(case["q"])
    n, q = case["n"], case["q"]
    lo = rng.randint(-3, n + 3, size=q)
    hi = lo + rng.randint(-2, 4 * TILE, size=q)
    dup = rng.randint(0, q, size=case["dup"])
    lo[dup], hi[dup] = lo[0], hi[0]
    los, his = torch.from_numpy(lo.astype(np.int32)), \
        torch.from_numpy(hi.astype(np.int32))
    ulo, uhi, inv = ref.dedup_ranges_ref(los, his, n)
    clo, chi = ref.clamp_ranges_ref(los, his, n)
    assert torch.equal(ulo[inv], clo) and torch.equal(uhi[inv], chi)
    assert len(set(zip(ulo.tolist(), uhi.tolist()))) == ulo.shape[0]
    assert ((uhi > ulo) | ((ulo == 0) & (uhi == 0))).all()
    if n <= 8192:
        cols = _columns(rng, n, decimals=1)
        want = ref.topk_rank_batch_ref(*cols, los, his, k=7)
        got = ref.topk_rank_batch_ref(*cols, ulo, uhi, k=7)
        _same((got[0][inv], got[1][inv]), want)


@pytest.mark.parametrize("tiles,min_tiles,work_blocks", [
    ([100, 4, 4, 5, -1, 0, 3], 2, 1024), ([100, 4, 4, 5, -1, 0, 3], 8, 3),
    ([0, 0, -1], 1, 1), ([1] * 300, 1, 16), ([5000, 1, -1, 2], 1, 1024),
    ([7, 0, 9, 1, 1, 1], 3, 2)])
def test_plan_reads_every_tile_once(tiles, min_tiles, work_blocks):
    """The plan gives every tile a range reads to exactly one of its
    blocks, at least one block to every range (none to a copied one), and
    fits the grid of ``work_blocks + Q`` blocks."""
    first, nb, block_q = ref.plan_blocks_ref(tiles, min_tiles, work_blocks)
    assert int(nb.sum()) <= work_blocks + len(tiles)
    assert torch.equal(block_q, torch.repeat_interleave(
        torch.arange(len(tiles)), nb))
    for i, t in enumerate(tiles):
        if t < 0:
            assert int(nb[i]) == 0
            continue
        assert int(nb[i]) >= 1
        read = torch.arange(100, 100 + t)
        parts = [ref.block_tiles_ref(read, int(nb[i]), b)
                 for b in range(int(nb[i]))]
        assert torch.equal(torch.cat(parts), read)
        assert (block_q[int(first[i]):int(first[i] + nb[i])] == i).all()


@pytest.mark.parametrize("q,k,n", [
    (256, 100, 1 << 20), (256, 1500, 1 << 20), (1, 1 << 23, 1 << 20),
    (3, 5000, 6000), (4096, 10, 1 << 23), (1, 1, 1)])
def test_launch_shape_bounds_scratch(q, k, n):
    """The launch's sizes come from its shape alone: the grid fits the
    plan, the hash table is a power of two with room for every range, a
    range's tile list holds the most tiles it can read, and the lists
    take at most ``LIST_ELEMS`` elements or one list a query."""
    s = rank.launch_shape(q, k, n)
    assert s["grid"] == s["work_blocks"] + q and s["work_blocks"] >= 1
    assert s["table"] >= 2 * q and s["table"] & (s["table"] - 1) == 0
    assert s["list_cap"] == min(k + 2, -(-n // TILE))
    assert s["grid"] * k <= max(rank.LIST_ELEMS, (q + 1) * k)
    assert s["words"] >= q * s["list_cap"] + s["grid"]


TRIES = {
    "hub": lambda: TS.synthetic_csr_trie(1 << 12, seed=0),
    "chain": lambda: TS.synthetic_chain_trie(3000, chain_fraction=0.75,
                                             seed=3),
    "random": lambda: TS.random_csr_trie(np.random.RandomState(31), 1500, 30),
}


@pytest.mark.parametrize("trie", sorted(TRIES))
@pytest.mark.parametrize("ties", [False, True])
def test_planned_mirror_on_tries(trie, ties):
    """On synthetic tries (the main path's prefixes: whole-trie ranges
    repeated, absent and 1-3 item ones), every metric and k in {1, 10,
    100, 1100}: the planned mirror equals the plain ranking bitwise, at
    the kernel's tile and group and at a 16-position tile of 4-position
    groups that gives the small tries many of them; k = 10 also against
    the reference's kernel."""
    fz = TS.frozen_from_arrays(TRIES[trie]())
    t = TO.dfs_rank_arrays(fz, device="cpu")
    cols = [t["support"], t["confidence"], t["lift"]]
    if ties:
        cols = [torch.round(c * 10) / 10 for c in cols]
    prefixes = [[], [1], [2, 5], [77], [], [3], [1], [0, 1, 2], [999]]
    los, his, _ = TO.prefix_ranges(fz, prefixes, device="cpu")
    args = (*cols, t["depth"], los, his)
    for metric in TO.RANK_METRICS:
        for k in (1, 10, 100, 1100):
            want = ref.topk_rank_batch_ref(*args, k=k, metric=metric)
            if k == 10:
                _same(want, _pallas([*cols, t["depth"]], los, his, k=k,
                                    metric=metric))
            for tile, group in ((TILE, GROUP), (16, 4)):
                got = ref.topk_rank_planned_ref(
                    *args, k=k, metric=metric, tile=tile, group=group,
                    work_blocks=rank.WORK_BLOCKS, min_tiles=rank.MIN_TILES)
                _same(got, want)
