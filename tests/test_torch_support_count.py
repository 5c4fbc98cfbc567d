"""Port parity for support counting: the port's ``ops.support_count`` (on
the CPU, the plain version of the bitmap kernel) against the reference's
``ops.support_count`` (its Pallas kernel in interpret mode) and its dense
oracle ``support_count_ref``, exactly, on random transaction DBs; the two
``support_batch`` paths of both packages; and the three reference
behaviours the port does not share, each pinned beside the port's answer.
The kernel itself is held against its plain version on the card in
``test_torch_gpu.py``; here its plan is, through the plain mirrors
``ref.support_slots_ref`` (the pre-pass's slot map and largest id) and
``ref.support_count_tiled_ref`` (word tiles of the slotted rows, partial
counts per tile, summed), and the launch sizing of ``launch_shape``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.arm.transactions import TransactionDB as JaxDB  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels.ref import support_count_ref as jax_support_count_ref  # noqa: E402
from repro_torch.arm.transactions import TransactionDB  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402
from repro_torch.kernels.support_count import (  # noqa: E402
    SMEM_BLOCK, THREADS, launch_shape, staging_limit, support_count_bitmap,
    tile_bytes, tile_words,
)


def _random_db(rng, t, i):
    txs = [sorted(set(rng.randint(0, i, size=rng.randint(1, 9)).tolist()))
           for _ in range(t)]
    return txs, i


def _random_candidates(rng, db_items, c, k):
    """Rows of 1..k valid items (some repeated, some -1 entries mid-row),
    plus padding rows (``lengths`` 0 or -1): no row with ``lengths > 0``
    lacks a valid item, and every id is in range, so the reference's
    answer is the right one."""
    cand = rng.randint(-1, db_items, size=(c, k)).astype(np.int32)
    if k > 1:   # force repeated items into a quarter of the rows
        dup = rng.rand(c) < 0.25
        cand[dup, -1] = cand[dup, 0]
    empty = (cand < 0).all(axis=1)
    cand[empty, 0] = rng.randint(0, db_items, size=int(empty.sum()))
    lens = (cand >= 0).sum(axis=1).astype(np.int32)
    pad = rng.rand(c) < 0.15
    lens[pad] = rng.choice([0, -1], size=int(pad.sum()))
    return cand, lens


CASES = [
    # (T, I, C, K)
    (5, 3, 7, 2),
    (64, 20, 100, 3),
    (300, 200, 500, 6),
    (257, 50, 311, 1),
    (31, 7, 0, 3),
    (0, 9, 12, 2),
    (97, 40, 64, 6),
]


@pytest.mark.parametrize("t,i,c,k", CASES)
def test_support_count_matches_reference(t, i, c, k):
    rng = np.random.RandomState(t * 7919 + i * 31 + c + k)
    txs, n_items = _random_db(rng, t, i)
    jdb, tdb = JaxDB(txs, n_items), TransactionDB(txs, n_items)
    np.testing.assert_array_equal(tdb.item_bitmaps, jdb.item_bitmaps)
    cand, lens = _random_candidates(rng, n_items, c, k)

    got = TO.support_count(cand, lens, tdb.item_bitmaps, device="cpu",
                           n_transactions=t)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    want = np.asarray(JO.support_count(cand, lens, jdb.item_bitmaps))
    np.testing.assert_array_equal(got.numpy(), want)

    # the reference's dense oracle on the same membership
    member = np.array(JO.members_from_candidates(jnp.asarray(cand),
                                                 n_items))
    eff = np.where(lens > 0, member.sum(1), -1).astype(np.int32)
    dense = JO.dense_from_bitmaps(jdb.item_bitmaps)[:t]
    oracle = np.asarray(jax_support_count_ref(
        jnp.asarray(dense), jnp.asarray(member), jnp.asarray(eff)))
    np.testing.assert_array_equal(got.numpy(), oracle)
    port_oracle = TR.support_count_ref(
        torch.from_numpy(dense.astype(np.float32)), torch.from_numpy(member),
        torch.from_numpy(eff))
    np.testing.assert_array_equal(port_oracle.numpy(), oracle)

    # the dense input, packed into bitmaps first
    got_dense = TO.support_count(cand, lens, dense_tx=dense, device="cpu")
    np.testing.assert_array_equal(got_dense.numpy(), want)


@pytest.mark.parametrize("t,i,c,k", CASES)
def test_support_batch_paths_agree(t, i, c, k):
    """Host sweep and kernel path, in both packages, on the same rows,
    end-padded as ``apriori`` and ``build_frozen_trie`` make them (the
    reference's host path misreads a -1 ahead of a valid item: see
    ``test_reference_faults_beside_the_port``)."""
    rng = np.random.RandomState(t + 3 * i + 5 * c + k)
    txs, n_items = _random_db(rng, t, i)
    jdb, tdb = JaxDB(txs, n_items), TransactionDB(txs, n_items)
    cand, lens = _random_candidates(rng, n_items, c, k)
    cand = np.take_along_axis(
        cand, np.argsort(cand < 0, axis=1, kind="stable"), axis=1)
    host = tdb.support_batch(cand, lens)
    np.testing.assert_array_equal(
        tdb.support_batch(cand, lens, use_kernel=True, device="cpu"), host)
    np.testing.assert_array_equal(jdb.support_batch(cand, lens), host)
    np.testing.assert_array_equal(
        jdb.support_batch(cand, lens, use_kernel=True), host)
    # lengths inferred from the rows
    np.testing.assert_array_equal(
        tdb.support_batch(cand, use_kernel=True, device="cpu"),
        jdb.support_batch(cand))


def test_members_and_dense_layouts_match_reference():
    rng = np.random.RandomState(3)
    txs, n_items = _random_db(rng, 77, 13)
    db = TransactionDB(txs, n_items)
    cand, _ = _random_candidates(rng, n_items, 40, 4)
    np.testing.assert_array_equal(
        TO.members_from_candidates(torch.from_numpy(cand), n_items).numpy(),
        np.asarray(JO.members_from_candidates(jnp.asarray(cand), n_items)))
    dense = JO.dense_from_bitmaps(db.item_bitmaps)
    np.testing.assert_array_equal(TO.dense_from_bitmaps(db.item_bitmaps),
                                  dense)
    np.testing.assert_array_equal(TO.bitmaps_from_dense(dense[:77]),
                                  db.item_bitmaps)
    bm = torch.from_numpy(db.item_bitmaps.view(np.int32))
    np.testing.assert_array_equal(TR.bitmaps_to_dense(bm, 77).numpy(),
                                  dense[:77].astype(np.float32))


def test_reference_faults_beside_the_port():
    """Three rows where the reference's answer is not the itemset count:
    (1) its kernel path counts a row with lengths > 0 and no valid item
    as the transaction count padded to its 256-row tile, where Support(∅)
    is 5; (2) its host path ANDs an all-ones sentinel for a -1 ahead of a
    valid item, or for lengths past the row's valid items, and counts
    32 W; (3) its ``ops.support_count`` drops an item id >= I through
    its scatter, where ``support_batch`` and the port raise."""
    txs = [[0, 1], [0], [1, 2], [0, 2], [2]]
    jdb, tdb = JaxDB(txs, 3), TransactionDB(txs, 3)

    empty = np.array([[-1, -1]], np.int32)
    two = np.array([2], np.int32)
    assert int(np.asarray(JO.support_count(empty, two,
                                           jdb.item_bitmaps))[0]) == 256
    assert int(TO.support_count(empty, two, tdb.item_bitmaps, device="cpu",
                                n_transactions=5)[0]) == 5
    assert int(TO.support_count(empty, two, dense_tx=JO.dense_from_bitmaps(
        jdb.item_bitmaps)[:5], device="cpu")[0]) == 5

    lead = np.array([[-1, 0]], np.int32)
    one = np.array([1], np.int32)
    assert int(jdb.support_batch(lead, one)[0]) == 32 * jdb.n_words
    assert int(jdb.support_batch(lead, one, use_kernel=True)[0]) == 3
    assert int(tdb.support_batch(lead, one)[0]) == 3
    assert int(tdb.support_batch(lead, one, use_kernel=True,
                                 device="cpu")[0]) == 3
    # lengths past the row's valid items: none here, so Support(∅)
    assert int(jdb.support_batch(empty, two)[0]) == 32 * jdb.n_words
    assert int(tdb.support_batch(empty, two)[0]) == 5
    assert int(tdb.support_batch(empty, two, use_kernel=True,
                                 device="cpu")[0]) == 5

    out_of_range = np.array([[0, 7]], np.int32)
    assert int(np.asarray(JO.support_count(out_of_range, two,
                                           jdb.item_bitmaps))[0]) == 3
    with pytest.raises(ValueError, match="out of range"):
        TO.support_count(out_of_range, two, tdb.item_bitmaps, device="cpu",
                         n_transactions=5)
    with pytest.raises(ValueError, match="out of range"):
        tdb.support_batch(out_of_range, two, use_kernel=True, device="cpu")


def test_wrapper_checks_and_counts_no_cpu_launch():
    db = TransactionDB([[0, 1], [1]], 2)
    bm = db.device_bitmaps("cpu")
    assert bm is db.device_bitmaps("cpu")   # uploaded once per device
    cand = torch.tensor([[0, 1], [1, -1]], dtype=torch.int32)
    lens = torch.tensor([2, 1], dtype=torch.int32)
    before = support_count_bitmap.launches
    np.testing.assert_array_equal(
        support_count_bitmap(bm, cand, lens, 2).numpy(), [1, 2])
    assert support_count_bitmap.launches == before   # plain version
    with pytest.raises(ValueError, match="do not fill"):
        support_count_bitmap(bm, cand, lens, 33)
    with pytest.raises(ValueError, match="lengths"):
        support_count_bitmap(bm, cand, lens[:1], 2)
    with pytest.raises(ValueError, match="need n_transactions"):
        TO.support_count(cand, lens, db.item_bitmaps, device="cpu")
    with pytest.raises(ValueError, match="need item_bitmaps"):
        TO.support_count(cand, lens, device="cpu")


# ----------------------------------------------------------------------
# the kernel's plan: slot map, word tiles, per-tile partial counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t,i,c,k", CASES)
def test_tiled_mirror_matches_reference(t, i, c, k):
    """The plan's mirror at the kernel's tile widths (and at widths that
    are not powers of two) equals the plain version and the reference's
    interpret-mode Pallas kernel, exactly."""
    rng = np.random.RandomState(t * 7919 + i * 31 + c + k)
    txs, n_items = _random_db(rng, t, i)
    jdb, tdb = JaxDB(txs, n_items), TransactionDB(txs, n_items)
    cand, lens = _random_candidates(rng, n_items, c, k)
    bm = tdb.device_bitmaps("cpu")
    args = (bm, torch.from_numpy(cand), torch.from_numpy(lens), t)
    want = np.asarray(JO.support_count(cand, lens, jdb.item_bitmaps))
    plain = TR.support_count_bitmap_ref(*args)
    np.testing.assert_array_equal(plain.numpy(), want)
    d = TR.support_slots_ref(torch.from_numpy(cand), n_items)[1]
    for bw in (4, 8, 16, 32, 3, tile_words(d, tdb.n_words, n_items)):
        got = TR.support_count_tiled_ref(*args, bw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _levels(db, minsup):
    """Every counting level of ``apriori(db, minsup)`` on the kernel path,
    recorded as apriori makes them (counted on the CPU)."""
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


@pytest.mark.parametrize("n_tx", [300, 1100, 32, 20, 0])
def test_tiled_mirror_on_apriori_levels(n_tx):
    """The recorded apriori levels of a small DB through the plan's mirror
    at BW = 32 (the retail tile) and at ``tile_words``' own choice: W = 10
    (< BW), 35 (not a multiple of BW), one whole word, one partial word,
    and T = 0 (no word: every count 0)."""
    rng = np.random.RandomState(n_tx + 5)
    txs, n_items = _random_db(rng, max(n_tx, 300), 30)
    tdb = TransactionDB(txs[:n_tx], n_items)
    levels = _levels(TransactionDB(txs[:300], n_items), 0.03)
    assert len(levels) >= 2
    bm = tdb.device_bitmaps("cpu")
    for mat, lens in levels:
        args = (bm, torch.from_numpy(mat), torch.from_numpy(lens), n_tx)
        want = TR.support_count_bitmap_ref(*args)
        np.testing.assert_array_equal(tdb.support_batch(mat, lens),
                                      want.numpy())
        d = TR.support_slots_ref(torch.from_numpy(mat), n_items)[1]
        for bw in {32, tile_words(d, tdb.n_words, n_items)}:
            assert torch.equal(TR.support_count_tiled_ref(*args, bw), want)


def test_slot_map_mirror():
    """The pre-pass's mirror: the largest entry, D distinct valid ids in
    ascending order, and slot_of its inverse; a -1 entry or a repeat adds
    no slot."""
    cand = torch.tensor([[7, 2, -1], [2, 2, 9], [-1, -1, -1]],
                        dtype=torch.int32)
    top, d, slot_of, slot_item = TR.support_slots_ref(cand, 12)
    assert (top, d) == (9, 3)
    assert slot_item.tolist() == [2, 7, 9]
    assert slot_of.tolist() == [-1, -1, 0, -1, -1, -1, -1, 1, -1, 2, -1, -1]
    empty = torch.full((2, 3), -1, dtype=torch.int32)
    assert TR.support_slots_ref(empty, 4)[:2] == (-1, 0)
    assert TR.support_slots_ref(empty[:, :0], 4)[:2] == (-1, 0)
    # an id >= I: only the largest id, no slots (the kernel writes none)
    assert TR.support_slots_ref(cand, 9) == (9, 0, None, None)


def test_prepass_range_error():
    """An id >= I raises through the pre-pass (the mirror on the CPU), in
    the wrapper and in the plan's mirror, naming the largest id."""
    db = TransactionDB([[0, 1], [1, 2]], 3)
    bm = db.device_bitmaps("cpu")
    cand = torch.tensor([[0, 1], [5, -1], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([2, 1, 0], dtype=torch.int32)
    before = support_count_bitmap.launches
    with pytest.raises(ValueError, match=r"item 5 out of range \[0,3\)"):
        support_count_bitmap(bm, cand, lens, 2)
    with pytest.raises(ValueError, match=r"item 5 out of range \[0,3\)"):
        TR.support_count_tiled_ref(bm, cand, lens, 2, 32)
    assert support_count_bitmap.launches == before


def test_tile_sizing_at_the_staging_limit():
    """``tile_words`` takes the widest power-of-two tile (4..32 words, not
    past W) whose rows, slot words and ids fit a block's shared memory; D
    at the staging limit stages 4-word tiles, one more reads the rows
    unstaged."""
    n_items = 12_000
    limit = staging_limit(n_items)
    assert 11_000 < limit < n_items
    assert (tile_bytes(limit, 4, n_items) <= SMEM_BLOCK
            < tile_bytes(limit + 1, 4, n_items))
    assert tile_bytes(462, 32, 3600) == 463 * 128 + 113 * 8 + 462 * 4
    assert tile_words(462, 563, 3600) == 32       # the retail launches
    assert tile_words(462, 1, 3600) == 4 and tile_words(462, 5, 3600) == 8
    assert tile_words(462, 22, 3600) == 32 and tile_words(0, 0, 0) == 4
    top32 = (SMEM_BLOCK - 128 - 8 * 375) // 132   # the most rows at BW = 32
    assert (tile_bytes(top32, 32, n_items) <= SMEM_BLOCK
            < tile_bytes(top32 + 1, 32, n_items))
    assert tile_words(top32, 563, n_items) == 32
    assert tile_words(top32 + 1, 563, n_items) == 16
    assert tile_words(limit, 563, n_items) == 4
    assert tile_words(limit + 1, 563, n_items) == 0
    at = launch_shape(limit, 563, n_items, 20_000, 132)
    above = launch_shape(limit + 1, 563, n_items, 20_000, 132)
    assert at["staged"] and at["bw"] == 4
    assert at["smem"] == tile_bytes(limit, 4, n_items)
    assert not above["staged"] and above["bw"] == 32 and above["smem"] == 0
    assert above["tiles"] == 18
    # the slot words alone past a block's memory: nothing stages
    assert staging_limit(1 << 25) < 0 and tile_words(1, 563, 1 << 25) == 0


def test_launch_shape_fills_the_card():
    """One block an SM in one wave: the retail level-2 launch takes 18
    word tiles of 32 and 7 slices, 126 blocks on 132 SMs; a small launch
    takes one slice per THREADS candidates; a DB wider than the card takes
    one slice; every candidate lands in a slice."""
    s = launch_shape(462, 563, 3600, 106_491, 132)
    assert (s["bw"], s["tiles"], s["slices"]) == (32, 18, 7)
    assert s["smem"] == tile_bytes(462, 32, 3600)
    assert s["slices"] * s["per_slice"] >= 106_491
    small = launch_shape(8, 563, 3600, 83, 132)
    assert small["slices"] == 1 and small["per_slice"] == 83
    mid = launch_shape(212, 563, 3600, 3 * THREADS + 1, 132)
    assert mid["slices"] == 4
    wide = launch_shape(462, 32 * 200, 3600, 106_491, 132)
    assert wide["tiles"] == 200 and wide["slices"] == 1
    one_word = launch_shape(30, 1, 30, 5000, 132)
    assert (one_word["bw"], one_word["tiles"]) == (4, 1)
    assert one_word["slices"] == -(-5000 // THREADS)
    assert launch_shape(0, 0, 3, 5, 132)["tiles"] == 0
