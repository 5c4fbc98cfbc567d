"""The seed layout's full-sweep kernel design (``csrc/rule_search.cu``:
edge fingerprints, per step a compacted list of the active rows, (row
tile, edge chunk) units split evenly over the match grid's warps, the
exact pair checked at a fingerprint hit, and the true matches merged by a
max of order-free keys) in its plain mirrors (``kernels/ref.py``), held
to the plain version ``ref.rule_search_sweep_ref`` and to the reference's
``rule_search_pallas`` in interpret mode.

Tolerance: none.  Against the plain version the comparison is bitwise.
Against the reference it is bitwise too, except the sign and payload of
a NaN answer: the reference's max returns whichever NaN XLA's reduction
order meets, the port the canonical quiet NaN (``ref.metric_key_ref``);
NaN stands where the reference has NaN.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rule_search import rule_search_pallas  # noqa: E402
from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.rule_search import (  # noqa: E402
    rule_search_sweep, sweep_launch_shape,
)

COLS = ("edge_parent", "edge_item", "edge_child", "edge_conf", "edge_sup",
        "edge_lift")
NAN = np.float32(np.nan)
# (parent, item) pairs with one fingerprint: parent * 0x9E3779B1 + item
# agrees mod 2^32
K = 0x9E3779B1
COLLIDE = (1, 5 - K + 2**32)   # shares (0, 5)'s fingerprint


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _eq(got, want, what, nan_any_bits=False):
    assert set(got) == set(want), what
    for key in want:
        w = want[key]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        g = got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
        if nan_any_bits and g.dtype == np.float32:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                          err_msg=f"{what} {key} NaN")
            keep = ~np.isnan(w)
            g, w = g[keep], w[keep]
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} {key}")


def _table(rows):
    """Edge columns from ``(parent, item, child, conf, sup, lift)``."""
    cols = list(zip(*rows))
    return [np.asarray(c, np.int32) for c in cols[:3]] + \
        [np.asarray(c, np.float32) for c in cols[3:]]


def _random(seed, n_nodes=400, n_items=20, q=60, width=6):
    rng = np.random.RandomState(seed)
    arrs = TS.random_csr_trie(rng, n_nodes, n_items, 4)
    queries, ant_len = TS.mixed_queries(rng, arrs, q, width)
    return [arrs[c] for c in COLS], queries, ant_len


def _case(name):
    """``(edge columns, queries, ant_len)`` of each edge case."""
    if name == "random":
        return _random(3)
    if name == "repeated":
        # (0, 1) three times: children 1, 2 and -3; (2, 5) twice; a
        # matched child below -1 alone at (1, 7)
        cols = _table([(0, 1, 1, .5, .2, 3.), (0, 1, 2, .25, .1, 1.),
                       (0, 1, -3, .75, .05, 2.), (2, 5, 3, .5, .3, 1.5),
                       (2, 5, 4, .9, .4, 2.5), (1, 5, 4, .9, .4, 2.5),
                       (0, 7, -4, .6, .6, .6)])
        q = np.array([[1, 5], [1, -1], [7, -1], [7, 5], [1, 7], [5, -1]],
                     np.int32)
        return cols, q, np.array([0, 1, 0, 1, 1, 0], np.int32)
    if name == "nan":
        # NaN of either sign, -0.0 and negative metrics, alone and
        # together in one match set
        cols = _table([(0, 1, 1, -NAN, .5, NAN), (0, 1, 1, .5, -NAN, -NAN),
                       (0, 2, 2, NAN, -0., -1.), (1, 3, 3, -0., -NAN, -0.),
                       (1, 3, 3, -1., NAN, -0.), (0, 4, 5, -0., -2., -NAN),
                       (2, 6, 6, -3., -0., 0.)])
        q = np.array([[1, 3], [2, -1], [4, -1], [-1, 1], [2, 6], [1, -1]],
                     np.int32)
        return cols, q, np.array([0, 0, 0, 0, 1, 1], np.int32)
    if name == "consequent":
        # consequent rows: the antecedent blanked to -1, a -1 gap inside,
        # and no active row at all in the first two steps
        cols, real, _ = _random(5, q=40, width=4)
        rows = np.full((real.shape[0], 7), -1, np.int32)
        rows[:, 2:6] = real
        gap = rows[::3]
        gap[:, 4:] = gap[:, 3:6].copy()
        gap[:, 3] = -1
        rows[::3] = gap
        return cols, rows, np.zeros((rows.shape[0],), np.int32)
    if name == "junk":
        cols, rows, al = _random(7, q=30, width=5)
        junk = np.where(rows >= 0, 10_000 + rows, -1).astype(np.int32)
        return cols, junk, al
    if name in ("e_small", "e_ragged"):
        n = 7 if name == "e_small" else 300
        cols, rows, al = _random(11, n_nodes=n + 1, n_items=6, q=50)
        assert cols[0].shape[0] == n
        return cols, rows, al
    if name == "q1":
        cols, rows, al = _random(13, q=3)
        return cols, rows[:1], al[:1]
    if name == "few_rows":
        # three active rows against 40 chunks: one tile, many splits
        cols, rows, al = _random(17, n_nodes=5001, n_items=40, q=3,
                                 width=4)
        return cols, rows, al
    if name == "collision":
        # (1, COLLIDE[1]) shares (0, 5)'s fingerprint: a row at the root
        # with item 5, and one at node 1 with item COLLIDE[1], each must
        # find only its own pair
        cols = _table([(0, 5, 1, .5, .5, .5), (1, COLLIDE[1], 2, .25, .3, 2.),
                       (0, 9, 1, .125, .1, 1.), (1, 5, 3, .75, .2, 4.)])
        q = np.array([[5, -1], [9, COLLIDE[1]], [9, 5], [COLLIDE[1], -1],
                      [5, 5]], np.int32)
        return cols, q, np.array([0, 1, 0, 0, 1], np.int32)
    raise KeyError(name)


CASES = ("random", "repeated", "nan", "consequent", "junk", "e_small",
         "e_ragged", "q1", "few_rows", "collision")


def test_collision_pair_shares_a_fingerprint():
    fp = ref.sweep_fingerprint_ref(torch.tensor([0, COLLIDE[0]]),
                                   torch.tensor([5, COLLIDE[1]],
                                                dtype=torch.int64))
    assert int(fp[0]) == int(fp[1])


def test_fingerprint_is_the_kernels_uint32_arithmetic():
    rng = np.random.RandomState(0)
    p = rng.randint(-2**31, 2**31 - 1, size=20_000).astype(np.int32)
    i = rng.randint(-2**31, 2**31 - 1, size=20_000).astype(np.int32)
    u32 = np.uint32
    with np.errstate(over="ignore"):
        h = p.astype(u32) * u32(K) + i.astype(u32)
        h ^= h >> u32(16)
        h *= u32(0x85EBCA6B)
        h ^= h >> u32(13)
        h *= u32(0xC2B2AE35)
        h ^= h >> u32(16)
    got = ref.sweep_fingerprint_ref(torch.from_numpy(p), torch.from_numpy(i))
    np.testing.assert_array_equal(got.numpy(), h.astype(np.int64))


def test_metric_key_orders_as_the_nan_max():
    vals = np.array([NAN, -NAN, -0., 0., -1., 2.5, np.inf, 1e-45, 3.],
                    np.float32)
    keys = ref.metric_key_ref(torch.from_numpy(vals)).numpy()
    assert keys.dtype == np.int32
    np.testing.assert_array_equal(
        keys.view(np.uint32),
        [0x7FC00000, 0x7FC00000, 0, 0, 0, 0x40200000, 0x7F800000, 1,
         0x40400000])
    # the max of keys over any subset is the NaN-propagating max over
    # {0.0} and the subset, in the canonical NaN's bits, +0.0 for a zero
    rng = np.random.RandomState(1)
    for _ in range(200):
        pick = rng.rand(vals.size) < 0.4
        got = np.int32(max([0, *keys[pick].tolist()])).view(np.float32)
        if np.isnan(vals[pick]).any():
            assert got.view(np.uint32) == 0x7FC00000
        else:
            want = np.float32(max([0.0, *vals[pick].tolist()]))
            assert got.view(np.uint32) == (want + np.float32(0)).view(
                np.uint32)


@pytest.mark.parametrize("n_active,n_chunks,warps", [
    (0, 5, 8), (1, 1, 4224), (3, 40, 64), (33, 7, 5), (100, 3, 1),
    (4352, 8192, 4224), (1800, 8192, 4224), (40, 8192, 4224)])
def test_segments_cover_every_unit_once(n_active, n_chunks, warps):
    """Every (tile, chunk) unit of a step in exactly one warp's
    segments, the warps' shares equal to within one share."""
    plan = ref.sweep_plan_ref(n_active, n_chunks, warps)
    segs = ref.sweep_segments_ref(n_active, n_chunks, warps)
    assert len(segs) == warps
    seen = np.zeros((plan["n_tiles"], n_chunks), np.int64)
    for mine in segs:
        assert sum(c1 - c0 for _, c0, c1 in mine) <= plan["per"]
        for t, c0, c1 in mine:
            assert 0 <= c0 < c1 <= n_chunks
            seen[t, c0:c1] += 1
    assert (seen == 1).all()
    assert plan["n_tiles"] == -(-n_active // ref.SWEEP_ROWS)
    shares = [sum(c1 - c0 for _, c0, c1 in m) for m in segs]
    if plan["total"]:
        assert shares[:plan["total"] // plan["per"]] == \
            [plan["per"]] * (plan["total"] // plan["per"])


def test_launch_shape():
    """The match grid fills 4 blocks an SM at the seed phase's shape and
    shrinks to the units a tiny call has; scratch is the padded table, a
    count per step and 9 words a row."""
    assert sweep_launch_shape(8192, 8, 1 << 20, 132) == {
        "n_chunks": 8192, "words": (1 << 20) + 8 + 9 * 8192,
        "match_blocks": 528, "warps": 4224}
    assert sweep_launch_shape(1, 2, 7, 132) == {
        "n_chunks": 1, "words": 128 + 4 + 9, "match_blocks": 1, "warps": 8}
    assert sweep_launch_shape(33, 5, 300, 132)["match_blocks"] == 1
    assert sweep_launch_shape(64, 5, 300 * 128, 132)["match_blocks"] == 75


@pytest.mark.parametrize("warps", [1, 3, 64, 4224])
@pytest.mark.parametrize("case", CASES)
def test_split_mirror_equals_plain(case, warps):
    """The design's mirror on a grid of ``warps`` warps == the plain
    version, bitwise."""
    cols, queries, ant_len = _case(case)
    t = [torch.as_tensor(c) for c in cols]
    qt, at = torch.as_tensor(queries), torch.as_tensor(ant_len)
    want = ref.rule_search_sweep_ref(*t, qt, at)
    got = ref.rule_search_sweep_split_ref(*t, qt, at, warps=warps)
    _eq(got, want, f"{case} warps={warps}")


@pytest.mark.parametrize("case", CASES)
def test_plain_and_wrapper_equal_the_reference(case):
    """The plain version (the wrapper on CPU tensors) == the reference's
    interpret-mode kernel (NaN payloads aside, see the module note)."""
    cols, queries, ant_len = _case(case)
    got = rule_search_sweep(*[torch.as_tensor(c) for c in cols],
                            torch.as_tensor(queries),
                            torch.as_tensor(ant_len))
    want = rule_search_pallas(*[jnp.asarray(c) for c in cols],
                              jnp.asarray(queries), jnp.asarray(ant_len),
                              interpret=True)
    _eq(got, {k: np.asarray(v) for k, v in want.items()}, case,
        nan_any_bits=case == "nan")
    if case in ("repeated", "collision", "random", "consequent"):
        assert got["found"].any()
    if case == "junk":
        assert not got["found"].any()


def test_collision_answers():
    """Each colliding pair finds only its own edge."""
    cols, queries, ant_len = _case("collision")
    got = ref.rule_search_sweep_split_ref(
        *[torch.as_tensor(c) for c in cols], torch.as_tensor(queries),
        torch.as_tensor(ant_len), warps=3)
    np.testing.assert_array_equal(got["node"].numpy(), [1, 2, 3, -1, 3])
    np.testing.assert_array_equal(
        got["support"].numpy(), np.array([.5, .3, .2, 0, .2], np.float32))
