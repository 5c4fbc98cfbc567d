"""The closed form of item membership (``ref.member_ranges_ref``), which
the membership kernel reads in place of a per-position test: per query,
the outermost posting ranges (antecedent, any) or the postings themselves
(consequent).  Held on the CPU to the laminar range count of
``ref.rules_with_ref`` (``ref.laminar_members``) position for position,
and, ranked, to the port's and the reference's ``rules_with_ref``
bitwise, on hub and chain tries with nested postings, plain and
compressed, with empty slices and absent, duplicate and negative items.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.core import synthetic as TS  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402
from repro_torch.kernels.metrics_inkernel import (  # noqa: E402
    dequantize_metrics, rank_score,
)

ROLES = TO.ROLES
TRIES = {
    "hub": lambda: TS.synthetic_csr_trie(1 << 12, seed=0),
    "chain": lambda: TS.synthetic_chain_trie(3000, chain_fraction=0.75,
                                             seed=3),
    "branchy": lambda: TS.synthetic_chain_trie(2000, chain_fraction=0.3,
                                               seed=7),
    "random": lambda: TS.random_csr_trie(np.random.RandomState(21), 700, 24),
}


@pytest.fixture(scope="module")
def item_arrays():
    """Per trie and layout: the item-index arrays on the CPU and a query
    batch -- every item id, then absent (sanitized to the empty slice and
    id -1), duplicate and raw negative items."""
    out = {}
    for name, make in TRIES.items():
        fz = TS.frozen_from_arrays(make())
        for layout in ("plain", "compressed"):
            trie = fz if layout == "plain" else fz.device_arrays(
                device="cpu", layout="compressed")
            ia = TO.item_rank_arrays(trie, device="cpu")
            n_items = ia["item_offsets"].shape[0] - 1
            items = list(range(n_items)) + [-1, n_items + 7, 0, 3, 0]
            plos, phis, qitems = (torch.from_numpy(a) for a in
                                  TO._posting_slices(ia["item_offsets"],
                                                     items))
            # a raw negative id with an empty slice, as a direct caller
            # of the kernel may pass it
            plos = torch.cat([plos, torch.tensor([0], dtype=torch.int32)])
            phis = torch.cat([phis, torch.tensor([0], dtype=torch.int32)])
            qitems = torch.cat([qitems,
                                torch.tensor([-5], dtype=torch.int32)])
            out[name, layout] = (ia, plos, phis, qitems)
    return out


def _nested_postings(ia):
    """Postings whose range lies inside an earlier one of the same item."""
    off = ia["item_offsets"]
    lo, hi = ia["post_lo"], ia["post_hi"]
    return sum(int((hi[a:b - 1] > lo[a + 1:b]).sum())
               for a, b in zip(off[:-1], off[1:]) if b > a)


def _ranges_mask(query, lo, hi, q, n):
    """``bool[q, n]``: the positions the ``(query, lo, hi)`` ranges cover."""
    edge = torch.zeros((q, n + 1), dtype=torch.int32)
    one = torch.ones_like(lo, dtype=torch.int32)
    edge.index_put_((query, lo), one, accumulate=True)
    edge.index_put_((query, hi), -one, accumulate=True)
    return edge.cumsum(1)[:, :n] > 0


def _closed_form_mask(ia, plos, phis, items, role):
    ranges = TREF.member_ranges_ref(ia["post_lo"], ia["post_hi"], plos,
                                    phis, items, ia["node_item"], role)
    return _ranges_mask(*ranges, plos.shape[0], ia["node_item"].shape[0])


@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("layout", ["plain", "compressed"])
@pytest.mark.parametrize("trie", sorted(TRIES))
def test_closed_form_members_equal_laminar_count(item_arrays, trie, layout,
                                                 role):
    ia, plos, phis, items = item_arrays[trie, layout]
    if trie in ("hub", "chain"):
        assert _nested_postings(ia) > 0
    want = TREF.laminar_members(ia["node_item"], ia["post_lo"],
                                ia["post_hi"], plos, phis, items, role)
    got = _closed_form_mask(ia, plos, phis, items, role)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    # the absent item -1 holds only the root, as a consequent
    absent = int(np.flatnonzero(items.numpy() == -1)[0])
    want_root = role == "consequent" and int(ia["node_item"][0]) == -1
    assert got[absent].nonzero()[:, 0].tolist() == ([0] if want_root else [])
    assert not got[-1].any()  # id -5: no node carries it


@pytest.mark.parametrize("min_depth", [0, 1, 5])
@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("trie", sorted(TRIES))
def test_closed_form_ranking_matches_reference(item_arrays, trie, role,
                                               min_depth):
    """Ranked over the closed-form members, every row equals the port's
    and the reference's ``rules_with_ref``, bitwise, on the compressed
    layout's quantized-free f32 columns and the plain layout's."""
    for layout in ("plain", "compressed"):
        ia, plos, phis, items = item_arrays[trie, layout]
        dq = TO._dequant_statics(ia)
        args = (ia["support"], ia["confidence"], ia["lift"], ia["depth"],
                ia["node_item"], ia["post_lo"], ia["post_hi"], plos, phis,
                items)
        kw = dict(k=7, metric="lift", min_depth=min_depth, role=role, **dq)
        score = rank_score("lift", *dequantize_metrics(
            ia["support"], ia["confidence"], ia["lift"],
            dq["n_transactions"], dq["confidence_scale"], dq["lift_scale"]))
        mask = _closed_form_mask(ia, plos, phis, items, role) & (
            ia["depth"] >= min_depth)
        got = TREF._rank_rows(score, lambda r0, r1: mask[r0:r1],
                              plos.shape[0], 7)
        port = TREF.rules_with_ref(*args, **kw)
        refj = JREF.rules_with_ref(*(jnp.asarray(a.numpy()) for a in args),
                                   **kw)
        for g, p, j in zip(got, port, refj):
            j = np.asarray(j)
            assert g.dtype == p.dtype and g.numpy().dtype == j.dtype
            if g.dtype == torch.float32:
                g, p, j = g.view(torch.int32), p.view(torch.int32), \
                    j.view(np.int32)
            assert torch.equal(g, p)
            np.testing.assert_array_equal(g.numpy(), j)


@pytest.mark.parametrize("role,want", [
    ("any", [(0, 1, 8), (0, 9, 10), (1, 12, 14)]),
    ("antecedent", [(0, 2, 8), (1, 13, 14)]),
    ("consequent", [(0, 1, 2), (0, 2, 3), (0, 5, 6), (0, 9, 10),
                    (1, 12, 13), (2, 0, 1)]),
])
def test_outermost_rule_on_hand_slices(role, want):
    """Item 4's postings at 1, 2, 5 and 9: the ranges [2, 4) and [5, 6)
    nest in [1, 8), and [9, 10) is a leaf (no antecedent members).  Item
    7 has one posting, [12, 14).  Query 2 is the absent item -1, whose
    consequent row is the root; query 3 an empty slice of a real item."""
    post_lo = torch.tensor([1, 2, 5, 9, 12], dtype=torch.int32)
    post_hi = torch.tensor([4, 6, 8, 10, 14], dtype=torch.int32)
    node_item = torch.full((15,), 3, dtype=torch.int32)
    node_item[0] = -1
    node_item[post_lo[:4].long()] = 4
    node_item[12] = 7
    plos = torch.tensor([0, 4, 0, 5], dtype=torch.int32)
    phis = torch.tensor([4, 5, 0, 5], dtype=torch.int32)
    items = torch.tensor([4, 7, -1, 9], dtype=torch.int32)
    got = TREF.member_ranges_ref(post_lo, post_hi, plos, phis, items,
                                 node_item, role)
    assert [tuple(int(x) for x in r) for r in zip(*got)] == want
    assert torch.equal(
        _ranges_mask(*got, 4, 15),
        TREF.laminar_members(node_item, post_lo, post_hi, plos, phis, items,
                             role))


@pytest.mark.parametrize("role", ROLES)
def test_closed_form_with_no_queries(role):
    empty = torch.zeros((0,), dtype=torch.int32)
    post = torch.tensor([1, 2], dtype=torch.int32)
    got = TREF.member_ranges_ref(post, post + 1, empty, empty, empty,
                                 torch.tensor([-1, 0, 1], dtype=torch.int32),
                                 role)
    assert all(t.shape == (0,) for t in got)
    assert _ranges_mask(*got, 0, 3).shape == (0, 3)
