"""Port parity for the slice as a whole: the serving front door,
``TrieQueryEngine``, on the CPU against the reference engine (replicated
backend, Pallas kernels in interpret mode) at small size."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import array_trie as JA  # noqa: E402
from repro.core import synthetic as JS  # noqa: E402
from repro.serve.trie_engine import TrieQueryEngine as JaxEngine  # noqa: E402
from repro_torch.core.array_trie import FrozenTrie  # noqa: E402
from repro_torch.distributed.trie_sharding import (  # noqa: E402
    shard_device_trie,
)
from repro_torch.launch.mesh import TrieMesh  # noqa: E402
from repro_torch.serve import TrieQueryEngine  # noqa: E402


def _port(fz):
    return FrozenTrie.from_arrays({
        f.name: np.asarray(getattr(fz, f.name))
        for f in dataclasses.fields(JA.FrozenTrie)
    })


def _eq(got, want):
    assert set(got) == set(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("source", ["mined", "synthetic"])
def test_engine_matches_reference(source, frozen):
    if source == "mined":
        jf = frozen(0.25)
        n_items = int(jf.item_rank.shape[0])
        rng = np.random.RandomState(0)
        pairs = [(list(rng.randint(0, n_items, size=rng.randint(0, 3))),
                  list(rng.randint(0, n_items, size=rng.randint(1, 3))))
                 for _ in range(30)]
        pairs += [(list(jf.path_items(v)[:1]), list(jf.path_items(v)[1:]))
                  for v in range(1, jf.n_nodes)]
    else:
        arrs = JS.synthetic_csr_trie(1200, seed=4)
        jf = JS.frozen_from_arrays(arrs)
        n_items = int(arrs["edge_item"].max()) + 1
        q, al = JS.synthetic_search_queries(arrs, 64, 5, seed=2)
        pairs = [([int(x) for x in r[:a] if x >= 0],
                  [int(x) for x in r[a:] if x >= 0]) for r, a in zip(q, al)]
    jeng = JaxEngine(jf, mode="replicated")
    teng = TrieQueryEngine(_port(jf), device="cpu")
    _eq(teng.rule_search_batch(pairs), jeng.rule_search_batch(pairs))
    prefixes = [[], [0], [1, 2], [n_items + 1], [2]]
    for k, metric in ((3, "confidence"), (50, "conviction")):
        _eq(teng.top_k_rules_batch(prefixes, k, metric=metric),
            jeng.top_k_rules_batch(prefixes, k, metric=metric))
    items = [0, 1, 1, n_items + 2, -1, n_items - 1]
    for role in ("consequent", "antecedent", "any"):
        _eq(teng.rules_with(items, role=role, k=7, metric="leverage"),
            jeng.rules_with(items, role=role, k=7, metric="leverage"))
    got = teng.trie_reduce()
    want = JA.traverse_reduce(jf.device_arrays())
    assert float(got["n_rules"]) == float(want["n_rules"])
    assert float(got["confidence_max"]) == float(want["confidence_max"])
    np.testing.assert_allclose(float(got["mean_conf"]),
                               float(want["mean_conf"]), rtol=1e-6)


def test_engine_rejects_later_slices(frozen):
    # streaming tries (slice 4) and sharded plans (slice 6) are served
    # now (tests/test_torch_streaming.py, tests/test_torch_sharding.py);
    # anything else is no trie at all, and an unknown mode is the
    # reference's ValueError
    with pytest.raises(TypeError, match="FrozenTrie or a StreamingTrie"):
        TrieQueryEngine(object(), device="cpu")
    fz = _port(frozen(0.25))
    with pytest.raises(ValueError, match="'nope'"):
        TrieQueryEngine(fz, device="cpu", mode="nope")
    want = JaxEngine(frozen(0.25), mode="replicated").rules_with([0, 1], k=3)
    # "auto" and "replicated" serve on the one device; the sharded mode,
    # a mesh and a plan answer through a ShardPlan, bitwise alike
    for mode in ("auto", "replicated"):
        eng = TrieQueryEngine(fz, device="cpu", mode=mode)
        assert eng.plan is None and eng.backend == "replicated"
        assert eng.n_shards == 1 and eng.device == torch.device("cpu")
        _eq(eng.rules_with([0, 1], k=3), want)
    mesh = TrieMesh(["cpu"] * 3)
    plan = shard_device_trie(fz, mesh)
    for kw, p in ((dict(mode="sharded"), 1), (dict(mode="sharded", mesh=mesh), 3),
                  (dict(plan=plan), 3)):
        eng = TrieQueryEngine(fz, device="cpu", **kw)
        assert eng.backend == "sharded" and eng.n_shards == p
        assert eng.dt is None and eng.device == torch.device("cpu")
        _eq(eng.rules_with([0, 1], k=3), want)
        with pytest.raises(NotImplementedError, match="ShardPlan"):
            eng.trie_reduce()
    # "auto" with a mesh shards only a trie past the threshold
    assert TrieQueryEngine(fz, device="cpu", mesh=mesh).backend == \
        "replicated"
    eng = TrieQueryEngine(fz, device="cpu", mesh=mesh,
                          shard_threshold_nodes=1)
    assert eng.backend == "sharded" and eng.plan.ranges == plan.ranges
