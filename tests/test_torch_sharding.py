"""Port parity for the sharded trie, part one: the three sharded ops,
the partitioning, the prefix descent and the k-best merge, on the CPU
(``tests/test_torch_sharding_plans.py`` holds the plans themselves and
the engine, ladder and stream over them).

A ``TrieMesh(["cpu"] * P)`` puts P shards on the CPU, where every kernel
wrapper runs its plain version.  The sharded ops at P in {1, 2, 3, 8} are
held to the reference's single-device ops (its Pallas kernels in
interpret mode) on plain, compressed f32, int32+bf16 and int32+int8
tries, with empty and uneven shards, Q = 0, the empty trie, the mined
paper DB and compound consequents whose consequent path lies on another
shard.  The host partitioning is held to the reference's functions at
every P in 1..8.

Tolerance: bitwise everywhere (values as f32 bits, node ids, positions,
tie order and dtypes).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.arm.datasets import paper_example_db as j_paper_db  # noqa: E402
from repro.core import array_trie as JA  # noqa: E402
from repro.core import synthetic as JS  # noqa: E402
from repro.core.builder import build_trie_of_rules as j_rules  # noqa: E402
from repro.core.trie import TrieOfRules  # noqa: E402
from repro.distributed import trie_sharding as JSH  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.kernels.tuning import tuning_overrides  # noqa: E402
from repro_torch.core import array_trie as TA  # noqa: E402
from repro_torch.distributed import trie_sharding as TSH  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch.mesh import TrieMesh  # noqa: E402

ROLES = ("consequent", "antecedent", "any")
N_TX = 1000
LAYOUTS = {
    "plain": dict(),
    "f32": dict(layout="compressed"),
    "i32+bf16": dict(layout="compressed", quantize=True, n_transactions=N_TX),
    "i32+int8": dict(layout="compressed", quantize=True, n_transactions=N_TX,
                     columns="int8"),
}
# (trie, layout) cells of the op parity test: every layout on the random
# and chain tries, the plain layout on the others
CELLS = [(t, lay) for t in ("random", "chain") for lay in LAYOUTS] + \
    [("uneven", "plain"), ("mined", "plain")]
P_COUNTS = (1, 2, 3, 8)


@pytest.fixture(scope="module", autouse=True)
def pure_pow2_pads():
    """The reference under pure power-of-two launch pads, as the port's
    ``launch_pad`` has them (pads move no answer)."""
    with tuning_overrides(launch_pad_floor=1):
        yield


def _port(fz):
    return TA.FrozenTrie.from_arrays({
        f.name: np.asarray(getattr(fz, f.name))
        for f in dataclasses.fields(JA.FrozenTrie)
    })


def _np(x):
    """numpy view of a port tensor or reference array; bf16 as its bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _same(got, want, what=""):
    g, w = _np(got), _np(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype,
                                                       w.dtype, g.shape,
                                                       w.shape)
    if g.dtype == np.float32:
        g, w = g.view(np.uint32), w.view(np.uint32)
    np.testing.assert_array_equal(g, w, err_msg=what)


def _same_dict(got, want, what=""):
    assert set(got) == set(want), what
    for key in want:
        _same(got[key], want[key], f"{what} {key}")


def _chain_arrays():
    """Few depth-1 subtrees (five), long chains: at P = 8 three shards
    are empty."""
    return JS.synthetic_chain_trie(300, chain_fraction=0.7, root_fanout=5,
                                   seed=0)


def _random_arrays():
    return JS.random_csr_trie(np.random.RandomState(7), 160, 10)


@pytest.fixture(scope="module")
def tries():
    """Reference FrozenTries: irregular, chain-heavy, uneven (three
    items, binary fanout) and the paper DB mined at minsup 0.2."""
    return {
        "random": JS.frozen_from_arrays(_random_arrays()),
        "chain": JS.frozen_from_arrays(_chain_arrays()),
        "uneven": JS.frozen_from_arrays(JS.random_csr_trie(
            np.random.RandomState(5), 60, 3, max_children=2)),
        "mined": JA.FrozenTrie.freeze(j_rules(j_paper_db(), 0.2).trie),
    }


def _traffic(jf, seed):
    """Search rows, ragged pairs (compound consequents whose consequent
    path starts at another depth-1 subtree among them), prefixes and
    items for one trie."""
    rng = np.random.RandomState(seed)
    n_items = int(jf.item_rank.shape[0])
    n = jf.n_nodes
    # path prefixes of at most 6 items keep the reference's interpret-mode
    # descents short on the deep chain trie
    paths = [list(jf.path_items(int(v)))[:6]
             for v in rng.randint(1, max(n, 2), size=24)] if n > 1 else []
    width = max([len(p) for p in paths] + [2]) + 1
    rows, al = [], []
    for p in paths:
        rows.append(p + [-1] * (width - len(p)))
        al.append(int(rng.randint(0, len(p) + 1)))
        junk = list(p)
        junk[int(rng.randint(0, len(p)))] = int(rng.randint(0, n_items + 2))
        rows.append(junk + [-1] * (width - len(junk)))
        al.append(int(rng.randint(0, len(junk))))
    rows.append([-1] * width)
    al.append(0)
    queries = np.asarray(rows, np.int32)
    ant_len = np.asarray(al, np.int32)
    pairs = [(p[:1], p[1:]) for p in paths[:8]]
    # the consequent path (its first items) may sit on another shard than
    # the rule's main path
    deep = [p for p in paths if len(p) >= 3][:6]
    pairs += [((p[-1],), tuple(p[:2])) for p in deep]
    pairs += [((), (0,)), ((n_items + 3,), (0,)), ((0, 1), ())]
    # prefixes already in frequency order: a DeviceTrie (the reference's
    # compressed single-device op) has no item ranks to sort by, a plan
    # sorts by its FrozenTrie's
    nr = int(jf.item_rank.shape[0])

    def rank(it):
        return (int(jf.item_rank[it]) if 0 <= it < nr else 1 << 30, it)

    cut = [p[: 1 + i % 3] for i, p in enumerate(paths)]
    prefixes = [[], [n_items + 1], [-1]] + [
        c for c in cut if c == sorted(c, key=rank)][:9]
    items = list(range(n_items)) + [0, 1, -1, n_items + 2]
    return queries, ant_len, pairs, prefixes, items


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device answers per (trie, layout), built
    once and held against every P."""
    cache = {}

    def get(tries, trie, layout):
        key = (trie, layout)
        if key not in cache:
            jf = tries[trie]
            jd = jf.device_arrays(**LAYOUTS[layout])
            q, al, pairs, prefixes, items = _traffic(jf, 3)
            metric = ("lift", "leverage", "conviction",
                      "support")[list(LAYOUTS).index(layout)]
            out = {
                "search": JO.rule_search_batch(jd, q, al),
                "pairs": JO.rule_search_batch(jf, pairs)
                if layout == "plain" else None,
                "topk": JO.top_k_rules_batch(jd, prefixes, 40,
                                             metric=metric),
            }
            for role in ROLES:
                out[role] = JO.rules_with(jd, items, role=role, k=6,
                                          metric=metric)
            cache[key] = (out, metric)
        return cache[key]

    return get


@pytest.mark.parametrize("p", P_COUNTS)
@pytest.mark.parametrize("trie,layout", CELLS)
def test_sharded_ops_match_reference(tries, reference, trie, layout, p):
    jf = tries[trie]
    tf = _port(jf)
    want, metric = reference(tries, trie, layout)
    plan = TSH.shard_device_trie(tf, TrieMesh(["cpu"] * p),
                                 **LAYOUTS[layout])
    assert plan.n_shards == p and plan.trie.layout == (
        "plain" if layout == "plain" else "compressed")
    q, al, pairs, prefixes, items = _traffic(jf, 3)
    what = f"{trie} {layout} P={p}"
    _same_dict(TO.rule_search_batch(plan, q, al), want["search"],
               f"{what} search")
    if want["pairs"] is not None:
        _same_dict(TO.rule_search_batch(plan, pairs), want["pairs"],
                   f"{what} pairs")
    _same_dict(TO.top_k_rules_batch(plan, prefixes, 40, metric=metric),
               want["topk"], f"{what} topk")
    for role in ROLES:
        _same_dict(TO.rules_with(plan, items, role=role, k=6, metric=metric),
                   want[role], f"{what} {role}")
    if trie == "chain" and p == 8:
        # five depth-1 subtrees over eight shards: some are empty
        assert any(sh.dfs_len == 0 for sh in plan.trie.shards)


@pytest.mark.parametrize("p", P_COUNTS)
def test_q_zero_and_empty_trie(p):
    arrs = _random_arrays()
    tf = _port(JS.frozen_from_arrays(arrs))
    plan = TSH.shard_device_trie(tf, TrieMesh(["cpu"] * p))
    assert TO.rules_with(plan, [], k=3)["values"].shape == (0, 3)
    assert TO.top_k_rules_batch(plan, [], 3)["values"].shape == (0, 3)
    assert TO.rule_search_batch(plan, [])["found"].shape == (0,)
    jempty = JA.FrozenTrie.freeze(TrieOfRules())
    plan = TSH.shard_device_trie(_port(jempty), TrieMesh(["cpu"] * p))
    jd = jempty.device_arrays()
    pairs = [((0,), (1,))]
    _same_dict(TO.rule_search_batch(plan, pairs),
               JO.rule_search_batch(jempty, pairs), "empty search")
    _same_dict(TO.top_k_rules_batch(plan, [[], [0]], 4),
               JO.top_k_rules_batch(jd, [[], [0]], 4), "empty topk")
    out = TO.rules_with(plan, [0, -1], k=4)
    assert (out["node"].numpy() == -1).all()


# ----------------------------------------------------------------------
# partitioning (host functions, callable at any P)
# ----------------------------------------------------------------------
def test_depth1_subtrees_match_reference(tries):
    for name, jf in tries.items():
        for g, w in zip(_port(jf).depth1_subtrees(), jf.depth1_subtrees()):
            _same(g, w, name)
    # the pointer oracle, on the port's own mined trie
    from repro_torch.arm.datasets import paper_example_db
    from repro_torch.core.builder import build_trie_of_rules

    res = build_trie_of_rules(paper_example_db(), 0.2)
    fz = TA.FrozenTrie.freeze(res.trie)
    kids, los, sizes = fz.depth1_subtrees()
    oracle = res.trie.depth1_subtree_sizes()
    assert [int(fz.node_item[v]) for v in kids] == [it for it, _ in oracle]
    assert sizes.tolist() == [s for _, s in oracle]
    assert los.tolist() == (1 + np.concatenate(
        [[0], np.cumsum(sizes)[:-1]])).tolist()


@pytest.mark.parametrize("p", range(1, 9))
def test_partitioning_matches_reference(tries, p):
    rng = np.random.RandomState(p)
    for _ in range(12):
        sizes = rng.randint(1, 60, size=rng.randint(0, 14))
        if sizes.size and rng.rand() < 0.3:
            sizes[rng.randint(sizes.size)] *= 40      # a hub subtree
        want = JSH.plan_shard_bounds(sizes, p)
        assert TSH.plan_shard_bounds(sizes, p) == want
        hubs = {t: list(rng.randint(1, 20, size=rng.randint(0, 6)))
                for t in range(sizes.size)}
        assert TSH.plan_shard_bounds(sizes, p, hubs, 1.2) == \
            JSH.plan_shard_bounds(sizes, p, hubs, 1.2)
        prev = JSH.plan_shard_bounds(np.roll(sizes, 1), p)
        for drift in (0.0, 0.5, 10.0):
            assert TSH.plan_shard_bounds(sizes, p, prev_bounds=prev,
                                         drift=drift) == \
                JSH.plan_shard_bounds(sizes, p, prev_bounds=prev,
                                      drift=drift)
    for name, jf in tries.items():
        tf = _port(jf)
        want = JSH.shard_dfs_ranges(jf, p)
        assert TSH.shard_dfs_ranges(tf, p) == want, name
        assert TSH.hub_child_buckets(tf) == JSH.hub_child_buckets(jf)
        # the drift gate: cuts of another P, or shifted off the subtree
        # boundaries, and drifts that keep or drop them
        for prev in (JSH.shard_dfs_ranges(jf, max(p - 1, 1)), want,
                     [(lo, hi + 1) for lo, hi in want]):
            for drift in (0.0, 0.3, 5.0):
                assert TSH.shard_dfs_ranges(tf, p, prev, drift) == \
                    JSH.shard_dfs_ranges(jf, p, prev, drift), (name, prev)


def test_host_prefix_ranges_match_reference(tries):
    for name, jf in tries.items():
        _, _, _, prefixes, _ = _traffic(jf, 5)
        mat = np.asarray([[0, -1], [1, 2], [-1, -1], [2, 0]], np.int32)
        for pre in (prefixes, mat):
            for g, w in zip(TSH.host_prefix_ranges(_port(jf), pre),
                            JSH.host_prefix_ranges(jf, pre)):
                _same(g, w, name)


@pytest.mark.parametrize("case", ["ties", "inf", "nan", "wide"])
def test_merge_kbest_matches_reference(case):
    """Per-shard k-best lists [P, Q, k], each (value desc, pos asc) with
    positions distinct across shards, folded by the port and by the
    reference's ``jnp`` merge."""
    rng = np.random.RandomState(len(case))
    p, q, k = (3, 5, 7) if case != "wide" else (4, 3, 130)
    vals = np.round(rng.rand(p, q, k).astype(np.float32) * 4) / 4
    if case == "inf":
        vals[rng.rand(p, q, k) < 0.4] = -np.inf
    if case == "nan":
        vals[0, 1, 2] = np.nan
        vals[2, 3, 0] = np.float32(-0.0)
        vals[1, 3, 0] = np.float32(0.0)
    pos = np.arange(p * q * k, dtype=np.int32).reshape(p, q, k)
    rng.shuffle(pos.reshape(-1))
    for d in range(p):
        for r in range(q):
            order = np.lexsort((pos[d, r], -np.nan_to_num(vals[d, r],
                                                         nan=np.inf)))
            vals[d, r], pos[d, r] = vals[d, r][order], pos[d, r][order]
    pos = np.where(np.isneginf(vals), -1, pos).astype(np.int32)
    got = TSH.merge_kbest(torch.from_numpy(vals), torch.from_numpy(pos), k)
    want = JSH.merge_kbest(jnp.asarray(vals), jnp.asarray(pos), k)
    for g, w in zip(got, want):
        _same(g, w, case)


def _compound_cases(jf):
    """(path, antecedent length, consequent node) of every rule whose
    compound consequent (two items or more) is itself a path from the
    root: its Support is the search's ``con_support``."""
    paths = {jf.path_items(v): v for v in range(1, jf.n_nodes)}
    return [(path, j, paths[path[j:]]) for path in paths
            for j in range(1, len(path) - 1) if path[j:] in paths]


@pytest.mark.parametrize("p", [2, 3, 8])
def test_con_support_fold_matches_reference(p):
    """NaN, -0.0 and +0.0 consequent-path Supports through the sharded
    search's ``con_support`` fold: the fold alone equals the reference's
    ``jnp.max`` over P bitwise, shard order and signed zeros included,
    and the sharded search with such Supports planted on the random trie
    (consequent paths on other shards than their rules) equals the
    reference's single-device op bitwise."""
    rng = np.random.RandomState(p)
    csup = rng.rand(p, 9).astype(np.float32)
    csup[:, :4] = 0.0
    csup[0, 0] = np.float32(-0.0)          # -0.0 first, +0.0 after
    csup[p - 1, 1] = np.float32(-0.0)      # +0.0 first, -0.0 after
    csup[:, 2] = np.float32(-0.0)
    csup[p // 2, 3] = np.nan
    csup[p - 1, 4] = np.nan
    csup[0, 5] = np.float32(-1.0)
    _same(TSH.fold_con_support(torch.from_numpy(csup)),
          jnp.max(jnp.asarray(csup), axis=0), f"fold P={p}")

    jf = JS.frozen_from_arrays(_random_arrays())
    cases = _compound_cases(jf)
    sup = np.asarray(jf.support, np.float32).copy()
    for (_, _, con), val in zip(cases, (np.nan, -0.0, 0.0, np.nan, -0.0)):
        sup[con] = np.float32(val)
    jf = dataclasses.replace(jf, support=sup)
    width = max(len(path) for path, _, _ in cases)
    q = np.asarray([list(path) + [-1] * (width - len(path))
                    for path, _, _ in cases], np.int32)
    al = np.asarray([j for _, j, _ in cases], np.int32)
    plan = TSH.shard_device_trie(_port(jf), TrieMesh(["cpu"] * p))
    cut = [hi for _, hi in plan.ranges]

    heads = {jf.path_items(v): v for v in range(1, jf.n_nodes)}

    def shard(item):
        pos = int(jf.dfs_order[heads[(item,)]])
        return int(np.searchsorted(cut, pos, side="right"))

    if p == 8:
        # some planted consequent paths start on another shard
        assert any(shard(path[0]) != shard(path[j])
                   for path, j, _ in cases[:5])
    _same_dict(TO.rule_search_batch(plan, q, al),
               JO.rule_search_batch(jf.device_arrays(), q, al),
               f"planted P={p}")
