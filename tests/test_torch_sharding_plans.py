"""Port parity for the sharded trie, part two: ``shard_device_trie``'s
plans field by field, ``mask_dead_shards``, the mesh, and the engine,
resilience ladder and stream over a plan, on the CPU (the helpers and
tries are ``tests/test_torch_sharding.py``'s).

The P = 1 plan is held to the reference's ``shard_device_trie(fz,
make_trie_mesh(1))`` field by field.  The reference's P = 2 and 8 plans,
its masked plan's answers and its stream over a three-device mesh need
eight devices: one module-scoped subprocess builds them under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` and writes an
``.npz``.

Tolerance: bitwise everywhere (values as f32 bits, node ids, positions,
tie order and dtypes).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as J  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from repro.core import synthetic as JS  # noqa: E402
from repro.distributed import trie_sharding as JSH  # noqa: E402
from repro.launch.mesh import make_trie_mesh  # noqa: E402
from repro_torch.core import array_trie as TA  # noqa: E402
from repro_torch.core.delta_trie import StreamingTrie  # noqa: E402
from repro_torch.distributed import trie_sharding as TSH  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch.mesh import TrieMesh  # noqa: E402
from repro_torch.launch.mesh import make_trie_mesh as t_make_mesh  # noqa: E402
from repro_torch.serve.trie_engine import make_trie_engine  # noqa: E402
from test_torch_sharding import (  # noqa: E402
    LAYOUTS,
    ROLES,
    _chain_arrays,
    _np,
    _port,
    _random_arrays,
    _same,
    _same_dict,
    _traffic,
    pure_pow2_pads,  # noqa: F401  (autouse: the reference's pads)
    tries,  # noqa: F401  (fixture)
)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


# ----------------------------------------------------------------------
# residency: the plan against the reference's, field by field
# ----------------------------------------------------------------------
_FILLS = TSH._MASK_FILLS


def _plan_fields_equal(plan, ref, what):
    """``ref`` maps each reference leaf name to its [P, ...] array: every
    port shard tensor equals the reference row's prefix, and the rest of
    the row is the reference's padding."""
    st = plan.trie
    for d, sh in enumerate(st.shards):
        for name in TSH._LEAVES:
            g = _np(getattr(sh, name))
            row = _np(ref[name])[d]
            _same(g, row[: g.shape[0]], f"{what} shard {d} {name}")
            tail = row[g.shape[0]:]
            if name == "child_offsets":
                assert (tail == row[g.shape[0] - 1]).all(), (what, name)
            else:
                fill = np.asarray(_FILLS[name]).astype(row.dtype)
                assert (tail == fill).all(), (what, d, name)
        assert sh.dfs_base == int(_np(ref["dfs_base"])[d])
        assert sh.dfs_len == int(_np(ref["dfs_len"])[d])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_shard_plan_matches_reference(tries, layout):
    for name in ("random", "chain", "mined"):
        jf = tries[name]
        want = JSH.shard_device_trie(jf, make_trie_mesh(1),
                                     **LAYOUTS[layout])
        got = TSH.shard_device_trie(_port(jf), TrieMesh(["cpu"]),
                                    **LAYOUTS[layout])
        _plan_fields_equal(got, {f: getattr(want.trie, f) for f in
                                 JSH.ShardedDeviceTrie._LEAVES},
                           f"{name} {layout}")
        assert got.ranges == want.ranges
        _same(got.local_item_offsets, want.local_item_offsets)
        _same(got.gbase, want.gbase)
        _same(got.trie.g_dfs_to_node, want.trie.g_dfs_to_node)
        _same(got.trie.g_item_nodes, want.trie.g_item_nodes)
        for f in ("max_fanout", "max_postings", "layout", "n_transactions",
                  "confidence_scale", "lift_scale"):
            assert getattr(got.trie, f) == getattr(want.trie, f), f


# the reference at P = 2 and 8 (and a mask of {1, 5}) needs eight devices
_REF_SCRIPT = r"""
import sys
import numpy as np
from repro.core import synthetic as S
from repro.distributed.trie_sharding import (ShardedDeviceTrie,
    mask_dead_shards, shard_device_trie)
from repro.kernels import ops
from repro.launch.mesh import make_trie_mesh
out = {}
def host(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a
cells = {
    "random": (S.random_csr_trie(np.random.RandomState(7), 160, 10), {}),
    "chain": (S.synthetic_chain_trie(300, chain_fraction=0.7,
                                     root_fanout=5, seed=0),
              dict(layout="compressed", quantize=True, n_transactions=1000)),
}
for name, (arrs, kw) in cells.items():
    fz = S.frozen_from_arrays(arrs)
    for p in (2, 8):
        plan = shard_device_trie(fz, make_trie_mesh(p), **kw)
        tag = f"{name}/{p}/"
        out[tag + "ranges"] = np.asarray(plan.ranges, np.int64)
        out[tag + "local_item_offsets"] = plan.local_item_offsets
        out[tag + "gbase"] = plan.gbase
        out[tag + "max_fanout"] = np.asarray(plan.trie.max_fanout)
        for leaf in ShardedDeviceTrie._LEAVES:
            out[tag + leaf] = host(getattr(plan.trie, leaf))
        if p != 8:
            continue
        m = mask_dead_shards(plan, [1, 5])
        n_items = int(fz.item_rank.shape[0])
        items = list(range(n_items)) + [-1, n_items + 2, 0]
        for role in ("consequent", "antecedent", "any"):
            for key, v in ops.rules_with(m, items, role=role, k=5).items():
                out[f"{tag}mask/{role}/{key}"] = host(v)
        prefixes = [[], [0], [1], [2, 3], [n_items + 1]]
        for key, v in ops.top_k_rules_batch(m, prefixes, 6,
                                            metric="lift").items():
            out[f"{tag}mask/top_k/{key}"] = host(v)
        q, al = S.synthetic_search_queries(arrs, 64, 5, seed=2)
        for key, v in ops.rule_search_batch(m, q, al).items():
            out[f"{tag}mask/search/{key}"] = host(v)
# the stream over a three-shard mesh, on the test's own base and inserts
import json
from repro.core.array_trie import FrozenTrie
from repro.core.delta_trie import StreamingTrie
inp = np.load(sys.argv[2])
case = json.loads(str(inp["case"]))
base = FrozenTrie(**{k[5:]: inp[k].item() if inp[k].ndim == 0 else inp[k]
                     for k in inp.files if k.startswith("base/")})
st = StreamingTrie(base, mesh=make_trie_mesh(3), refreeze_max_delta=4)
st.insert(case["rows"], case["sup"], case["conf"], case["lift"])
q = np.asarray(case["q"], np.int32)
al = np.asarray(case["al"], np.int32)
pairs = [(tuple(a), tuple(c)) for a, c in case["pairs"]]
for step in range(3):
    tag = f"stream/{step}/"
    # answers before any fold and after the first (each step's ops
    # compile anew, ~7 s); the cuts and owners of all three
    if step < 2:
        answers = {"search": ops.rule_search_batch(st, q, al),
                   "pairs": ops.rule_search_batch(st, pairs),
                   "topk": ops.top_k_rules_batch(st, case["prefixes"], 6,
                                                 metric="leverage")}
        for role in ("consequent", "antecedent", "any"):
            answers[role] = ops.rules_with(st, case["items"], role=role,
                                           k=5)
        for name, res in answers.items():
            for key, v in res.items():
                out[f"{tag}{name}/{key}"] = host(v)
    out[tag + "ranges"] = np.asarray(st.shard_plan().ranges, np.int64)
    out[tag + "owner"] = np.asarray([st.owner_shard(p)
                                     for p in case["probes"]], np.int64)
    folded = st.maybe_refreeze()
    out[tag + "folded"] = np.asarray(-1 if folded is None else folded)
    out[tag + "refolded"] = np.asarray(st.shard_plan().ranges, np.int64)
np.savez(sys.argv[1], **out)
"""


def _all_paths(fz):
    return {fz.path_items(v): v for v in range(1, fz.n_nodes)}


def _stream_case():
    """A base built from a small mined DB, the rules the full build adds
    to it and two updates of frozen rules, the traffic over the full
    trie, and the paths whose owner shard is probed."""
    from repro_torch.arm.rulegen import sample_rule_sequences
    from repro_torch.arm.transactions import TransactionDB
    from repro_torch.core.build_arrays import build_frozen_trie

    rng = np.random.RandomState(3)
    txs = [sorted({int(x) for x in rng.randint(0, 12,
                                                size=rng.randint(1, 6))})
           for _ in range(40)]
    db = TransactionDB(txs, n_items=12)
    seqs = sample_rule_sequences(db, 60, seed=1)
    base, _, _ = build_frozen_trie(db, seqs[:30], use_kernel=False)
    full, _, _ = build_frozen_trie(db, seqs, use_kernel=False)
    bp, fp = _all_paths(base), _all_paths(full)
    novel = sorted((p for p in fp if p not in bp),
                   key=lambda p: (len(p), p))[:12]
    assert novel
    rows = [(list(p), fp[p]) for p in novel]
    # two updates of frozen rules: their stale copies must stop ranking
    rows += [(list(p), fp[p]) for p in list(bp)[:2]]
    q, al, pairs, prefixes, items = _traffic(full, 4)
    return base, {
        "rows": [r for r, _ in rows],
        "sup": [float(full.support[v]) * 0.5 for _, v in rows],
        "conf": [float(full.confidence[v]) for _, v in rows],
        "lift": [float(full.lift[v]) for _, v in rows],
        "q": q.tolist(), "al": al.tolist(),
        "pairs": [(list(a), list(c)) for a, c in pairs],
        "prefixes": [list(p) for p in prefixes], "items": list(items),
        "probes": [list(p) for p in novel + list(bp)[:6]],
    }


@pytest.fixture(scope="module")
def eight_devices(tmp_path_factory):
    """The reference's P = 2 / 8 plans and masked answers, and its stream
    over a three-device mesh (~50 s)."""
    import dataclasses
    import json

    from repro.core.array_trie import FrozenTrie as JFrozen

    tmp = tmp_path_factory.mktemp("sharding")
    path, stream_in = tmp / "reference.npz", tmp / "stream_in.npz"
    base, case = _stream_case()
    np.savez(stream_in, case=np.asarray(json.dumps(case)), **{
        "base/" + f.name: np.asarray(_np(getattr(base, f.name)))
        for f in dataclasses.fields(JFrozen)})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path),
                          str(stream_in)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


_SUB_CELLS = {
    "random": (_random_arrays, {}),
    "chain": (_chain_arrays, dict(layout="compressed", quantize=True,
                                  n_transactions=1000)),
}


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("name", list(_SUB_CELLS))
def test_plans_match_reference_on_eight_devices(eight_devices, name, p):
    make, kw = _SUB_CELLS[name]
    tf = _port(JS.frozen_from_arrays(make()))
    plan = TSH.shard_device_trie(tf, TrieMesh(["cpu"] * p), **kw)
    tag = f"{name}/{p}/"
    ref = {key[len(tag):]: v for key, v in eight_devices.items()
           if key.startswith(tag) and "/" not in key[len(tag):]}
    assert [list(r) for r in plan.ranges] == ref["ranges"].tolist()
    _same(plan.local_item_offsets, ref["local_item_offsets"])
    _same(plan.gbase, ref["gbase"])
    assert plan.trie.max_fanout == int(ref["max_fanout"])
    _plan_fields_equal(plan, ref, f"{name} P={p}")


@pytest.mark.parametrize("name", list(_SUB_CELLS))
def test_masked_plan_matches_reference(eight_devices, name):
    make, kw = _SUB_CELLS[name]
    arrs = make()
    tf = _port(JS.frozen_from_arrays(arrs))
    plan = TSH.shard_device_trie(tf, TrieMesh(["cpu"] * 8), **kw)
    before = {f: _np(getattr(plan.trie.shards[1], f)).copy()
              for f in TSH._LEAVES}
    masked = TSH.mask_dead_shards(plan, [5, 1, 5])
    tag = f"{name}/8/mask/"

    def want(sub):
        return {key[len(tag + sub) + 1:]: v for key, v in
                eight_devices.items() if key.startswith(tag + sub + "/")}

    n_items = int(tf.item_rank.shape[0])
    items = list(range(n_items)) + [-1, n_items + 2, 0]
    for role in ROLES:
        _same_dict(TO.rules_with(masked, items, role=role, k=5),
                   want(role), f"{name} masked {role}")
    _same_dict(TO.top_k_rules_batch(masked, [[], [0], [1], [2, 3],
                                             [n_items + 1]], 6,
                                    metric="lift"),
               want("top_k"), f"{name} masked top_k")
    q, al = JS.synthetic_search_queries(arrs, 64, 5, seed=2)
    _same_dict(TO.rule_search_batch(masked, q, al), want("search"),
               f"{name} masked search")
    # the original plan is untouched; the dead shards are blank
    for f, v in before.items():
        _same(getattr(plan.trie.shards[1], f), v, f)
    assert [sh.dfs_len for sh in masked.trie.shards][1::4] == [0, 0]
    assert (masked.local_item_offsets[[1, 5]] == 0).all()
    assert (masked.gbase[[1, 5]] == 0).all()
    assert plan.local_item_offsets[1].any()


def test_mask_dead_shards_refusals():
    tf = _port(JS.frozen_from_arrays(_random_arrays()))
    plan = TSH.shard_device_trie(tf, TrieMesh(["cpu"] * 4))
    assert TSH.mask_dead_shards(plan, []) is plan
    with pytest.raises(ValueError, match="out of range"):
        TSH.mask_dead_shards(plan, [4])
    with pytest.raises(ValueError, match="leaves nothing"):
        TSH.mask_dead_shards(plan, [0, 1, 2, 3])
    with pytest.raises(ValueError, match="arrays="):
        TO.rules_with(plan, [0], arrays={})
    with pytest.raises(ValueError, match="edges="):
        TO.rule_search_batch(plan, np.zeros((1, 1), np.int32),
                             np.zeros(1, np.int32), edges={})
    for fn in (TO.trie_reduce, TO.edge_metric_arrays, TO.dfs_rank_arrays,
               TO.item_rank_arrays, lambda t: TO.prefix_ranges(t, [[0]])):
        with pytest.raises(NotImplementedError, match="ShardPlan"):
            fn(plan)


def test_mesh():
    mesh = TrieMesh(["cpu"] * 3)
    assert mesh.shape == {"data": 3} and len(mesh.devices) == 3
    assert mesh.lead == torch.device("cpu")
    with pytest.raises(ValueError, match="at least one"):
        TrieMesh([])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=r"outside \[1, 0\]"):
            t_make_mesh()


# ----------------------------------------------------------------------
# the engine, the ladder and the stream over a plan
# ----------------------------------------------------------------------
def _engine_ops(eng, jf):
    q, al, pairs, prefixes, items = _traffic(jf, 9)
    out = {"search": eng.rule_search_batch(q, al),
           "pairs": eng.rule_search_batch(pairs),
           "topk": eng.top_k_rules_batch(prefixes, 7, metric="lift")}
    for role in ROLES:
        out[role] = eng.rules_with(items, role=role, k=5)
    return out


def test_engine_backends(tries):
    jf = tries["random"]
    tf = _port(jf)
    want = _engine_ops(J.TrieQueryEngine(jf, mode="replicated"), jf)
    # auto routes to replicated on one device, even past the threshold
    auto = make_trie_engine(tf, "cpu", shard_threshold_nodes=1)
    assert auto.backend == "replicated" and auto.plan is None
    mesh = TrieMesh(["cpu"] * 3)
    engines = [
        auto,
        T.TrieQueryEngine(tf, device="cpu", mode="replicated", mesh=mesh),
        T.TrieQueryEngine(tf, mode="sharded", mesh=mesh),
        make_trie_engine(tf, mesh=mesh, shard_threshold_nodes=1),
        T.TrieQueryEngine(tf, plan=TSH.shard_device_trie(tf, mesh)),
    ]
    assert [e.backend for e in engines] == ["replicated"] * 2 + \
        ["sharded"] * 3
    assert [e.n_shards for e in engines] == [1, 1, 3, 3, 3]
    for eng in engines:
        for key, got in _engine_ops(eng, jf).items():
            _same_dict(got, want[key], f"{eng.backend} {key}")
    with pytest.raises(ValueError, match="'nope'"):
        make_trie_engine(tf, "cpu", mode="nope")
    # the sharded backend answers on its lead device: another is refused
    plan = engines[-1].plan
    with pytest.raises(ValueError, match="lead device"):
        T.TrieQueryEngine(tf, device="meta", plan=plan)
    with pytest.raises(ValueError, match="lead device"):
        T.TrieQueryEngine(tf, device="meta", mode="sharded", mesh=mesh)
    assert T.TrieQueryEngine(tf, device="cpu", plan=plan).device == \
        torch.device("cpu")


def _single(eng, w):
    """One workload entry as a one-row batch on ``eng``."""
    kw = w["kwargs"]
    if w["op"] == "rule_search":
        return eng.rule_search_batch([tuple(w["payload"])])
    if w["op"] == "top_k":
        return eng.top_k_rules_batch([w["payload"]], kw["k"],
                                     metric=kw["metric"])
    return eng.rules_with([w["payload"]], **kw)


@pytest.mark.parametrize("allow", [True, False])
def test_ladder_over_four_shards(tries, allow):
    """A four-shard primary takes a ``ShardFailure`` on shard 2 after a
    first drain: the entries cached before the failover are orphaned; the
    replicated rung answers bitwise like the primary, and without the
    replicated fallback the masked rung answers ``degraded=True`` as
    ``mask_dead_shards(plan, [2])`` does (degraded rows are not cached)."""
    tf = _port(tries["mined"])
    oracle = T.TrieQueryEngine(tf, device="cpu", mode="replicated")
    wl = T.zipfian_workload(tf, 40, seed=3)
    primary = T.TrieQueryEngine(tf, mesh=TrieMesh(["cpu"] * 4),
                                mode="sharded")
    clock = T.VirtualClock()
    inj = T.FaultInjector()
    res = T.ResilientTrieEngine(T.FaultyEngine(primary, inj, clock=clock),
                                allow_replicated_fallback=allow)
    sched = T.TrieScheduler(res, clock=clock, max_batch=4)
    first = [sched.submit(w["op"], w["payload"], w["kwargs"])
             for w in wl[:8]]
    sched.drain()
    assert sched.cache_len and res.backend == "sharded"
    inj.fail_nth_launch(inj.launches + 1, shard=2)
    # queries other than the first drain's: those stay cached from
    # before the failover, and must not be served after it
    seen = {repr((w["op"], w["payload"], w["kwargs"])) for w in wl[:8]}
    rest = [w for w in wl[8:]
            if repr((w["op"], w["payload"], w["kwargs"])) not in seen]
    later = [sched.submit(w["op"], w["payload"], w["kwargs"])
             for w in rest]
    sched.drain()
    assert res.failovers == 1 and res.health.dead == {2}
    assert res.backend == ("replicated" if allow else "degraded")
    again = [sched.submit(w["op"], w["payload"], w["kwargs"])
             for w in wl[:8]]
    sched.drain()
    assert not any(sched.responses[r.id].cache_hit for r in again)
    masked = T.TrieQueryEngine(
        tf, plan=TSH.mask_dead_shards(primary.plan, [2]))
    for w, req in zip(wl[:8] + rest + wl[:8], first + later + again):
        resp = sched.responses[req.id]
        assert resp.status == "ok"
        assert resp.degraded == (resp.backend == "degraded")
        assert resp.degraded is (not allow and req not in first)
        for key, v in _single(masked if resp.degraded else oracle,
                              w).items():
            _same(resp.result[key], v[0], f"{w['op']} {key}")


def test_stream_with_mesh(eight_devices):
    """A stream over a three-shard mesh answers as the reference's stream
    over three devices (before any fold and after the first) and as the
    port's unsharded stream (after each of two folds too), after inserts
    and updates; its plans' cuts (the masked-depth plan's and each
    fold's, through the drift gate) and ``owner_shard`` are the
    reference's, and ``owner_shard`` agrees with the plan's ranges."""
    base, case = _stream_case()
    mesh = TrieMesh(["cpu"] * 3)
    plain = StreamingTrie(base, device="cpu", refreeze_max_delta=4)
    meshed = StreamingTrie(base, mesh=mesh, device="cpu",
                           refreeze_max_delta=4)
    eng = T.TrieQueryEngine(meshed, mode="sharded")
    assert eng.backend == "sharded" and eng.n_shards == 3
    for st in (plain, meshed):
        st.insert(case["rows"], case["sup"], case["conf"], case["lift"])
    q = np.asarray(case["q"], np.int32)
    al = np.asarray(case["al"], np.int32)
    pairs = [(tuple(a), tuple(c)) for a, c in case["pairs"]]
    prefixes, items = case["prefixes"], case["items"]

    def ref(tag):
        return {key[len(tag):]: v for key, v in eight_devices.items()
                if key.startswith(tag)}

    for step in range(3):
        tag = f"stream/{step}/"
        got = {"search": eng.rule_search_batch(q, al),
               "pairs": eng.rule_search_batch(pairs),
               "topk": eng.top_k_rules_batch(prefixes, 6,
                                             metric="leverage")}
        unsharded = {"search": TO.rule_search_batch(plain, q, al),
                     "pairs": TO.rule_search_batch(plain, pairs),
                     "topk": TO.top_k_rules_batch(plain, prefixes, 6,
                                                  metric="leverage")}
        for role in ROLES:
            got[role] = eng.rules_with(items, role=role, k=5)
            unsharded[role] = TO.rules_with(plain, items, role=role, k=5)
        for name, res in got.items():
            if step < 2:   # the reference answers before the second fold
                _same_dict(res, ref(f"{tag}{name}/"), f"{step} {name}")
            _same_dict(res, unsharded[name], f"{step} {name} unsharded")
        plan = meshed.shard_plan()
        assert [list(r) for r in plan.ranges] == \
            eight_devices[tag + "ranges"].tolist()
        owners = [meshed.owner_shard(p) for p in case["probes"]]
        assert owners == eight_devices[tag + "owner"].tolist()
        for p, owner in zip(case["probes"], owners):
            head = TA.canonical_prefix_rows([p],
                                            meshed.frozen.item_rank)[0][0]
            node = meshed._frozen_node((head,))
            if node is not None:
                lo, hi = plan.ranges[owner]
                assert lo <= int(meshed.frozen.dfs_order[node]) < hi
            else:
                assert 0 <= owner < 3
        prev = meshed._last_ranges
        folded = meshed.maybe_refreeze()
        assert plain.maybe_refreeze() == folded
        assert (-1 if folded is None else folded) == \
            int(eight_devices[tag + "folded"])
        assert meshed.epoch == plain.epoch
        refolded = meshed.shard_plan().ranges
        assert refolded == tuple(TSH.shard_dfs_ranges(
            meshed.frozen, 3, prev, meshed.rebalance_drift))
        assert [list(r) for r in refolded] == \
            eight_devices[tag + "refolded"].tolist()


def test_sharded_path_runs_without_jax_or_repro():
    """The sharding module and the mesh import and answer with ``jax`` and
    ``repro`` made unimportable."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from repro_torch.core.synthetic import (frozen_from_arrays,\n"
        "    random_csr_trie)\n"
        "from repro_torch.distributed.trie_sharding import (\n"
        "    mask_dead_shards, shard_device_trie)\n"
        "from repro_torch.launch.mesh import TrieMesh\n"
        "from repro_torch.kernels import ops\n"
        "fz = frozen_from_arrays(random_csr_trie(\n"
        "    np.random.RandomState(0), 120, 8))\n"
        "plan = shard_device_trie(fz, TrieMesh(['cpu'] * 3))\n"
        "m = mask_dead_shards(plan, [1])\n"
        "for p in (plan, m):\n"
        "    ops.top_k_rules_batch(p, [[], [0]], 5)\n"
        "    ops.rules_with(p, [0, 1], k=4)\n"
        "    ops.rule_search_batch(p, [((0,), (1,))])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
