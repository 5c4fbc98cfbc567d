"""Port parity for the serve loop: ``TrieScheduler``, ``ResilientTrieEngine``,
``FaultInjector`` / ``FaultyEngine``, ``zipfian_workload`` and the
``StragglerDetector`` of ``ShardHealth``, on the CPU.

The differential replays run the same seeded workload through the
reference's scheduler (its Pallas kernels in interpret mode) and the
port's, each on a ``VirtualClock`` with no timer, under the same knobs
and the same injected faults, and hold every ``Response`` (result arrays
with their dtypes, status, backend, flags, retries, error and
``latency_ms``), the stats, the metric snapshots, the span trees and the
injector's and health tracker's events equal.  The single-device cases
are the reference's own serve-loop, observability and streaming-serve
tests, run on the port.  Tries: the paper example at minsup 0.25 and a
``random_csr_trie`` of 300 nodes, each built by both packages.

The reference runs under its default kernel config, pure power-of-two
launch pads (``launch_pad_floor`` 1), as the port's ``launch_pad`` has
it: the reference's committed CPU tuning table floors pads at 2, which
moves its launch predictor's buckets (and so the deadline shaper's
decisions), not its answers.

Tolerance: bitwise everywhere.
"""
import dataclasses
import json
import math
import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as JObs  # noqa: E402
import repro.serve as J  # noqa: E402
import repro_torch.obs as TObs  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from repro.arm.datasets import paper_example_db as j_paper_db  # noqa: E402
from repro.arm.rulegen import sample_rule_sequences  # noqa: E402
from repro.arm.transactions import TransactionDB as JDB  # noqa: E402
from repro.core import synthetic as JSyn  # noqa: E402
from repro.core.array_trie import FrozenTrie as JFrozen  # noqa: E402
from repro.core.build_arrays import build_frozen_trie as j_build  # noqa: E402
from repro.core.builder import build_trie_of_rules as j_rules  # noqa: E402
from repro.core.delta_trie import StreamingTrie as JStream  # noqa: E402
from repro.distributed.health import StragglerDetector as JDetector  # noqa: E402
from repro.kernels.tuning import tuning_overrides  # noqa: E402
from repro_torch.arm.datasets import paper_example_db  # noqa: E402
from repro_torch.arm.transactions import TransactionDB as TDB  # noqa: E402
from repro_torch.core import synthetic as TSyn  # noqa: E402
from repro_torch.core.array_trie import FrozenTrie  # noqa: E402
from repro_torch.core.build_arrays import build_frozen_trie as t_build  # noqa: E402
from repro_torch.core.builder import build_trie_of_rules  # noqa: E402
from repro_torch.core.delta_trie import StreamingTrie  # noqa: E402
from repro_torch.distributed.health import StragglerDetector  # noqa: E402
from repro_torch.distributed.trie_sharding import (  # noqa: E402
    ShardFailure,
    mask_dead_shards,
)
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.launch.mesh import TrieMesh  # noqa: E402
from repro_torch.kernels.ops import (  # noqa: E402
    InvalidQueryError,
    TransientBackendError,
    is_retryable,
)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
FROZEN_FIELDS = tuple(f.name for f in dataclasses.fields(JFrozen))


@pytest.fixture(scope="module", autouse=True)
def pure_pow2_pads():
    with tuning_overrides(launch_pad_floor=1):
        yield


def _arrays_equal(jf, tf):
    for name in FROZEN_FIELDS:
        g, w = np.asarray(getattr(tf, name)), np.asarray(getattr(jf, name))
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), name


@pytest.fixture(scope="module")
def paper():
    """The paper example at minsup 0.25: (reference trie, port trie)."""
    jf = JFrozen.freeze(j_rules(j_paper_db(), 0.25).trie)
    tf = FrozenTrie.freeze(build_trie_of_rules(paper_example_db(), 0.25).trie)
    _arrays_equal(jf, tf)
    return jf, tf


@pytest.fixture(scope="module")
def rnd():
    """A random 300-node CSR trie, from each package's generator."""
    ja = JSyn.random_csr_trie(np.random.RandomState(7), 300, 12)
    ta = TSyn.random_csr_trie(np.random.RandomState(7), 300, 12)
    jf, tf = JSyn.frozen_from_arrays(ja), TSyn.frozen_from_arrays(ta)
    _arrays_equal(jf, tf)
    return jf, tf


@pytest.fixture(scope="module")
def tries(paper, rnd):
    return {"paper": paper, "random": rnd}


def _engine(S, fz, **kw):
    """A one-device engine of package ``S`` (the port's on the CPU)."""
    if S is T:
        kw.setdefault("device", "cpu")
    return S.TrieQueryEngine(fz, mode="replicated", **kw)


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _rows_eq(got, want, what=""):
    """Bitwise equality of two result dicts (rows or whole batches)."""
    assert set(got) == set(want), what
    for key in want:
        g, w = _host(got[key]), _host(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
        assert g.tobytes() == w.tobytes(), (what, key, g, w)


def _resp_eq(got, want):
    """Field-for-field equality of two ``Response``s, results bitwise."""
    for f in ("id", "op", "tenant", "status", "degraded", "backend",
              "cache_hit", "retries", "latency_ms", "error"):
        assert getattr(got, f) == getattr(want, f), (f, got, want)
    assert (got.result is None) == (want.result is None), got.id
    if want.result is not None:
        _rows_eq(got.result, want.result, f"response {got.id}")


def _spans(obs):
    return [(s.name, s.parent_id, s.start_s, s.end_s, s.attrs)
            for s in obs.tracer.spans]


# ----------------------------------------------------------------------
# the differential replay: reference and port, same traffic and faults
# ----------------------------------------------------------------------
SCENARIOS = {
    "reject_new": dict(shed_policy="reject_new", max_pending=6),
    "drop_oldest": dict(shed_policy="drop_oldest", max_pending=6),
    "small_cache": dict(cache_size=3, max_pending=64),
}


def _hot_item(fz):
    """The most frequent depth-1 item: the poison predicate's target."""
    return int(np.asarray(fz.edge_item)[0])


def _replay(S, Obs, fz, scenario, seed=5):
    """Replay a Poisson-arrival zipfian workload through package ``S``'s
    scheduler on a ``VirtualClock``: a transient failure, a shard failure,
    a poison item, and an injected slow shard that turns slower mid-run
    (the straggler detector's events)."""
    clock = S.VirtualClock()
    hot = _hot_item(fz)
    inj = (S.FaultInjector().fail_transient(2).fail_nth_launch(6, shard=0)
           .fail_transient(9, times=2)
           .poison_payload(lambda p: hot in np.asarray(p).ravel().tolist(),
                           times=3)
           .slow_shard(0, 0.001))
    health = S.ShardHealth(1)
    res = S.ResilientTrieEngine(
        S.FaultyEngine(_engine(S, fz), inj, clock=clock, health=health),
        health=health)
    obs = Obs.Observability(tracing=True)
    sched = S.TrieScheduler(res, clock=clock, obs=obs, max_batch=8,
                            **SCENARIOS[scenario])
    wl = S.zipfian_workload(fz, 72, seed=seed, arrival_rate=400.0,
                            deadline_ms=(6.0, 25.0, math.inf))
    out, rejected, steps, i = [], [], 0, 0
    while i < len(wl) or sched.pending:
        while i < len(wl) and wl[i]["arrival_s"] <= clock.now() + 1e-12:
            w = wl[i]
            i += 1
            try:
                sched.submit(w["op"], w["payload"], w["kwargs"],
                             deadline_ms=w["deadline_ms"],
                             tenant=w["tenant"])
            except S.QueueFull:
                rejected.append(i - 1)
        if sched.pending:
            out.extend(sched.step())
            steps += 1
            if steps == 4:
                inj.slow_shard(0, 0.01)
        elif i < len(wl):
            clock.sleep(wl[i]["arrival_s"] - clock.now())
    return dict(out=out, sched=sched, inj=inj, res=res, obs=obs,
                rejected=rejected, wl=wl, now=clock.now())


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("trie", ["paper", "random"])
def test_replay_matches_reference(tries, trie, scenario):
    jf, tf = tries[trie]
    want = _replay(J, JObs, jf, scenario)
    got = _replay(T, TObs, tf, scenario)
    assert got["wl"] == want["wl"]
    assert got["rejected"] == want["rejected"]
    assert len(got["out"]) == len(want["out"])
    for g, w in zip(got["out"], want["out"]):
        _resp_eq(g, w)
    assert sorted(got["sched"].responses) == sorted(want["sched"].responses)
    for rid, w in want["sched"].responses.items():
        _resp_eq(got["sched"].responses[rid], w)
    assert got["sched"].stats == want["sched"].stats
    assert got["obs"].snapshot() == want["obs"].snapshot()
    assert _spans(got["obs"]) == _spans(want["obs"])
    assert got["inj"].events == want["inj"].events
    assert got["res"].health.events == want["res"].health.events
    assert got["res"].failovers == want["res"].failovers == 1
    assert got["now"] == want["now"]
    assert got["sched"].cache_len == want["sched"].cache_len
    # the scenario's knobs bit: every status the replay can give shows
    stats = got["sched"].stats
    assert stats["ok"] and stats["timeout"] and stats["retries"]
    assert stats["invalid"]
    assert {"transient", "poison", "shard_fail"} <= {
        e["kind"] for e in got["inj"].events}
    if scenario != "small_cache":
        assert stats["shed"]
    assert "slow" in {e["kind"] for e in got["res"].health.events}


def test_stream_replay_matches_reference():
    """Inserts and queries through both schedulers over a stream that
    refreezes on every batch: the same responses, stats and events."""
    rng = np.random.RandomState(3)
    txs = [set(rng.randint(0, 12, size=rng.randint(1, 7)))
           for _ in range(40)]
    jdb, tdb = JDB(txs, n_items=12), TDB(txs, n_items=12)
    seqs = sample_rule_sequences(jdb, 60, seed=1)
    jfull, _, _ = j_build(jdb, seqs)
    jbase, _, _ = j_build(jdb, seqs[:30])
    tbase, _, _ = t_build(tdb, seqs[:30], use_kernel=False)
    _arrays_equal(jbase, tbase)
    have = {tuple(int(x) for x in jbase.path_items(v))
            for v in range(1, jbase.n_nodes)}
    novel = sorted((tuple(int(x) for x in jfull.path_items(v)), v)
                   for v in range(1, jfull.n_nodes))
    novel = sorted([(p, v) for p, v in novel if p not in have],
                   key=lambda pv: len(pv[0]))
    assert novel

    def run(S, base, Stream):
        kw = {"device": "cpu"} if S is T else {}
        st = Stream(base, refreeze_max_delta=4, refreeze_max_age=2, **kw)
        eng = S.TrieQueryEngine(st, mode="replicated")
        sched = S.TrieScheduler(eng, clock=S.VirtualClock(), max_batch=8)
        wl = S.zipfian_workload(base, 40, seed=2)
        out = []
        for r in range(0, len(novel), 5):
            for p, v in novel[r:r + 5]:
                sched.submit("insert", (p, float(jfull.support[v]),
                                        float(jfull.confidence[v]),
                                        float(jfull.lift[v])))
            for w in wl[r:r + 8]:
                sched.submit(w["op"], w["payload"], w["kwargs"])
            sched.submit("top_k", [], {"k": 6, "metric": "support"})
            out.extend(sched.drain())
        return out, sched

    want, jsched = run(J, jbase, JStream)
    got, tsched = run(T, tbase, StreamingTrie)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _resp_eq(g, w)
    assert tsched.stats == jsched.stats
    assert tsched.stats["inserted"] == len(novel)
    assert tsched.stats["refreezes"] >= 1


# ----------------------------------------------------------------------
# the failover ladder
# ----------------------------------------------------------------------
def _sharded(tf, p):
    """A sharded primary over ``p`` CPU shards."""
    return T.TrieQueryEngine(tf, mesh=TrieMesh(["cpu"] * p), mode="sharded")


def _ladder(S, Obs, fz, primary, allow=True):
    clock = S.VirtualClock()
    inj = S.FaultInjector().fail_nth_launch(1, shard=0)
    res = S.ResilientTrieEngine(S.FaultyEngine(primary, inj, clock=clock),
                                allow_replicated_fallback=allow)
    obs = Obs.Observability(tracing=True)
    sched = S.TrieScheduler(res, clock=clock, obs=obs, max_batch=8)
    wl = S.zipfian_workload(fz, 12, seed=11)
    reqs = [sched.submit(w["op"], w["payload"], w["kwargs"]) for w in wl]
    return sched.drain(), reqs, wl, res, obs, sched


def test_ladder_failover_matches_reference(paper):
    """A sharded primary takes a ``ShardFailure``: the in-flight batch
    moves to the replicated rung on the primary's device, answers
    bitwise, and the failover is counted as the reference counts the
    same failure on its one-device sharded engine."""
    jf, tf = paper
    want = _ladder(J, JObs, jf, J.TrieQueryEngine(jf, mode="sharded"))
    got = _ladder(T, TObs, tf, _sharded(tf, 1))
    out, reqs, wl, res, obs, sched = got
    assert len(out) == len(reqs) == len(want[0])
    for g, w in zip(out, want[0]):
        _resp_eq(g, w)
    assert all(r.status == "ok" and not r.degraded for r in out)
    assert res.backend == "replicated" and res.failovers == 1
    assert res.health.dead == {0}
    assert res._replicated.device == torch.device("cpu")
    assert res._replicated.backend == "replicated"
    assert res.health.events == want[3].health.events == [
        {"kind": "failure", "shard": 0}, {"kind": "dead", "shard": 0}]
    m = obs.metrics
    assert m.value("serve.failover",
                   labels={"from": "sharded", "to": "replicated"}) == 1
    assert obs.snapshot() == want[4].snapshot()
    assert _spans(obs) == _spans(want[4])
    assert [s.name for s in obs.tracer.finished()].count("failover") == 1
    # every response equals the single query on a plain engine
    oracle = _engine(T, tf)
    for w, req in zip(wl, reqs):
        one = {"rule_search": lambda: oracle.rule_search_batch(
                   [tuple(w["payload"])]),
               "top_k": lambda: oracle.top_k_rules_batch(
                   [w["payload"]], w["kwargs"]["k"],
                   metric=w["kwargs"]["metric"]),
               "rules_with": lambda: oracle.rules_with(
                   [w["payload"]], **w["kwargs"])}[w["op"]]()
        _rows_eq(sched.responses[req.id].result,
                 {k: _host(v)[0] for k, v in one.items()})


def test_ladder_masked_rung_is_slice_6(paper):
    """The masked rung (ROADMAP slice 6): with the replicated fallback
    disallowed, a ``ShardFailure`` on shard 1 of a four-shard primary
    re-runs the call over ``mask_dead_shards(plan, [1])``, flagged
    degraded; the masked engine is cached on (dead, epoch)."""
    _, tf = paper
    primary = _sharded(tf, 4)
    inj = T.FaultInjector().fail_nth_launch(1, shard=1)
    res = T.ResilientTrieEngine(T.FaultyEngine(primary, inj),
                                allow_replicated_fallback=False)
    got, info = res.query("rules_with", [0, 1], k=4)
    assert info == {"degraded": True, "backend": "degraded",
                    "failover": True}
    assert res.failovers == 1 and res.health.dead == {1}
    masked = mask_dead_shards(primary.plan, [1])
    _rows_eq({k: _host(v) for k, v in got.items()},
             {k: _host(v) for k, v in TO.rules_with(masked, [0, 1],
                                                    k=4).items()})
    eng = res._degraded_engine()
    assert eng is res._degraded_engine() and eng.backend == "sharded"
    assert eng.plan.trie.shards[1].dfs_len == 0
    # through the scheduler every response is degraded and equals the
    # same single query on the masked plan
    out, reqs, wl, res, obs, sched = _ladder(T, TObs, tf, primary,
                                             allow=False)
    assert {r.status for r in out} == {"ok"}
    assert all(r.degraded and r.backend == "degraded" for r in out)
    masked = mask_dead_shards(primary.plan, [0])
    for w, req in zip(wl, reqs):
        one = {"rule_search": lambda: TO.rule_search_batch(
                   masked, [tuple(w["payload"])]),
               "top_k": lambda: TO.top_k_rules_batch(
                   masked, [w["payload"]], w["kwargs"]["k"],
                   metric=w["kwargs"]["metric"]),
               "rules_with": lambda: TO.rules_with(
                   masked, [w["payload"]], **w["kwargs"])}[w["op"]]()
        _rows_eq(sched.responses[req.id].result,
                 {k: _host(v)[0] for k, v in one.items()})


def test_one_device_primary_reruns_on_itself(paper):
    """Without a plan the ladder records the failure, bumps ``failovers``
    (orphaning the cache) and re-runs on the same primary, as the
    reference does."""
    _, tf = paper
    primary = _engine(T, tf)
    out, _, _, res, obs, sched = _ladder(T, TObs, tf, primary)
    assert all(r.status == "ok" and r.backend == "replicated" for r in out)
    assert res.failovers == 1 and res._replicated is None
    assert res.version == (1, 0)
    assert obs.metrics.value(
        "serve.failover",
        labels={"from": "replicated", "to": "replicated"}) == 1


# ----------------------------------------------------------------------
# health, taxonomy, traffic
# ----------------------------------------------------------------------
def _launch_series(seed):
    rng = np.random.RandomState(seed)
    base = rng.uniform(0.001, 0.002, size=60)
    base[20:30] *= 5          # a sustained straggle
    base[45:47] *= 8          # a short spike
    return [float(x) for x in base]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_events_match_reference(seed):
    series = _launch_series(seed)
    dets = (JDetector(), StragglerDetector())
    flags = [[d.observe(i, s) for i, s in enumerate(series)] for d in dets]
    assert flags[0] == flags[1] and any(flags[1])
    assert dets[0].events == dets[1].events
    healths = (J.ShardHealth(2, demote_slow=True),
               T.ShardHealth(2, demote_slow=True))
    for h in healths:
        for i, s in enumerate(series):
            h.record_launch(i % 2, s)
        h.record_failure(0)
    assert healths[0].events == healths[1].events
    assert healths[0].dead == healths[1].dead
    assert healths[0].slow == healths[1].slow


def test_error_taxonomy_classification():
    assert is_retryable(TransientBackendError("x"))
    assert not is_retryable(InvalidQueryError("x"))
    assert not is_retryable(ShardFailure(0))
    assert str(ShardFailure(3)) == "shard 3 failed"
    assert ShardFailure(1, "m").shard == 1
    assert is_retryable(RuntimeError("RESOURCE_EXHAUSTED: pool"))
    assert not is_retryable(RuntimeError("segfault"))


@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=4, s=1.6, n_tenants=3),
    dict(seed=9, arrival_rate=250.0, deadline_ms=(1.0, 2.0)),
])
def test_zipfian_workload_matches_reference(tries, kw):
    for jf, tf in tries.values():
        assert T.zipfian_workload(tf, 90, **kw) == \
            J.zipfian_workload(jf, 90, **kw)


def test_retry_policy_schedule_matches_reference():
    for pol in ((3, 10.0), (5, 1.0)):
        a = J.RetryPolicy(*pol).schedule_ms(random.Random(7))
        b = T.RetryPolicy(*pol).schedule_ms(random.Random(7))
        assert a == b


# ----------------------------------------------------------------------
# the reference's single-device serve-loop cases, on the port
# ----------------------------------------------------------------------
def _sched(tf, **kw):
    clock = kw.pop("clock", None) or T.VirtualClock()
    eng = kw.pop("engine", None) or _engine(T, tf)
    return T.TrieScheduler(eng, clock=clock, **kw), clock


def _direct(eng, op, payload, kwargs):
    if op == "rule_search":
        out = eng.rule_search_batch([tuple(payload)])
    elif op == "top_k":
        out = eng.top_k_rules_batch([payload], kwargs["k"],
                                    metric=kwargs["metric"])
    else:
        out = eng.rules_with([payload], **kwargs)
    return {k: _host(v)[0] for k, v in out.items()}


def _case_workload_drains_clean(tf):
    sched, _ = _sched(tf, max_batch=8)
    wl = T.zipfian_workload(tf, 30, seed=3)
    for w in wl:
        sched.submit(w["op"], w["payload"], w["kwargs"], tenant=w["tenant"])
    out = sched.drain()
    assert len(out) == 30 and all(r.status == "ok" for r in out)
    assert sched.pending == 0
    assert sched.stats["dedup_collapsed"] > 0
    assert sched.stats["launches"] < 30
    # every row, cache hits and dedup copies too, == the single query
    eng = _engine(T, tf)
    for w, r in zip(wl, sorted(out, key=lambda r: r.id)):
        _rows_eq(r.result, _direct(eng, w["op"], w["payload"], w["kwargs"]))


def _case_cache_hit_bit_parity(tf):
    sched, _ = _sched(tf)
    r1 = sched.submit("top_k", [0], {"k": 4, "metric": "lift"})
    miss = sched.drain()[0]
    assert not miss.cache_hit
    r2 = sched.submit("top_k", [0], {"k": 4, "metric": "lift"})
    hit = sched.drain()[0]
    assert hit.cache_hit and hit.backend == "cache"
    _rows_eq(hit.result, miss.result)
    assert sched.stats["cache_hits"] == 1
    assert r1.key == r2.key


def _case_batched_responses_match_direct_ops(tf):
    sched, _ = _sched(tf, max_batch=16)
    eng = _engine(T, tf)
    wl = [w for w in T.zipfian_workload(tf, 24, seed=5)
          if w["op"] == "rule_search"][:6]
    reqs = [sched.submit(w["op"], w["payload"], w["kwargs"]) for w in wl]
    out = {r.id: r for r in sched.drain()}
    direct = eng.rule_search_batch([tuple(w["payload"]) for w in wl])
    for i, req in enumerate(reqs):
        assert out[req.id].status == "ok"
        _rows_eq(out[req.id].result,
                 {k: _host(v)[i] for k, v in direct.items()})


def _case_backpressure_rejects(tf):
    sched, _ = _sched(tf, max_pending=4)
    for _ in range(4):
        sched.submit("rules_with", 1, {"k": 4})
    with pytest.raises(T.QueueFull):
        sched.submit("rules_with", 2, {"k": 4})
    assert sched.stats["shed"] == 1
    assert all(r.status == "ok" for r in sched.drain())


def _case_backpressure_drop_oldest(tf):
    sched, _ = _sched(tf, max_pending=2, shed_policy="drop_oldest")
    first = sched.submit("rules_with", 1, {"k": 4})
    sched.submit("rules_with", 2, {"k": 4})
    sched.submit("rules_with", 3, {"k": 4})
    assert sched.responses[first.id].status == "shed"
    assert sched.pending == 2
    assert all(r.status == "ok" for r in sched.drain())
    with pytest.raises(ValueError, match="shed_policy"):
        _sched(tf, shed_policy="lifo")


def _case_deadline_expiry(tf):
    sched, clock = _sched(tf)
    r = sched.submit("rules_with", 1, {"k": 4}, deadline_ms=50.0)
    clock.advance(0.2)
    out = sched.drain()
    assert sched.responses[r.id].status == "timeout"
    assert sched.responses[r.id].result is None
    assert [o.id for o in out] == [r.id]


def _case_shaper_refuses(tf):
    sched, _ = _sched(tf)
    sched.predictor.observe(("rules_with", ("any", 4, "lift", 1)), 2, 0.1)
    tight = sched.submit("rules_with", 1, {"k": 4, "metric": "lift"},
                         deadline_ms=10.0)
    roomy = sched.submit("rules_with", 2, {"k": 4, "metric": "lift"},
                         deadline_ms=1e4)
    sched.drain()
    assert sched.responses[tight.id].status == "timeout"
    assert sched.responses[roomy.id].status == "ok"


def _case_retry_schedule_deterministic(tf):
    def run(seed):
        clock = T.VirtualClock()
        inj = T.FaultInjector().fail_transient(1).fail_transient(2)
        eng = T.ResilientTrieEngine(
            T.FaultyEngine(_engine(T, tf), inj, clock=clock))
        sched = T.TrieScheduler(
            eng, clock=clock, seed=seed,
            retry_policy=T.RetryPolicy(max_retries=3, base_ms=10.0))
        sched.submit("rules_with", 1, {"k": 4})
        return sched.drain()[0], clock.now()

    r1, t1 = run(7)
    r2, t2 = run(7)
    assert r1.status == r2.status == "ok"
    assert r1.retries == r2.retries == 2
    assert t1 == t2
    expect = T.RetryPolicy(max_retries=3, base_ms=10.0).schedule_ms(
        random.Random(7))
    assert t1 == pytest.approx(sum(expect[:2]) / 1e3)
    assert run(8)[1] != t1


def _case_retry_exhaustion(tf):
    clock = T.VirtualClock()
    inj = T.FaultInjector()
    for n in range(1, 6):
        inj.fail_transient(n)
    eng = T.ResilientTrieEngine(
        T.FaultyEngine(_engine(T, tf), inj, clock=clock))
    sched = T.TrieScheduler(
        eng, clock=clock, retry_policy=T.RetryPolicy(max_retries=2,
                                                     base_ms=1.0))
    r = sched.submit("rules_with", 1, {"k": 4})
    sched.drain()
    assert sched.responses[r.id].status == "failed"
    assert "transient" in sched.responses[r.id].error
    assert sched.stats["retries"] == 2


def _case_poison_isolated(tf):
    clock = T.VirtualClock()
    inj = T.FaultInjector().poison_payload(
        lambda p: 1 in np.asarray(p).ravel().tolist(), times=10)
    eng = T.ResilientTrieEngine(
        T.FaultyEngine(_engine(T, tf), inj, clock=clock))
    sched = T.TrieScheduler(eng, clock=clock, max_batch=8)
    poisoned = sched.submit("rules_with", 1, {"k": 4})
    clean = sched.submit("rules_with", 2, {"k": 4})
    sched.drain()
    assert sched.responses[poisoned.id].status == "invalid"
    assert sched.responses[clean.id].status == "ok"
    _rows_eq(sched.responses[clean.id].result,
             _direct(_engine(T, tf), "rules_with", 2,
                     {"k": 4, "role": "any", "metric": "confidence"}))


def _case_straggler_demotion(tf):
    health = T.ShardHealth(2, demote_slow=True)
    health.record_launch(0, 0.0)
    health.record_launch(1, 0.0)
    for _ in range(4):
        health.record_launch(0, 0.0)
        health.record_launch(1, 0.25)
    assert 1 in health.slow and health.dead == {1}
    assert not health.healthy and health.dead_shards() == (1,)
    assert 0 not in health.slow
    with pytest.raises(ValueError, match="out of range"):
        health.record_failure(5)


def _case_faulty_engine_feeds_probe(tf):
    clock = T.VirtualClock()
    health = T.ShardHealth(1)
    inj = T.FaultInjector()
    eng = T.FaultyEngine(_engine(T, tf), inj, clock=clock, health=health)
    eng.rules_with([1], k=4)
    inj.slow_shard(0, 0.25)
    for _ in range(4):
        eng.rules_with([1], k=4)
    assert 0 in health.slow
    assert clock.now() == pytest.approx(4 * 0.25)
    inj.clear_slow(0)
    assert inj.extra_latency() == 0.0
    assert eng.plan is None and eng.device == torch.device("cpu")


def _case_strict_admission(tf):
    sched, _ = _sched(tf)
    n_items = int(np.asarray(tf.item_offsets).shape[0]) - 1
    with pytest.raises(InvalidQueryError, match=str(n_items + 17)):
        sched.submit("rules_with", n_items + 17, {"k": 2})
    with pytest.raises(InvalidQueryError):
        sched.submit("rules_with", None, {"k": 4})
    with pytest.raises(InvalidQueryError):
        sched.submit("top_k", [None], {"k": 4})
    with pytest.raises(InvalidQueryError):
        sched.submit("bogus_op", 1, {})
    assert sched.stats["invalid"] == 4
    assert sched.pending == 0
    # the op's own strict check; its lenient default answers empty
    with pytest.raises(InvalidQueryError, match=str(n_items + 17)):
        TO.rules_with(tf, [n_items + 17], k=2, strict=True, device="cpu")
    out = TO.rules_with(tf, [n_items + 17], k=2, device="cpu")
    assert not (out["node"] >= 0).any()
    # lenient admission: an absent item answers empty
    lax, _ = _sched(tf, strict_admission=False)
    lax.submit("rules_with", n_items + 17, {"k": 2})
    r = lax.drain()[0]
    assert r.status == "ok" and not (r.result["node"] >= 0).any()


def _case_host_copy_error_retried(tf):
    # a transient error the device defers to the host copy is retried
    sched, _ = _sched(tf)
    to_host, calls = sched._to_host, []

    def flaky(result):
        calls.append(1)
        if len(calls) == 1:
            raise TransientBackendError("deferred device fault")
        return to_host(result)

    sched._to_host = flaky
    sched.submit("rules_with", 2, {"k": 4})
    r = sched.drain()[0]
    assert r.status == "ok" and r.retries == 1 and len(calls) == 2
    assert sched.stats["retries"] == 1
    _rows_eq(r.result, _direct(_engine(T, tf), "rules_with", 2,
                               {"k": 4, "role": "any",
                                "metric": "confidence"}))


def _case_host_copy_error_isolated_fails(tf):
    # after a poison splits the batch, an error at a row's host copy
    # answers that row failed instead of escaping step()
    clock = T.VirtualClock()
    inj = T.FaultInjector().poison_payload(
        lambda p: 1 in np.asarray(p).ravel().tolist(), times=10)
    eng = T.ResilientTrieEngine(
        T.FaultyEngine(_engine(T, tf), inj, clock=clock))
    sched = T.TrieScheduler(eng, clock=clock, max_batch=8)

    def broken(result):
        raise RuntimeError("deferred device fault")

    sched._to_host = broken
    poisoned = sched.submit("rules_with", 1, {"k": 4})
    clean = sched.submit("rules_with", 2, {"k": 4})
    sched.drain()
    assert sched.responses[poisoned.id].status == "invalid"
    assert sched.responses[clean.id].status == "failed"
    assert "deferred device fault" in sched.responses[clean.id].error


SERVE_CASES = {
    "workload_drains_clean": _case_workload_drains_clean,
    "host_copy_error_retried": _case_host_copy_error_retried,
    "host_copy_error_isolated_fails": _case_host_copy_error_isolated_fails,
    "cache_hit_bit_parity": _case_cache_hit_bit_parity,
    "batched_responses_match_direct_ops":
        _case_batched_responses_match_direct_ops,
    "backpressure_rejects": _case_backpressure_rejects,
    "backpressure_drop_oldest": _case_backpressure_drop_oldest,
    "deadline_expiry": _case_deadline_expiry,
    "shaper_refuses": _case_shaper_refuses,
    "retry_schedule_deterministic": _case_retry_schedule_deterministic,
    "retry_exhaustion": _case_retry_exhaustion,
    "poison_isolated": _case_poison_isolated,
    "straggler_demotion": _case_straggler_demotion,
    "faulty_engine_feeds_probe": _case_faulty_engine_feeds_probe,
    "strict_admission": _case_strict_admission,
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_case(paper, case):
    SERVE_CASES[case](paper[1])


@pytest.mark.parametrize("op", ["top_k", "rules_with", "rule_search"])
def test_pad_rows_leave_batch_rows_untouched(rnd, op):
    """Batches of 1-8 distinct rows (padded to the next power of two with
    ``-2`` prefixes or distinct absent items ``-2-i``) answer each row as
    its single query does."""
    _, tf = rnd
    eng = _engine(T, tf)
    wl = [w for w in T.zipfian_workload(tf, 400, seed=6, s=0.2)
          if w["op"] == op]
    for n in (1, 3, 5, 8):
        sched, _ = _sched(tf, max_batch=n, cache_size=0)
        seen, reqs = set(), []
        for w in wl:
            key = json.dumps(w["payload"])
            if key not in seen and len(reqs) < n:
                seen.add(key)
                reqs.append((sched.submit(w["op"], w["payload"],
                                          w["kwargs"]), w))
        out = sched.drain()
        assert sched.stats["launches"] == 1 and len(out) == len(reqs)
        for req, w in reqs:
            _rows_eq(sched.responses[req.id].result,
                     _direct(eng, op, w["payload"], w["kwargs"]))


# ----------------------------------------------------------------------
# the reference's observability cases on the serve loop, on the port
# ----------------------------------------------------------------------
def _traced(tf, **kw):
    obs = TObs.Observability(tracing=True)
    clock = T.VirtualClock()
    return T.TrieScheduler(_engine(T, tf), clock=clock, obs=obs, **kw), obs


def _obs_disabled_records_nothing(tf):
    obs = TObs.Observability(metrics=TObs.MetricsRegistry(enabled=False),
                             tracer=TObs.Tracer(enabled=False))
    sched = T.TrieScheduler(_engine(T, tf), clock=T.VirtualClock(), obs=obs)
    for w in T.zipfian_workload(tf, 10, seed=5):
        sched.submit(w["op"], w["payload"], w["kwargs"], tenant=w["tenant"])
    assert all(r.status == "ok" for r in sched.drain())
    assert obs.tracer.spans == []
    assert obs.metrics.snapshot()["counters"] == {}
    assert set(sched.stats) == set(T.STAT_KEYS)


def _obs_stats_preseeded(tf):
    sched = T.TrieScheduler(_engine(T, tf), clock=T.VirtualClock())
    assert sched.stats == {k: 0 for k in T.STAT_KEYS}
    assert {"inserted", "refreezes"} <= set(sched.stats)


def _obs_span_tree(tf):
    sched, obs = _traced(tf, max_batch=8)
    wl = T.zipfian_workload(tf, 24, seed=9)
    for w in wl:
        sched.submit(w["op"], w["payload"], w["kwargs"], tenant=w["tenant"])
    assert all(r.status == "ok" for r in sched.drain())
    spans = obs.tracer.spans
    assert obs.tracer.finished() == spans
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        assert s.parent_id == -1 or s.parent_id in by_id
        if s.parent_id in by_id:
            p = by_id[s.parent_id]
            assert p.start_s - 1e-9 <= s.start_s
            assert s.end_s <= p.end_s + 1e-9
    roots = [s for s in spans if s.name == "request"]
    assert len(roots) == len(wl)
    for root in roots:
        kids = [s for s in spans if s.parent_id == root.span_id]
        assert {k.name for k in kids} <= {"admit", "queue", "serve",
                                          "respond"}
        assert sum(k.duration_s for k in kids) == pytest.approx(
            root.duration_s, abs=1e-9)
        lat = sched.responses[root.attrs["req"]].latency_ms
        assert root.duration_s * 1e3 == pytest.approx(lat, abs=1e-6)
    assert {"engine.rule_search_batch", "engine.top_k_rules_batch",
            "engine.rules_with", "launch", "merge"} <= {s.name
                                                        for s in spans}


def _obs_trace_capacity(tf):
    obs = TObs.Observability(tracer=TObs.Tracer(enabled=True, capacity=5))
    sched = T.TrieScheduler(_engine(T, tf), clock=T.VirtualClock(), obs=obs)
    for w in T.zipfian_workload(tf, 10, seed=5):
        sched.submit(w["op"], w["payload"], w["kwargs"])
    assert all(r.status == "ok" for r in sched.drain())
    assert len(obs.tracer.spans) == 5 and obs.tracer.dropped > 0


def _obs_perfetto_round_trip(tf, tmp_path):
    sched, obs = _traced(tf, max_batch=8)
    for w in T.zipfian_workload(tf, 16, seed=4):
        sched.submit(w["op"], w["payload"], w["kwargs"], tenant=w["tenant"])
    sched.drain()
    path = tmp_path / "trace.json"
    TObs.write_trace(str(path), obs.tracer.finished())
    doc = json.loads(path.read_text())
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(events) == len(obs.tracer.finished())
    assert all(a["ts"] <= b["ts"] for a, b in zip(events, events[1:]))
    ids = {e["args"]["span_id"] for e in events}
    assert {e["args"]["parent_id"] for e in events} <= ids | {-1}
    req_tids = {e["tid"] for e in events if e["name"] == "request"}
    assert req_tids and 1 not in req_tids
    assert {e["tid"] for e in events if e["name"] == "step"} == {1}


def _obs_per_tenant_labels(tf):
    sched, obs = _traced(tf, max_batch=8)
    wl = T.zipfian_workload(tf, 20, seed=3)
    for w in wl:
        sched.submit(w["op"], w["payload"], w["kwargs"], tenant=w["tenant"])
    out = sched.drain()
    m = obs.metrics
    tenants = sorted({w["tenant"] for w in wl})
    assert m.label_values("serve.admitted", "tenant") == tenants
    assert m.label_values("serve.latency_ms", "tenant") == tenants
    assert sum(c.value for c in m.counters_named("serve.admitted")) == \
        len(wl)
    assert sum(h.count for h in m.histograms_named("serve.latency_ms")) == \
        len(out)
    assert sum(c.value for c in m.counters_named("serve.requests")) == \
        len(out)


def _obs_kernel_profiler_feed(tf):
    obs = TObs.Observability(tracing=False)
    sched = T.TrieScheduler(_engine(T, tf), clock=T.VirtualClock(), obs=obs)
    prof = obs.profiler
    prof.clear()
    assert not prof.enabled
    with obs.profile_kernels():
        sched.submit("rules_with", 0, {"k": 3})
        sched.submit("top_k", [], {"k": 3})
        sched.drain()
    assert not prof.enabled
    assert {"rules_with", "top_k"} <= set(prof.ops())
    rec = prof.ring("rules_with")[-1]
    assert rec.rows >= 1 and rec.seconds >= 0
    assert rec.pad_factor >= 1.0 and rec.n_shards == 1
    assert obs.metrics.value("kernel.launches", op="rules_with") >= 1
    assert obs.metrics.histogram("kernel.launch_ms",
                                 op="rules_with").count >= 1
    assert any(key[:2] == ("kernel", "rules_with")
               for key in sched.predictor._ewma_ms)
    before = len(prof.ring("rules_with"))
    sched.submit("rules_with", 0, {"k": 4})
    sched.drain()
    assert len(prof.ring("rules_with")) == before
    prof.clear()


OBS_CASES = {
    "disabled_records_nothing": _obs_disabled_records_nothing,
    "stats_preseeded": _obs_stats_preseeded,
    "span_tree": _obs_span_tree,
    "trace_capacity": _obs_trace_capacity,
    "per_tenant_labels": _obs_per_tenant_labels,
    "kernel_profiler_feed": _obs_kernel_profiler_feed,
}


@pytest.mark.parametrize("case", sorted(OBS_CASES))
def test_obs_case(paper, case):
    OBS_CASES[case](paper[1])


def test_obs_perfetto_round_trip(paper, tmp_path):
    _obs_perfetto_round_trip(paper[1], tmp_path)


def test_profiled_scheduler_matches_reference(paper):
    """The scheduler's profiled launches record the reference's op names,
    rows and shapes, into the same ``("kernel", op)`` predictor buckets."""
    jf, tf = paper
    seen = []
    for S, Obs, fz in ((J, JObs, jf), (T, TObs, tf)):
        obs = Obs.Observability()
        sched = S.TrieScheduler(_engine(S, fz), clock=S.VirtualClock(),
                                obs=obs, max_batch=8)
        obs.profiler.clear()
        with obs.profile_kernels():
            for w in S.zipfian_workload(fz, 24, seed=1):
                sched.submit(w["op"], w["payload"], w["kwargs"])
            sched.drain()
        seen.append((
            {op: [(r.rows, r.shape, r.pad_factor)
                  for r in obs.profiler.ring(op)]
             for op in obs.profiler.ops()},
            sorted(k for k in sched.predictor._ewma_ms if k[0] == "kernel"),
            obs.metrics.value("kernel.launches", op="top_k")))
        obs.profiler.clear()
    assert seen[1] == seen[0]


# ----------------------------------------------------------------------
# the reference's streaming-serve cases, on the port
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def split():
    """(full, base, novel) of the reference's streaming split, built by
    the port: full = base + the novel paths."""
    rng = np.random.RandomState(3)
    txs = [set(rng.randint(0, 12, size=rng.randint(1, 7)))
           for _ in range(40)]
    db = TDB(txs, n_items=12)
    seqs = sample_rule_sequences(JDB(txs, n_items=12), 60, seed=1)
    full, _, _ = t_build(db, seqs, use_kernel=False)
    base, _, _ = t_build(db, seqs[:30], use_kernel=False)

    def paths(fz):
        return {tuple(int(x) for x in fz.path_items(n)): (
            float(fz.support[n]), float(fz.confidence[n]),
            float(fz.lift[n])) for n in range(1, fz.n_nodes)}

    fp, bp = paths(full), paths(base)
    novel = {p: m for p, m in fp.items() if p not in bp}
    assert novel
    return full, base, novel


def _stream_sched(trie):
    if isinstance(trie, FrozenTrie):
        eng = T.TrieQueryEngine(trie, mode="replicated", device="cpu")
    else:
        eng = T.TrieQueryEngine(trie, mode="replicated")
    return T.TrieScheduler(eng, clock=T.VirtualClock()), eng


def _one(sched, op, payload, **kw):
    req = sched.submit(op, payload, kwargs=kw or None)
    return {r.id: r for r in sched.drain()}[req.id]


def _stream_no_stale_cache(split):
    full, base, novel = split
    sched, _ = _stream_sched(StreamingTrie(base, device="cpu"))
    ref_sched, _ = _stream_sched(full)
    q = ([], {"k": 6, "metric": "support"})
    r1 = _one(sched, "top_k", q[0], **q[1])
    assert r1.ok and not r1.cache_hit
    r2 = _one(sched, "top_k", q[0], **q[1])
    assert r2.cache_hit
    for path in sorted(novel, key=len):
        assert _one(sched, "insert", (path, *novel[path])).ok
    r3 = _one(sched, "top_k", q[0], **q[1])
    assert not r3.cache_hit
    _rows_eq(r3.result, _one(ref_sched, "top_k", q[0], **q[1]).result)
    boost = sorted(novel, key=len)[0]
    assert _one(sched, "insert", (boost, 0.99, 0.5, 1.0)).ok
    r4 = _one(sched, "top_k", q[0], **q[1])
    assert not r4.cache_hit
    assert float(r4.result["values"][0]) == np.float32(0.99)
    assert not np.array_equal(r2.result["values"], r4.result["values"])


def _stream_version_bump(split):
    _, base, _ = split
    sched, eng = _stream_sched(StreamingTrie(base, device="cpu"))
    key = ("top_k", (0,), (6, "support", 1))
    v0 = sched._vkey(key)
    sched.engine.failovers += 1
    assert sched._vkey(key) != v0
    v1 = sched._vkey(key)
    eng.stream.insert([(int(base.node_item[1]),)], [0.9], [0.9], [1.0])
    assert sched._vkey(key) != v1


def _stream_insert_roundtrip_and_refreeze(split):
    full, base, novel = split
    st = StreamingTrie(base, refreeze_max_delta=1, refreeze_max_age=1,
                       device="cpu")
    sched, _ = _stream_sched(st)
    ref_sched, _ = _stream_sched(full)
    for path in sorted(novel, key=len):
        assert _one(sched, "insert", (path, *novel[path])).ok
    assert sched.stats["inserted"] == len(novel)
    assert sched.stats["refreezes"] >= 1
    # the width follows the current base after the refreezes
    depth = int(np.asarray(st.frozen.node_depth).max())
    assert sched._qwidth == 1 << max(depth - 1, 0).bit_length()
    got = _one(sched, "top_k", [], k=8, metric="lift")
    _rows_eq(got.result, _one(ref_sched, "top_k", [], k=8,
                              metric="lift").result)


def _stream_invalid_inserts(split):
    _, base, _ = split
    sched, _ = _stream_sched(StreamingTrie(base, device="cpu"))
    bad = _one(sched, "insert", ((0, 1, 2, 3, 4, 5, 6, 7), 0.1, 0.2, 0.3))
    assert bad.status == "invalid"
    with pytest.raises(InvalidQueryError):
        sched.submit("insert", ((), 0.1, 0.2, 0.3))


def _stream_frozen_rejects_insert(split):
    _, base, _ = split
    sched, _ = _stream_sched(base)
    assert _one(sched, "insert", ((0,), 0.1, 0.2, 0.3)).status == "invalid"


STREAM_CASES = {
    "no_stale_cache": _stream_no_stale_cache,
    "version_bump": _stream_version_bump,
    "insert_roundtrip_and_refreeze": _stream_insert_roundtrip_and_refreeze,
    "invalid_inserts": _stream_invalid_inserts,
    "frozen_rejects_insert": _stream_frozen_rejects_insert,
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_serve_case(split, case):
    STREAM_CASES[case](split)


def test_launch_predictor_seeds_from_nearest_pow2():
    p = T.LaunchPredictor(default_ms=5.0)
    assert p.predict_ms(("top_k",), 4) == 5.0
    p.observe(("top_k",), 8, 0.010)
    assert p.predict_ms(("top_k",), 8) == 10.0
    assert p.predict_ms(("top_k",), 16) == 10.0
    assert p.predict_ms(("top_k",), 100) == 10.0
    p.observe(("top_k",), 128, 0.080)
    assert p.predict_ms(("top_k",), 100) == 80.0
    assert p.predict_ms(("top_k",), 32) == 10.0
    assert p.predict_ms(("rules_with",), 8) == 5.0


def test_launch_predictor_ewma_converges():
    p = T.LaunchPredictor(alpha=0.5)
    p.observe(("b",), 4, 0.010)
    p.observe(("b",), 4, 0.020)
    assert p.predict_ms(("b",), 4) == pytest.approx(15.0)


# ----------------------------------------------------------------------
# isolation: the serve loop runs with jax and repro unimportable
# ----------------------------------------------------------------------
def test_serve_imports_and_runs_without_jax_or_repro():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch.serve as S\n"
        "from repro_torch.arm.datasets import paper_example_db\n"
        "from repro_torch.core import build_trie_of_rules\n"
        "fz = build_trie_of_rules(paper_example_db(), 0.25, "
        "device='cpu').freeze()\n"
        "clock = S.VirtualClock()\n"
        "inj = S.FaultInjector().fail_transient(1).fail_nth_launch(3)\n"
        "eng = S.TrieQueryEngine(fz, device='cpu')\n"
        "sched = S.TrieScheduler(S.ResilientTrieEngine(\n"
        "    S.FaultyEngine(eng, inj, clock=clock)), clock=clock)\n"
        "for w in S.zipfian_workload(fz, 20, seed=1):\n"
        "    sched.submit(w['op'], w['payload'], w['kwargs'])\n"
        "out = sched.drain()\n"
        "assert len(out) == 20 and all(r.ok for r in out)\n"
        "assert sched.engine.failovers == 1\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
