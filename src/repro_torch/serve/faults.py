"""Deterministic fault injection for the serve loop.

PyTorch port of ``repro.serve.faults``: plain Python and numpy, the same
rule table and the same seeded traffic (the same request dicts as the
reference's from the same seed, on the same trie).

Chaos testing a serving system needs faults that are *repeatable*: the
Nth kernel launch fails, a named shard answers late, a specific query is
poison.  ``FaultInjector`` is a counter-driven rule table with zero
randomness — the same program + the same injector config produces the
same fault sequence — and ``FaultyEngine`` is the seam that applies it:
a drop-in ``TrieQueryEngine`` wrapper that consults the injector before
and after every batched-op launch.  The fault-path tests and
``chip_smoke.py``'s serve phase drive their failure scenarios through
this one layer; production engines never see it.

Faults:

* ``fail_nth_launch(n, shard)`` — the n-th launch (1-based, counted
  across all ops) raises ``trie_sharding.ShardFailure(shard)``; the
  resilience ladder must demote and re-run in-flight work.
* ``fail_transient(n)`` — the n-th launch raises a retryable
  ``TransientBackendError`` (``is_retryable`` → True); the scheduler's
  backoff loop must absorb it.
* ``slow_shard(shard, delay_s)`` — every launch while ``shard`` is slow
  charges ``delay_s`` extra seconds to the injected clock, training
  ``ShardHealth``'s straggler detector.
* ``poison_payload(predicate)`` — launches whose batch contains a
  payload matching ``predicate`` raise ``InvalidQueryError``; the
  scheduler must isolate the poison row, not fail the batch.

``zipfian_workload`` lives here too: the shared multi-tenant traffic
generator (Zipf-ranked query popularity — heavy duplication, like real
rule-serving traffic) replayed by the tests and the serve phase.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.distributed.trie_sharding import ShardFailure
from repro_torch.kernels.ops import InvalidQueryError, TransientBackendError


# ----------------------------------------------------------------------
# the injector (counter-driven, zero randomness)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _Rule:
    kind: str                      # "shard_fail" | "transient" | "poison"
    at_launch: int = 0             # 1-based launch counter match (0 = any)
    shard: int = 0
    predicate: Optional[Callable] = None
    fired: int = 0
    max_fires: int = 1


class FaultInjector:
    """Deterministic fault rule table consulted by ``FaultyEngine``."""

    def __init__(self):
        self.launches = 0           # completed + faulted launch attempts
        self.events: List[dict] = []
        self._rules: List[_Rule] = []
        self._slow: Dict[int, float] = {}   # shard -> extra seconds

    # -- configuration ------------------------------------------------
    def fail_nth_launch(
        self, n: int, shard: int = 0, times: int = 1
    ) -> "FaultInjector":
        self._rules.append(
            _Rule("shard_fail", at_launch=int(n), shard=int(shard),
                  max_fires=int(times))
        )
        return self

    def fail_transient(self, n: int, times: int = 1) -> "FaultInjector":
        self._rules.append(
            _Rule("transient", at_launch=int(n), max_fires=int(times))
        )
        return self

    def slow_shard(self, shard: int, delay_s: float) -> "FaultInjector":
        self._slow[int(shard)] = float(delay_s)
        return self

    def clear_slow(self, shard: int) -> "FaultInjector":
        self._slow.pop(int(shard), None)
        return self

    def poison_payload(
        self, predicate: Callable[[object], bool], times: int = 1
    ) -> "FaultInjector":
        """Launches whose batch payload satisfies ``predicate`` raise
        ``InvalidQueryError`` — the poison-query fault."""
        self._rules.append(
            _Rule("poison", predicate=predicate, max_fires=int(times))
        )
        return self

    # -- the hooks FaultyEngine calls ---------------------------------
    def before_launch(self, op: str, payload) -> None:
        """Counts the launch attempt, then raises if any rule matches."""
        self.launches += 1
        for rule in self._rules:
            if rule.fired >= rule.max_fires:
                continue
            if rule.kind in ("shard_fail", "transient"):
                if rule.at_launch != self.launches:
                    continue
                rule.fired += 1
                self.events.append({
                    "kind": rule.kind, "launch": self.launches, "op": op,
                    "shard": rule.shard,
                })
                if rule.kind == "shard_fail":
                    raise ShardFailure(
                        rule.shard,
                        f"injected: launch {self.launches} ({op})",
                    )
                raise TransientBackendError(
                    f"injected transient: launch {self.launches} ({op})"
                )
            if rule.kind == "poison" and rule.predicate(payload):
                rule.fired += 1
                self.events.append({
                    "kind": "poison", "launch": self.launches, "op": op,
                })
                raise InvalidQueryError(
                    f"injected poison query in launch {self.launches} "
                    f"({op})"
                )

    def extra_latency(self) -> float:
        """Slow-shard latency charged to this launch (every launch
        touches every shard under ``shard_map``, so any slow shard slows
        the whole launch — the straggler effect)."""
        return sum(self._slow.values())

    def shard_latency(self, shard: int) -> float:
        """Per-shard injected latency — the simulated per-shard timing
        probe ``FaultyEngine`` feeds into ``ShardHealth``."""
        return self._slow.get(int(shard), 0.0)


class FaultyEngine:
    """``TrieQueryEngine`` wrapper routing every launch through a
    ``FaultInjector``.  ``clock`` (usually a ``VirtualClock``) is charged
    the injected slow-shard latency so deadline/straggler behavior is
    observable without real sleeping."""

    def __init__(
        self, engine, injector: FaultInjector, clock=None, health=None,
    ):
        self.engine = engine
        self.injector = injector
        self.clock = clock
        # optional ShardHealth: each launch feeds every shard's injected
        # latency into its straggler detector — the simulation stand-in
        # for real per-shard launch profiling.  Note the detector's EWMA
        # baseline comes from the FIRST observation, so a shard slowed
        # before any clean launch is its own baseline and never flags.
        self.health = health

    # passthroughs the resilience ladder reads
    @property
    def obs(self):
        """Observability passthrough: the wrapped engine owns the spans
        (a fault wrapper adds no stage of its own)."""
        return getattr(self.engine, "obs", None)

    @obs.setter
    def obs(self, value) -> None:
        self.engine.obs = value

    @property
    def frozen(self):
        return self.engine.frozen

    @property
    def plan(self):
        return self.engine.plan

    @property
    def stream(self):
        return getattr(self.engine, "stream", None)

    @property
    def device(self):
        return self.engine.device

    @property
    def epoch(self) -> int:
        return int(getattr(self.engine, "epoch", 0))

    # streaming mutations bypass fault injection: they are host-side
    # bookkeeping, not launches
    def insert(self, sequences, support, confidence, lift) -> int:
        return self.engine.insert(sequences, support, confidence, lift)

    def maybe_refreeze(self):
        return self.engine.maybe_refreeze()

    @property
    def backend(self) -> str:
        return self.engine.backend

    @property
    def n_shards(self) -> int:
        return self.engine.n_shards

    def _launch(self, op: str, payload, fn):
        self.injector.before_launch(op, payload)
        out = fn()
        delay = self.injector.extra_latency()
        if delay and self.clock is not None:
            self.clock.sleep(delay)
        if self.health is not None:
            for shard in range(self.engine.n_shards):
                self.health.record_launch(
                    shard, self.injector.shard_latency(shard)
                )
        return out

    def rule_search_batch(self, queries, ant_len=None):
        return self._launch(
            "rule_search_batch", queries,
            lambda: self.engine.rule_search_batch(queries, ant_len),
        )

    def top_k_rules_batch(self, prefixes, k, **kw):
        return self._launch(
            "top_k_rules_batch", prefixes,
            lambda: self.engine.top_k_rules_batch(prefixes, k, **kw),
        )

    def rules_with(self, items, **kw):
        return self._launch(
            "rules_with", items,
            lambda: self.engine.rules_with(items, **kw),
        )


# ----------------------------------------------------------------------
# zipfian multi-tenant traffic
# ----------------------------------------------------------------------
def zipfian_workload(
    frozen,
    n_requests: int,
    seed: int = 0,
    s: float = 1.2,
    n_tenants: int = 4,
    op_mix: Tuple[float, float, float] = (0.5, 0.3, 0.2),
    deadline_ms: Tuple[float, ...] = (50.0, 200.0, 1000.0),
    arrival_rate: Optional[float] = None,
) -> List[dict]:
    """``n_requests`` request dicts replaying skewed serving traffic.

    Query *popularity* is Zipf-ranked (popularity rank r drawn with
    probability ∝ r^-s) over a pool of distinct queries per op, so a
    small hot set dominates — exactly the duplication profile the
    whole-query dedup + LRU cache exist for.  Ops mix over
    (rule_search, top_k, rules_with) by ``op_mix``; tenants round-robin
    a seeded permutation; deadlines cycle ``deadline_ms`` per tenant.
    With ``arrival_rate`` (requests/second) each dict carries an
    ``arrival_s`` drawn from a seeded Poisson process; otherwise all
    arrive at 0.

    Returns plain dicts (op / payload / kwargs / tenant / deadline_ms /
    arrival_s) — the scheduler's ``Request`` constructor consumes them.
    """
    rng = np.random.default_rng(seed)
    n_items = int(np.asarray(frozen.item_offsets).shape[0] - 1)
    # distinct-query pools per op, drawn once from real trie paths
    pool_n = max(min(64, n_requests), 1)
    edge_item = np.asarray(frozen.edge_item, np.int64)
    edge_parent = np.asarray(frozen.edge_parent, np.int64)
    edge_child = np.asarray(frozen.edge_child, np.int64)

    def random_path():
        """A real root-to-node path (item sequence) of depth 1-4."""
        items = []
        node = 0
        for _ in range(int(rng.integers(1, 5))):
            mask = edge_parent == node
            if not mask.any():
                break
            j = int(rng.choice(np.flatnonzero(mask)))
            items.append(int(edge_item[j]))
            node = int(edge_child[j])
        return items or [int(rng.integers(0, max(n_items, 1)))]

    search_pool = []
    for _ in range(pool_n):
        path = random_path()
        cut = int(rng.integers(1, len(path) + 1)) if len(path) > 1 else 1
        search_pool.append((tuple(path[:cut]), tuple(path[cut:])))
    topk_pool = [tuple(random_path()[:2]) for _ in range(pool_n)]
    item_pool = [
        int(rng.integers(0, max(n_items, 1))) for _ in range(pool_n)
    ]

    # Zipf popularity ranks over each pool
    ranks = np.arange(1, pool_n + 1, dtype=np.float64)
    pz = ranks ** -s
    pz /= pz.sum()
    ops = rng.choice(3, size=n_requests, p=np.asarray(op_mix))
    picks = rng.choice(pool_n, size=n_requests, p=pz)
    tenants = rng.permutation(n_tenants)
    arrivals = np.zeros(n_requests)
    if arrival_rate:
        arrivals = np.cumsum(
            rng.exponential(1.0 / arrival_rate, size=n_requests)
        )
    out: List[dict] = []
    for i in range(n_requests):
        tenant = int(tenants[i % n_tenants])
        req = {
            "tenant": f"tenant-{tenant}",
            "deadline_ms": float(deadline_ms[tenant % len(deadline_ms)]),
            "arrival_s": float(arrivals[i]),
        }
        if ops[i] == 0:
            ant, con = search_pool[picks[i]]
            # depth-1 paths leave the consequent empty; re-ask the path
            # item as its own consequent (a miss — real traffic has them)
            con = con or ant
            req.update(op="rule_search", payload=(list(ant), list(con)),
                       kwargs={})
        elif ops[i] == 1:
            req.update(
                op="top_k", payload=list(topk_pool[picks[i]]),
                kwargs={"k": 8, "metric": "confidence"},
            )
        else:
            req.update(
                op="rules_with", payload=item_pool[picks[i]],
                kwargs={"role": "any", "k": 8, "metric": "lift"},
            )
        out.append(req)
    return out
