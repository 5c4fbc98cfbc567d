"""Failure handling for the trie serve loop: clocks, retry/backoff,
shard health, and the backend-demotion ladder.

PyTorch port of ``repro.serve.resilience``: plain Python over the port's
engines.  Both demotion rungs need a primary with a ``plan`` (the
sharded backend): the replicated rung is a one-device engine on the
primary's device (a sharded primary's lead device), and the masked rung
serves ``mask_dead_shards(primary.plan, dead)``.  With a one-device
primary a ``ShardFailure`` records the failure, bumps ``failovers``
(orphaning the scheduler's cache) and re-runs the call on the same
primary, as the reference does.

The scheduler (``serve.scheduler``) stays a pure queueing/batching loop;
everything that decides *where* and *whether to try again* lives here:

* ``VirtualClock`` / ``MonotonicClock`` — one tiny clock seam so the
  whole serve stack runs as a deterministic discrete-event simulation
  under test (and in the bench's virtual-arrival replay) while serving
  real traffic off ``time.monotonic``.
* ``RetryPolicy`` + ``retry_call`` — exponential backoff with
  deterministic seeded jitter around TRANSIENT backend failures
  (``kernels.ops.is_retryable`` is the classifier; invalid queries and
  ``ShardFailure`` never burn retries — retrying the same dead shard or
  the same bad input cannot succeed).
* ``ShardHealth`` — per-shard failure counting plus slow-shard detection
  via the SAME ``StragglerDetector`` EWMA that training elasticity uses
  (``distributed.health``), feeding the demotion ladder.
* ``ResilientTrieEngine`` — wraps a primary ``TrieQueryEngine`` and, on
  per-shard failure, demotes WITHOUT dropping the in-flight batch:
  sharded → replicated (bit-identical answers, ``degraded=False``) →
  dead-shard-masked degraded plan (partial answers, ``degraded=True``).
  The failing call is re-executed on the demoted backend inside the same
  ``query()`` call.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.distributed.health import StragglerDetector
from repro_torch.distributed.trie_sharding import ShardFailure
from repro_torch.kernels.ops import is_retryable


# ----------------------------------------------------------------------
# clocks (the determinism seam)
# ----------------------------------------------------------------------
class MonotonicClock:
    """Real time: ``now`` is ``time.monotonic``, ``sleep`` really sleeps."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock:
    """Discrete-event time: ``sleep`` advances instantly.

    Tests and the bench's arrival replay drive deadlines, backoff
    schedules, and latency accounting through this — every run is
    bit-reproducible because nothing waits on the host."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self._t += max(float(seconds), 0.0)

    advance = sleep


# ----------------------------------------------------------------------
# retry with exponential backoff + deterministic jitter
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``base_ms * multiplier**attempt`` plus uniform jitter in
    ``[0, jitter_frac * raw)`` drawn from a caller-seeded ``Random`` —
    the full schedule is deterministic under a fixed seed."""

    max_retries: int = 3
    base_ms: float = 10.0
    multiplier: float = 2.0
    jitter_frac: float = 0.5

    def backoff_ms(self, attempt: int, rng: random.Random) -> float:
        raw = self.base_ms * self.multiplier ** attempt
        return raw + rng.random() * self.jitter_frac * raw

    def schedule_ms(self, rng: random.Random) -> List[float]:
        """The full backoff schedule a fresh ``rng`` would produce —
        what the deterministic-retry tests assert against."""
        return [
            self.backoff_ms(a, rng) for a in range(self.max_retries)
        ]


def retry_call(
    fn: Callable[[], object],
    policy: RetryPolicy,
    clock,
    rng: random.Random,
    classify: Callable[[BaseException], bool] = is_retryable,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Tuple[object, int]:
    """Run ``fn`` with up to ``policy.max_retries`` retries on transient
    failures.  Returns ``(result, retries_used)``; non-retryable
    exceptions (and exhaustion) propagate to the caller."""
    attempt = 0
    while True:
        try:
            return fn(), attempt
        except BaseException as exc:  # noqa: BLE001 - classified below
            if attempt >= policy.max_retries or not classify(exc):
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            clock.sleep(policy.backoff_ms(attempt, rng) / 1e3)
            attempt += 1


# ----------------------------------------------------------------------
# shard health
# ----------------------------------------------------------------------
class ShardHealth:
    """Per-shard failure + straggler tracking feeding backend demotion.

    * ``record_failure(shard)`` — hard failures (a ``ShardFailure`` from
      fault injection or a real launch error); at ``fail_threshold`` the
      shard joins ``dead``.
    * ``record_launch(shard, seconds)`` — wall-time observations run
      through one ``StragglerDetector`` per shard (the training-side
      EWMA, reused — see ``distributed.health``); a sustained straggle
      puts the shard in ``slow``, and with ``demote_slow=True`` also in
      ``dead`` (a shard answering 10x late is as useless to a deadline
      as one answering never).
    """

    def __init__(
        self,
        n_shards: int,
        fail_threshold: int = 1,
        demote_slow: bool = False,
        detector_factory: Callable[[], StragglerDetector] = (
            StragglerDetector
        ),
        metrics=None,
    ):
        self.n_shards = int(n_shards)
        self.fail_threshold = int(fail_threshold)
        self.demote_slow = bool(demote_slow)
        self._detectors = [detector_factory() for _ in range(n_shards)]
        self._failures = [0] * n_shards
        self.dead: set = set()
        self.slow: set = set()
        self.events: List[dict] = []
        self._step = 0
        # optional obs.MetricsRegistry: every health event doubles as a
        # counter (the ordered ``events`` list stays the source of truth
        # for sequence assertions)
        self.metrics = metrics

    def _event(self, kind: str, shard: int) -> None:
        self.events.append({"kind": kind, "shard": shard})
        if self.metrics is not None:
            self.metrics.counter(
                "serve.shard_events", kind=kind, shard=shard
            ).inc()

    def record_failure(self, shard: int) -> bool:
        """Returns True when this failure kills the shard."""
        s = int(shard)
        if not 0 <= s < self.n_shards:
            raise ValueError(
                f"shard {s} out of range for {self.n_shards} shards"
            )
        self._failures[s] += 1
        self._event("failure", s)
        if self._failures[s] >= self.fail_threshold and s not in self.dead:
            self.dead.add(s)
            self._event("dead", s)
            return True
        return False

    def record_launch(self, shard: int, seconds: float) -> bool:
        """Feed one launch wall-time; returns True on sustained straggle."""
        s = int(shard)
        self._step += 1
        if self._detectors[s].observe(self._step, float(seconds)):
            self.slow.add(s)
            self._event("slow", s)
            if self.demote_slow and s not in self.dead:
                self.dead.add(s)
                self._event("dead", s)
            return True
        return False

    @property
    def healthy(self) -> bool:
        return not self.dead

    def dead_shards(self) -> Tuple[int, ...]:
        return tuple(sorted(self.dead))


# ----------------------------------------------------------------------
# the demotion ladder
# ----------------------------------------------------------------------
class ResilientTrieEngine:
    """A ``TrieQueryEngine`` front that survives shard failure.

    Backend ladder, walked per call based on ``health.dead``:

    1. ``primary`` — whatever the caller built (usually sharded).
    2. replicated fallback — a fresh single-device engine over the SAME
       ``FrozenTrie`` (built lazily on first demotion); bit-identical
       answers, so responses stay ``degraded=False``.
    3. dead-shard-masked degraded plan — when replicated fallback is
       disallowed (``allow_replicated_fallback=False``, e.g. the trie
       does not fit one device), queries run over
       ``mask_dead_shards(primary.plan, dead)``: partial answers,
       flagged ``degraded=True``.

    A ``ShardFailure`` raised mid-call records the failure and RE-RUNS
    the same call on the demoted backend before returning — in-flight
    requests are never dropped on a shard death.
    """

    OPS = ("rule_search_batch", "top_k_rules_batch", "rules_with")

    def __init__(
        self,
        primary,
        health: Optional[ShardHealth] = None,
        allow_replicated_fallback: bool = True,
        obs=None,
    ):
        self.primary = primary
        self.health = health or ShardHealth(primary.n_shards)
        self.allow_replicated_fallback = bool(allow_replicated_fallback)
        self._replicated = None
        self._degraded = None
        self._degraded_for: Tuple = ()
        self.failovers = 0
        self._obs = None
        if obs is not None:
            self.obs = obs

    # -- observability ------------------------------------------------
    @property
    def obs(self):
        """The ``Observability`` bundle this engine reports into.  The
        scheduler assigns its own on construction (unless one was given
        explicitly); the setter fans it out to the health tracker and
        every backend engine so failover transitions, shard events, and
        engine-level spans all land in one registry/tracer."""
        return self._obs

    @obs.setter
    def obs(self, value) -> None:
        self._obs = value
        self.health.metrics = value.metrics if value is not None else None
        for eng in (self.primary, self._replicated, self._degraded):
            if eng is not None and hasattr(eng, "obs"):
                eng.obs = value

    # -- backend selection --------------------------------------------
    def _replicated_engine(self):
        if self._replicated is None:
            from repro_torch.serve.trie_engine import TrieQueryEngine

            # a streaming primary falls back over the STREAM, not its
            # frozen base — the replicated engine keeps merging the
            # delta, so failover answers stay bit-identical
            trie = getattr(self.primary, "stream", None)
            self._replicated = TrieQueryEngine(
                trie if trie is not None else self.primary.frozen,
                mode="replicated", device=self.primary.device,
            )
            self._replicated.obs = self._obs
        return self._replicated

    def _degraded_engine(self):
        dead = self.health.dead_shards()
        # epoch in the cache key: a refreeze swaps the frozen base, so
        # the masked plan must be rebuilt from the new plan; a pre-fold
        # masked plan would answer over a stale trie
        key = (dead, self.epoch)
        if self._degraded is None or self._degraded_for != key:
            from repro_torch.distributed.trie_sharding import (
                mask_dead_shards,
            )
            from repro_torch.serve.trie_engine import TrieQueryEngine

            stream = getattr(self.primary, "stream", None)
            self._degraded = TrieQueryEngine(
                stream if stream is not None else self.primary.frozen,
                plan=mask_dead_shards(self.primary.plan, dead),
            )
            self._degraded.obs = self._obs
            self._degraded_for = key
        return self._degraded

    def _active(self):
        """→ ``(engine, degraded, backend_name)`` for the current health."""
        has_plan = getattr(self.primary, "plan", None) is not None
        if self.health.dead and has_plan:
            if self.allow_replicated_fallback:
                return self._replicated_engine(), False, "replicated"
            return self._degraded_engine(), True, "degraded"
        return self.primary, False, self.primary.backend

    @property
    def backend(self) -> str:
        return self._active()[2]

    @property
    def frozen(self):
        return self.primary.frozen

    @property
    def n_shards(self) -> int:
        return self.primary.n_shards

    @property
    def epoch(self) -> int:
        """Trie-version epoch of the underlying (streaming) engine; 0
        for a plain frozen engine."""
        return int(getattr(self.primary, "epoch", 0))

    @property
    def version(self) -> Tuple[int, int]:
        """``(failovers, epoch)`` — changes whenever cached results could
        go stale: a failover reroutes queries, an insert/refreeze changes
        the trie contents.  The scheduler folds this into its LRU cache
        key, so a version bump orphans every older entry."""
        return (self.failovers, self.epoch)

    # -- streaming passthroughs ---------------------------------------
    def insert(self, sequences, support, confidence, lift) -> int:
        """Absorb inserted/updated rules (streaming primary only)."""
        return self.primary.insert(sequences, support, confidence, lift)

    def maybe_refreeze(self):
        return self.primary.maybe_refreeze()

    # -- the resilient call -------------------------------------------
    def query(self, op: str, *args, **kwargs) -> Tuple[Dict, Dict]:
        """Run one batched op; returns ``(result, info)`` with
        ``info = {"degraded": bool, "backend": str, "failover": bool}``."""
        if op not in self.OPS:
            raise ValueError(f"op {op!r} not in {self.OPS}")
        engine, degraded, backend = self._active()
        try:
            result = getattr(engine, op)(*args, **kwargs)
            return result, {
                "degraded": degraded, "backend": backend,
                "failover": False,
            }
        except ShardFailure as exc:
            obs = self._obs
            prev_backend = backend
            fspan = (obs.tracer.start("failover", shard=int(exc.shard))
                     if obs is not None else None)
            self.health.record_failure(exc.shard)
            self.failovers += 1
            engine, degraded, backend = self._active()
            if obs is not None:
                # the demotion-ladder transition counter the shard-kill
                # regression test asserts: sharded → replicated|degraded
                obs.metrics.counter("serve.failover", labels={
                    "from": prev_backend, "to": backend,
                }).inc()
                obs.tracer.annotate(
                    fspan, **{"from": prev_backend, "to": backend})
            result = getattr(engine, op)(*args, **kwargs)
            if obs is not None:
                obs.tracer.end(fspan)
            return result, {
                "degraded": degraded, "backend": backend,
                "failover": True,
            }
