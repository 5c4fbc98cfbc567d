"""Resilient continuous-batching serve loop over ``TrieQueryEngine``.

PyTorch port of ``repro.serve.scheduler``: the same loop, answer for
answer, over the port's engines.  Two things differ because the port's
ops return device tensors: each batch's result fields are copied to the
host once (one ``.cpu()`` per field) before its rows are sliced, and
that copy sits inside the retried call and the timed launch window, so
with a real ``timer`` the measured service time includes the device's
work (the copy waits for the kernels) rather than only their
asynchronous launch, and an error the device reports at the copy is
retried or answered as a failed response like any other.

The paper's claim is that the Trie of Rules makes *serving a ruleset*
fast; this module turns the one-batch-per-call engine into a system that
survives production traffic: a stream of ragged, skewed, mixed-op
requests that duplicate heavily, carry deadlines, and outlive failed
shards.  The JetStream-style loop:

    submit() ──► bounded admission queue ──► step(): ──► Response
                 (QueueFull beyond            1 expire deadlines
                  max_pending; shed           2 serve LRU-cache hits
                  policy pluggable)           3 shape one bucket batch
                                                (same op+kwargs, ≤
                                                max_batch, pow2-padded
                                                by the kernels)
                                              4 dedup identical rows
                                              5 launch w/ retry+backoff
                                                (ShardFailure → the
                                                resilience ladder
                                                demotes mid-call)
                                              6 scatter rows, fill cache

Every request is ONE query row (a rule pair, a ranked prefix, or an
item), so canonical-key hashing gives whole-query dedup for free: the
key that addresses the LRU result cache is the same key that collapses
duplicates inside a batch, lifting the per-item dedup ``rules_with``
already does to whole queries of every op.  Cache addresses are
versioned with the engine's ``(failovers, epoch)`` — a streaming insert
or refreeze (or a shard failover) orphans every older entry, so a
post-insert query can never be answered by a pre-insert row.

A fourth op, ``insert``, feeds a ``StreamingTrie``-backed engine: all
pending inserts apply host-side at the top of ``step()`` in arrival
order (writes never ride a query batch, are never deduped, never
cached), followed by at most one staggered refreeze fold — the
single-threaded step loop makes the frozen-base swap atomic w.r.t.
in-flight queries.

Deadlines are enforced at three points: queued requests past their
``deadline_ms`` expire to ``Timeout`` (never a hang), the batch shaper
refuses to pack a request whose predicted launch (per-bucket EWMA of
measured service time) would bust its budget — it times out immediately
instead of poisoning a batch it cannot survive — and post-launch expiry
still returns ``Timeout`` (the computed row only feeds the cache).

Time flows through the ``resilience`` clock seam: tests and the bench
replay drive a ``VirtualClock`` (deterministic backoff/deadline
behavior, injected fault latency), while a separate real ``timer``
measures kernel service time and charges it to the virtual timeline —
honest latency distributions under a reproducible arrival process.
"""
from __future__ import annotations

import dataclasses
import math
import random
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from repro_torch.core.array_trie import canonical_prefix_rows
from repro_torch.kernels.ops import (
    InvalidQueryError,
    validate_items,
    validate_prefixes,
    validate_rule_pairs,
)
from repro_torch.kernels.tuning import launch_pad
from repro_torch.obs import Observability
from repro_torch.serve.resilience import (
    MonotonicClock,
    ResilientTrieEngine,
    RetryPolicy,
    retry_call,
)

OPS = ("rule_search", "top_k", "rules_with", "insert")

# the stable stats-snapshot schema: every key pre-seeded at construction
# (``inserted``/``refreezes`` used to appear lazily on first insert)
STAT_KEYS = (
    "submitted", "ok", "timeout", "shed", "failed", "invalid",
    "cache_hits", "dedup_collapsed", "retries", "launches",
    "inserted", "refreezes",
)

# Response.status values
OK = "ok"
TIMEOUT = "timeout"
SHED = "shed"
FAILED = "failed"
INVALID = "invalid"


class QueueFull(Exception):
    """Admission rejected: the pending queue is at ``max_pending`` and
    the shed policy chose to reject the newcomer."""

    def __init__(self, request=None):
        self.request = request
        super().__init__("admission queue full")


@dataclasses.dataclass
class Request:
    """One query row travelling through the loop."""

    id: int
    op: str                      # "rule_search" | "top_k" | "rules_with"
    payload: object              # (ant, con) | prefix items | item id
    kwargs: Dict                 # op kwargs (k / metric / role / ...)
    tenant: str
    deadline_ms: float           # budget from submit; inf = none
    submit_s: float              # clock time at admission
    key: Tuple = ()              # canonical whole-query key (dedup+cache)
    bucket: Tuple = ()           # batchable group: (op, kwargs signature)
    canon: object = None         # canonical payload for batch assembly
    span: object = None          # root trace span (None when tracing off)
    qspan: object = None         # "queue" child span, open while queued
    sspan: object = None         # "serve" child span, open while batched

    def expires_s(self) -> float:
        if math.isinf(self.deadline_ms):
            return math.inf
        return self.submit_s + self.deadline_ms / 1e3


@dataclasses.dataclass
class Response:
    id: int
    op: str
    tenant: str
    status: str                  # OK / TIMEOUT / SHED / FAILED / INVALID
    result: Optional[Dict] = None   # per-row numpy slice of the op output
    degraded: bool = False       # answered over a dead-shard-masked plan
    backend: str = ""            # "sharded"/"replicated"/"degraded"/"cache"
    cache_hit: bool = False
    retries: int = 0
    latency_ms: float = 0.0
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.status == OK


class LaunchPredictor:
    """EWMA of measured service seconds per (bucket, pow2 batch size) —
    the batch shaper's deadline oracle.

    An unseen shape seeds from the NEAREST observed pow2 batch size of
    the same bucket (nearest in log2 — a 64-row launch is a far better
    prior for 128 rows than ``default_ms``; service time grows roughly
    linearly in padded rows, so the adjacent bucket is within ~2x while
    the cold default is unboundedly wrong).  Only a bucket with no
    observations at ANY batch size predicts ``default_ms`` (0 by
    default: never preemptively time out before the first observation).
    """

    def __init__(self, alpha: float = 0.3, default_ms: float = 0.0):
        self.alpha = float(alpha)
        self.default_ms = float(default_ms)
        self._ewma_ms: Dict[Tuple, float] = {}

    @staticmethod
    def _shape(bucket: Tuple, batch: int) -> Tuple:
        return (*bucket, launch_pad(batch))

    def predict_ms(self, bucket: Tuple, batch: int) -> float:
        key = self._shape(bucket, batch)
        got = self._ewma_ms.get(key)
        if got is not None:
            return got
        # nearest observed pow2 size for this bucket; ties prefer the
        # smaller size (under-prediction only delays a timeout until the
        # first real observation corrects it)
        pad = key[-1]
        sizes = [
            k[-1] for k in self._ewma_ms if k[:-1] == key[:-1]
        ]
        if not sizes:
            return self.default_ms
        near = min(
            sizes,
            key=lambda s: (abs(math.log2(s) - math.log2(pad)), s),
        )
        return self._ewma_ms[(*key[:-1], near)]

    def observe(self, bucket: Tuple, batch: int, seconds: float) -> None:
        key = self._shape(bucket, batch)
        ms = float(seconds) * 1e3
        prev = self._ewma_ms.get(key)
        self._ewma_ms[key] = ms if prev is None else (
            (1 - self.alpha) * prev + self.alpha * ms
        )


class TrieScheduler:
    """Continuous-batching scheduler over a (resilient) trie engine.

    ``engine`` may be a plain ``TrieQueryEngine`` (wrapped into a
    ``ResilientTrieEngine`` automatically), an already-wrapped resilient
    engine, or a fault-injected ``FaultyEngine`` wrapped by one.
    """

    def __init__(
        self,
        engine,
        max_pending: int = 256,
        max_batch: int = 64,
        cache_size: int = 1024,
        retry_policy: Optional[RetryPolicy] = None,
        shed_policy: Union[str, Callable] = "reject_new",
        clock=None,
        timer: Optional[Callable[[], float]] = None,
        seed: int = 0,
        strict_admission: bool = True,
        predictor: Optional[LaunchPredictor] = None,
        obs: Optional[Observability] = None,
    ):
        if not isinstance(engine, ResilientTrieEngine):
            engine = ResilientTrieEngine(engine)
        self.engine = engine
        self._qwidth_of = None
        self._qwidth_v = 1
        self.max_pending = int(max_pending)
        self.max_batch = int(max_batch)
        self.retry_policy = retry_policy or RetryPolicy()
        if isinstance(shed_policy, str) and shed_policy not in (
            "reject_new", "drop_oldest"
        ):
            raise ValueError(
                f"shed_policy {shed_policy!r} not in "
                "('reject_new', 'drop_oldest') and not callable"
            )
        self.shed_policy = shed_policy
        self.strict_admission = bool(strict_admission)
        self.clock = clock or MonotonicClock()
        self._timer = timer
        self._rng = random.Random(seed)
        self.predictor = predictor or LaunchPredictor()
        self._pending: deque = deque()
        self._cache: OrderedDict = OrderedDict()
        self.cache_size = int(cache_size)
        self.responses: Dict[int, Response] = {}
        self._next_id = 0
        # observability: the metrics registry replaces the old ad-hoc
        # ``stats`` dict (read it back through the ``stats`` property);
        # instruments for the legacy keys are held directly so hot-path
        # cost stays one attribute lookup + an int add.  Tracing is off
        # unless the caller's Observability enables it.
        self.obs = obs if obs is not None else Observability()
        self.obs.bind_clock(self.clock)
        m = self.obs.metrics
        self._c = {k: m.counter("serve." + k) for k in STAT_KEYS}
        self._g_pending = m.gauge("serve.pending")
        self._g_cache = m.gauge("serve.cache_len")
        if getattr(self.engine, "obs", None) is None:
            self.engine.obs = self.obs
        # measured kernel wall time (when the profiler is scoped on)
        # becomes a queryable predictor bucket — see _observe_kernel
        if self.obs.profiler is not None:
            self.obs.profiler.add_observer(self._observe_kernel)

    @property
    def stats(self) -> Dict[str, int]:
        """Read-compatible snapshot of the legacy counters (now backed by
        ``obs.metrics``).  Schema is stable: every key is pre-seeded at
        construction, including ``inserted``/``refreezes``."""
        return {k: c.value for k, c in self._c.items()}

    def _observe_kernel(self, rec) -> None:
        """Kernel-ring observer: measured launch wall time lands in a
        ``("kernel", op)`` predictor bucket — disjoint from the
        service-time buckets the deadline shaper reads, so profiling
        never skews admission decisions."""
        self.predictor.observe(("kernel", rec.op), rec.rows, rec.seconds)

    @property
    def frozen(self):
        """The engine's CURRENT frozen base — a property because a
        streaming refreeze swaps it mid-stream (item tables, which all
        canonicalization reads, are fixed for the vocab either way)."""
        return self.engine.frozen

    @property
    def _qwidth(self) -> int:
        """Fixed query-matrix width: canonical rows are root paths, so the
        trie's max depth bounds them; padding every launch to this pow2
        width (and batches to pow2 rows) keeps the set of launch shapes
        bounded under arbitrary traffic.  Read from the current frozen
        base, again after a refreeze swaps it (wider rows widen their
        own batch either way; the padding never changes an answer)."""
        fz = self.frozen
        if fz is not self._qwidth_of:
            depth = np.asarray(getattr(fz, "node_depth", [1]))
            max_w = int(depth.max()) if depth.size else 1
            self._qwidth_v = 1 << max(max_w - 1, 0).bit_length()
            self._qwidth_of = fz
        return self._qwidth_v

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _canonicalize(self, op, payload, kwargs):
        """→ ``(key, bucket, canon)``; raises ``InvalidQueryError`` on a
        malformed payload (strict mode also rejects out-of-vocab ids —
        poison never reaches a batch)."""
        strict = self.strict_admission
        rank = getattr(self.frozen, "item_rank", None)
        if op == "rule_search":
            ant, con = payload
            validate_rule_pairs(
                [(ant, con)], "rule_search_batch", item_rank=rank,
                strict=strict,
            )
            rows, als = self.frozen.canonicalize_queries([ant], [con])
            row = tuple(int(x) for x in np.asarray(rows)[0])
            al = int(np.asarray(als)[0])
            return ("rule_search", row, al), ("rule_search",), (row, al)
        if op == "top_k":
            validate_prefixes(
                [payload], "top_k_rules_batch", item_rank=rank,
                strict=strict,
            )
            crow = tuple(
                int(x) for x in canonical_prefix_rows([payload], rank)[0]
            )
            sig = (
                int(kwargs.get("k", 10)),
                str(kwargs.get("metric", "confidence")),
                int(kwargs.get("min_depth", 1)),
            )
            return ("top_k", crow, sig), ("top_k", sig), crow
        if op == "rules_with":
            it = validate_items(
                [payload], "rules_with",
                n_items=int(np.asarray(self.frozen.item_offsets).shape[0])
                - 1,
                strict=strict,
            )[0]
            sig = (
                str(kwargs.get("role", "any")),
                int(kwargs.get("k", 10)),
                str(kwargs.get("metric", "confidence")),
                int(kwargs.get("min_depth", 1)),
            )
            return ("rules_with", it, sig), ("rules_with", sig), it
        if op == "insert":
            seq, sup, conf, lift = payload
            if not len(seq):
                raise InvalidQueryError(
                    "insert: rule path must be non-empty"
                )
            validate_prefixes(
                [seq], "insert", item_rank=rank, strict=strict,
            )
            canon = (
                tuple(int(x) for x in seq),
                float(sup), float(conf), float(lift),
            )
            # keyed by admission id: inserts are WRITES — two identical
            # inserts must both apply (never deduped, never cached)
            return ("insert", self._next_id), ("insert",), canon
        raise InvalidQueryError(f"op {op!r} not in {OPS}")

    def submit(
        self,
        op: str,
        payload,
        kwargs: Optional[Dict] = None,
        deadline_ms: float = math.inf,
        tenant: str = "default",
    ) -> Request:
        """Admit one request; raises ``QueueFull`` when the bounded queue
        rejects it and ``InvalidQueryError`` on malformed payloads."""
        kwargs = dict(kwargs or {})
        tr = self.obs.tracer
        m = self.obs.metrics
        root = tr.start("request", parent=False, op=op, tenant=tenant,
                        req=self._next_id)
        admit = tr.start("admit", parent=root, op=op)
        try:
            key, bucket, canon = self._canonicalize(op, payload, kwargs)
        except InvalidQueryError:
            self._c["invalid"].inc()
            tr.end(admit, error="invalid")
            tr.end(root, status=INVALID)
            raise
        if len(self._pending) >= self.max_pending:
            victim = self._pick_victim()
            if victim is None:
                self._c["shed"].inc()
                m.counter("serve.shed_admission", tenant=tenant,
                          reason="reject_new").inc()
                tr.end(admit, error="shed")
                tr.end(root, status=SHED)
                raise QueueFull()
            self._pending.remove(victim)
            m.counter("serve.shed_admission", tenant=victim.tenant,
                      reason="drop_oldest").inc()
            self._finish(victim, Response(
                id=victim.id, op=victim.op, tenant=victim.tenant,
                status=SHED, error="shed by drop_oldest policy",
            ))
        req = Request(
            id=self._next_id, op=op, payload=payload, kwargs=kwargs,
            tenant=tenant, deadline_ms=float(deadline_ms),
            submit_s=self.clock.now(), key=key, bucket=bucket,
            canon=canon, span=root,
        )
        self._next_id += 1
        self._c["submitted"].inc()
        m.counter("serve.admitted", tenant=tenant, op=op).inc()
        tr.end(admit)
        req.qspan = tr.start("queue", parent=root)
        self._pending.append(req)
        return req

    def _pick_victim(self) -> Optional[Request]:
        if callable(self.shed_policy):
            return self.shed_policy(self._pending)
        if self.shed_policy == "drop_oldest" and self._pending:
            return self._pending[0]
        return None            # reject_new

    @property
    def pending(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------------
    # the serve step
    # ------------------------------------------------------------------
    def step(self) -> List[Response]:
        """Expire deadlines, serve cache hits, launch ONE shaped batch.
        Returns the responses completed by this step (possibly empty)."""
        done: List[Response] = []
        tr = self.obs.tracer
        sroot = tr.start("step", parent=False)
        try:
            self._expire(done)
            self._drain_inserts(done, parent=sroot)
            if not self._pending:
                return done

            # shape one batch: the head request's bucket, arrival order
            with tr.span("batch_form", parent=sroot) as bspan:
                bucket = self._pending[0].bucket
                batch: List[Request] = []
                keep: deque = deque()
                while self._pending:
                    r = self._pending.popleft()
                    if r.bucket == bucket and len(batch) < self.max_batch:
                        batch.append(r)
                    else:
                        keep.append(r)
                self._pending = keep
                tr.annotate(bspan, op=bucket[0], batch=len(batch))
                if tr.enabled:
                    for r in batch:
                        tr.end(r.qspan)
                        r.sspan = tr.start("serve", parent=r.span,
                                           op=r.op)

            with tr.span("dedup_cache", parent=sroot, op=bucket[0]):
                # cache hits never touch the kernels
                misses: List[Request] = []
                for r in batch:
                    hit = self._cache_get(r.key)
                    if hit is not None:
                        self._c["cache_hits"].inc()
                        done.append(self._finish(r, self._respond_ok(
                            r, hit, backend="cache", cache_hit=True,
                        )))
                    else:
                        misses.append(r)
                if not misses:
                    return done

                # whole-query dedup inside the batch
                unique: "OrderedDict[Tuple, List[Request]]" = OrderedDict()
                for r in misses:
                    unique.setdefault(r.key, []).append(r)
                self._c["dedup_collapsed"].inc(len(misses) - len(unique))

                # the deadline shaper: predicted service for THIS bucket
                # shape — a request that cannot survive the launch times
                # out now rather than riding (and slowing) a batch it
                # will miss anyway
                predicted_ms = self.predictor.predict_ms(
                    bucket, len(unique))
                now = self.clock.now()
                live: "OrderedDict[Tuple, List[Request]]" = OrderedDict()
                for key, reqs in unique.items():
                    still = []
                    for r in reqs:
                        if now + predicted_ms / 1e3 > r.expires_s():
                            done.append(self._finish(r, Response(
                                id=r.id, op=r.op, tenant=r.tenant,
                                status=TIMEOUT,
                                error=(
                                    f"predicted launch {predicted_ms:.1f}"
                                    f"ms busts deadline "
                                    f"{r.deadline_ms:.1f}ms"
                                ),
                                latency_ms=(now - r.submit_s) * 1e3,
                            )))
                        else:
                            still.append(r)
                    if still:
                        live[key] = still
                if not live:
                    return done

            done.extend(self._launch(bucket, live, parent=sroot))
            return done
        finally:
            self._g_pending.set(len(self._pending))
            self._g_cache.set(len(self._cache))
            tr.end(sroot, completed=len(done))

    def _drain_inserts(self, done: List[Response], parent=None) -> None:
        """Apply every pending insert, in arrival order, before any
        query batch is shaped.  Writes never ride a query batch: each
        one lands host-side immediately (bumping the engine epoch, which
        orphans every cached pre-insert row), and at most ONE staggered
        refreeze fold runs per step — the single-threaded step loop is
        what makes the frozen-base swap atomic w.r.t. in-flight queries.
        """
        if not any(r.op == "insert" for r in self._pending):
            return
        tr = self.obs.tracer
        with tr.span("insert_drain", parent=parent) as dspan:
            keep: deque = deque()
            inserts: List[Request] = []
            while self._pending:
                r = self._pending.popleft()
                (inserts if r.op == "insert" else keep).append(r)
            self._pending = keep
            tr.annotate(dspan, n=len(inserts))
            if tr.enabled:
                for r in inserts:
                    tr.end(r.qspan)
                    r.sspan = tr.start("serve", parent=r.span, op="insert")
            for r in inserts:
                seq, sup, conf, lift = r.canon
                try:
                    self.engine.insert([seq], [sup], [conf], [lift])
                except (TypeError, ValueError) as exc:
                    # non-streaming engine (TypeError) or a rejected rule
                    # (out-of-vocab / prefix-closure): isolated per request
                    done.append(self._finish(r, Response(
                        id=r.id, op=r.op, tenant=r.tenant, status=INVALID,
                        error=repr(exc),
                        latency_ms=(self.clock.now() - r.submit_s) * 1e3,
                    )))
                    continue
                self._c["inserted"].inc()
                done.append(self._finish(r, self._respond_ok(
                    r, {"epoch": self.engine.epoch}, backend="insert",
                )))
            with tr.span("refreeze", parent=dspan) as fspan:
                folded = self.engine.maybe_refreeze()
                tr.annotate(
                    fspan, folded=0 if folded is None else int(folded))
            if folded is not None:
                self._c["refreezes"].inc()

    def drain(self, max_steps: int = 100000) -> List[Response]:
        """Step until the queue is empty; returns responses in completion
        order."""
        out: List[Response] = []
        for _ in range(max_steps):
            if not self._pending:
                break
            out.extend(self.step())
        return out

    # ------------------------------------------------------------------
    # launch machinery
    # ------------------------------------------------------------------
    def _launch(self, bucket, live, parent=None) -> List[Response]:
        """One kernel launch over the unique rows (with retry/backoff and
        shard-failure failover), then scatter rows to every duplicate."""
        op = bucket[0]
        keys = list(live.keys())
        retries = {"n": 0}
        tr = self.obs.tracer

        def on_retry(attempt, exc):
            retries["n"] += 1
            self._c["retries"].inc()

        c0 = self.clock.now()
        t0 = self._timer() if self._timer is not None else None
        try:
            # scoped span: engine/resilience spans nest under it via the
            # tracer's current-span stack
            with tr.span("launch", parent=parent, op=op,
                         n_unique=len(keys)) as lspan:
                # the host copy waits for the device: inside the timed
                # window, service time is the device's work too
                (result, info), _ = retry_call(
                    lambda: self._execute_on_host(
                        op, [live[k][0] for k in keys]),
                    self.retry_policy, self.clock, self._rng,
                    on_retry=on_retry,
                )
                dt_real = (
                    self._timer() - t0 if self._timer is not None else 0.0
                )
                if dt_real:
                    # charge measured kernel service time to the virtual
                    # timeline (inside the span: launch duration = service)
                    self.clock.sleep(dt_real)
                tr.annotate(
                    lspan, backend=info["backend"],
                    degraded=info["degraded"], retries=retries["n"],
                )
        except InvalidQueryError:
            # poison in the batch: isolate per unique row so one bad
            # query cannot fail its batchmates
            return self._launch_isolated(op, live, retries, parent=parent)
        except Exception as exc:  # noqa: BLE001 - reported per request
            return [
                self._finish(r, Response(
                    id=r.id, op=r.op, tenant=r.tenant, status=FAILED,
                    retries=retries["n"], error=repr(exc),
                    latency_ms=(self.clock.now() - r.submit_s) * 1e3,
                ))
                for reqs in live.values() for r in reqs
            ]
        # virtual-clock runs: injected latency shows in the clock delta
        # (the timer charge was just added); real-clock runs: the clock
        # delta IS the measured elapsed time
        service_s = max(self.clock.now() - c0, dt_real)
        self._c["launches"].inc()
        self.predictor.observe(bucket, len(keys), service_s)

        with tr.span("merge", parent=parent, op=op):
            rows = self._slice_rows(result, len(keys))
            out: List[Response] = []
            for i, key in enumerate(keys):
                row = rows[i]
                if not info["degraded"]:
                    self._cache_put(key, row)
                for r in live[key]:
                    out.append(self._finish(r, self._respond_ok(
                        r, row, backend=info["backend"],
                        degraded=info["degraded"], retries=retries["n"],
                    )))
        return out

    def _launch_isolated(self, op, live, retries, parent=None
                         ) -> List[Response]:
        out: List[Response] = []
        tr = self.obs.tracer
        for key, reqs in live.items():
            try:
                with tr.span("launch", parent=parent, op=op, n_unique=1,
                             isolated=True):
                    (result, info), _ = retry_call(
                        lambda: self._execute_on_host(op, [reqs[0]]),
                        self.retry_policy, self.clock, self._rng,
                    )
            except Exception as exc:  # noqa: BLE001
                status = (
                    INVALID if isinstance(exc, InvalidQueryError)
                    else FAILED
                )
                for r in reqs:
                    out.append(self._finish(r, Response(
                        id=r.id, op=r.op, tenant=r.tenant, status=status,
                        error=repr(exc),
                        latency_ms=(
                            self.clock.now() - r.submit_s
                        ) * 1e3,
                    )))
                continue
            self._c["launches"].inc()
            row = self._slice_rows(result, 1)[0]
            if not info["degraded"]:
                self._cache_put(key, row)
            for r in reqs:
                out.append(self._finish(r, self._respond_ok(
                    r, row, backend=info["backend"],
                    degraded=info["degraded"], retries=retries["n"],
                )))
        return out

    def _execute(self, op: str, reps: Sequence[Request]):
        """One engine call over the representative requests' canonical
        payloads (all share the batch bucket, so kwargs agree).

        Launch shapes are normalized — batch rows pad to the next power
        of two and query rows to the fixed ``_qwidth`` — so a stream of
        arbitrary batch compositions makes a bounded set of launch shapes.
        Pad rows are distinct absent-item queries (ids ``-2-i``: live
        negatives, never matched, never collapsed by downstream dedup),
        so they cost one empty descent each and the first ``len(reps)``
        output rows are untouched.
        """
        kw = reps[0].kwargs
        n = len(reps)
        npad = launch_pad(n)
        if op == "rule_search":
            width = max(self._qwidth,
                        max(len(r.canon[0]) for r in reps), 1)
            q = np.full((n, width), -1, np.int32)
            al = np.zeros((n,), np.int32)
            for i, r in enumerate(reps):
                row, a = r.canon
                q[i, : len(row)] = row
                al[i] = a
            # batch pow2 padding happens inside rule_search_batch's
            # whole-query dedup (ops.dedup_query_rows)
            return self.engine.query("rule_search_batch", q, al)
        if op == "top_k":
            width = max(self._qwidth,
                        max((len(r.canon) for r in reps), default=0), 1)
            mat = np.full((npad, width), -1, np.int32)
            for i, r in enumerate(reps):
                mat[i, : len(r.canon)] = r.canon
            # pad rows query an absent item -> empty [0, 0) range
            mat[n:, 0] = -2
            return self.engine.query(
                "top_k_rules_batch", mat,
                int(kw.get("k", 10)),
                metric=kw.get("metric", "confidence"),
                min_depth=int(kw.get("min_depth", 1)),
            )
        # distinct absent pad items keep the op's internal unique count
        # at exactly npad (a pow2) instead of an arbitrary n+1
        items = [r.canon for r in reps]
        items += [-2 - i for i in range(npad - n)]
        return self.engine.query(
            "rules_with", items,
            role=kw.get("role", "any"), k=int(kw.get("k", 10)),
            metric=kw.get("metric", "confidence"),
            min_depth=int(kw.get("min_depth", 1)),
        )

    def _execute_on_host(self, op: str, reps: Sequence[Request]):
        """``_execute`` with its result fields copied to the host.  The
        copy waits for the device, so an error the device defers surfaces
        here, inside the retried call."""
        result, info = self._execute(op, reps)
        return self._to_host(result), info

    @staticmethod
    def _to_host(result: Dict) -> Dict:
        """One host copy per result field (numpy, dtypes kept)."""
        return {
            k: v.cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)
            for k, v in result.items()
        }

    @staticmethod
    def _slice_rows(host: Dict, n: int) -> List[Dict]:
        return [
            {k: v[i] for k, v in host.items()} for i in range(n)
        ]

    # ------------------------------------------------------------------
    # responses / cache / deadlines
    # ------------------------------------------------------------------
    def _respond_ok(
        self, r: Request, row: Dict, backend: str,
        degraded: bool = False, cache_hit: bool = False, retries: int = 0,
    ) -> Response:
        return Response(
            id=r.id, op=r.op, tenant=r.tenant, status=OK, result=row,
            degraded=degraded, backend=backend, cache_hit=cache_hit,
            retries=retries,
            latency_ms=(self.clock.now() - r.submit_s) * 1e3,
        )

    def _finish(self, r: Request, resp: Response) -> Response:
        self._c[resp.status].inc()
        m = self.obs.metrics
        m.counter("serve.requests", tenant=r.tenant,
                  status=resp.status).inc()
        m.histogram("serve.latency_ms", op=r.op,
                    tenant=r.tenant).observe(resp.latency_ms)
        tr = self.obs.tracer
        if tr.enabled and r.span is not None:
            tr.end(r.qspan)
            tr.end(r.sspan)
            rsp = tr.start("respond", parent=r.span, status=resp.status)
            tr.end(rsp)
            tr.end(r.span, status=resp.status,
                   latency_ms=round(resp.latency_ms, 3),
                   backend=resp.backend, cache_hit=resp.cache_hit)
        self.responses[r.id] = resp
        return resp

    def _expire(self, done: List[Response]) -> None:
        now = self.clock.now()
        keep: deque = deque()
        while self._pending:
            r = self._pending.popleft()
            if now > r.expires_s():
                done.append(self._finish(r, Response(
                    id=r.id, op=r.op, tenant=r.tenant, status=TIMEOUT,
                    error="deadline expired in queue",
                    latency_ms=(now - r.submit_s) * 1e3,
                )))
            else:
                keep.append(r)
        self._pending = keep

    def _vkey(self, key) -> Tuple:
        """Cache address = engine version + canonical query key.

        The canonical key alone is NOT a stable address: it names the
        question, not the trie that answers it.  After an insert or a
        refreeze (epoch bump) or a shard failover, the same question has
        a different answer — versioning the key orphans every stale
        entry instead of serving a pre-insert row to a post-insert
        query.  Orphans age out of the LRU normally."""
        return (getattr(self.engine, "version", (0, 0)), key)

    def _cache_get(self, key):
        vkey = self._vkey(key)
        if vkey in self._cache:
            self._cache.move_to_end(vkey)
            return self._cache[vkey]
        return None

    def _cache_put(self, key, row) -> None:
        if self.cache_size <= 0:
            return
        vkey = self._vkey(key)
        self._cache[vkey] = row
        self._cache.move_to_end(vkey)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    @property
    def cache_len(self) -> int:
        return len(self._cache)
