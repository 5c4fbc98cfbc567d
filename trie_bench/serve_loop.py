"""The closed loop that drives the program's serve loop, and the thin
timing wrapper around the engine it is given.

Every client sends its next query when its previous one is answered, as
analysts' dashboards and recommendation back ends do: the scheduler holds
at most ``clients`` requests.  The loop runs on the host's monotonic
clock: a request's time runs from just before ``submit`` to the return
of the ``step`` that answered it.  A client consumes its reply: the
loop pops it from ``TrieScheduler.responses``, where the scheduler leaves
every answer for its caller to collect.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from .loadgen import OPS, Traffic

ENGINE_OPS = {"rule_search_batch": "rule_search",
              "top_k_rules_batch": "top_k", "rules_with": "rules_with"}
# the result fields of each op's answer, as the scheduler returns them
FIELDS = (("found", "node", "support", "confidence", "lift"),
          ("values", "node"), ("values", "node"))


class Answers:
    """The answers that came back ``ok``, by op: their request ids and each
    result field as the numpy value the scheduler returned.  No Python
    container is kept per answer, so the collector has no more to scan as
    the window goes on.  A cache hit returns the very objects of the answer
    it repeats."""

    def __init__(self):
        self.ids = [[] for _ in OPS]
        self.fields = [{f: [] for f in names} for names in FIELDS]

    def add(self, o: int, rid: int, result: dict) -> None:
        self.ids[o].append(rid)
        for f, values in self.fields[o].items():
            values.append(result[f])

    def __len__(self) -> int:
        return sum(len(x) for x in self.ids)


class EngineWrapper:
    """The engine the scheduler is given, with each batched op passed
    through ``_call``; every other attribute is the engine's."""

    def __init__(self, engine):
        self.__dict__["_engine"] = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def __setattr__(self, name, value):
        setattr(self._engine, name, value)

    def _call(self, name, args, kwargs):
        return getattr(self._engine, name)(*args, **kwargs)

    def rule_search_batch(self, *args, **kwargs):
        return self._call("rule_search_batch", args, kwargs)

    def top_k_rules_batch(self, *args, **kwargs):
        return self._call("top_k_rules_batch", args, kwargs)

    def rules_with(self, *args, **kwargs):
        return self._call("rules_with", args, kwargs)


class TimedEngine(EngineWrapper):
    """Each batched op timed from its call to the end of the device work
    it queued (a synchronize at its end: the host copy that follows waits
    for that work anyway).  Records ``(op, t0_ns, t1_ns, first argument)``
    per call."""

    def __init__(self, engine, sync: Callable[[], None]):
        super().__init__(engine)
        self.__dict__["_sync"] = sync
        self.__dict__["calls"] = []

    def _call(self, name, args, kwargs):
        t0 = time.perf_counter_ns()
        out = super()._call(name, args, kwargs)
        self._sync()
        self.calls.append((ENGINE_OPS[name], t0, time.perf_counter_ns(),
                           args[0]))
        return out


@dataclass
class LoopResult:
    """What the loop saw: per request its op, query id and submit time;
    the answers that came back; the window's counts and times."""

    ops: List[int] = field(default_factory=list)
    qids: List[int] = field(default_factory=list)
    t_submit: List[float] = field(default_factory=list)
    answers: Answers = field(default_factory=Answers)
    not_ok: List[tuple] = field(default_factory=list)    # (id, status)
    window_s: float = 0.0
    window_done: int = 0
    latencies_ms: Optional[np.ndarray] = None
    counters: dict = field(default_factory=dict)
    steps: List[tuple] = field(default_factory=list)     # traced: (t0, t1)
    outstanding: int = 0
    longest_steps_ms: List[float] = field(default_factory=list)
    gc_s: float = 0.0          # the window's garbage collections
    gc_n: int = 0
    per_second: List[int] = field(default_factory=list)  # answered
    cpu_s: float = 0.0         # the loop thread's CPU time in the window


def run_loop(sched, traffic: Traffic, seconds: float,
             on_open: Callable[[], None], on_close: Callable[[], None],
             trace=None) -> LoopResult:
    """Warm up with ``traffic.warmup`` answers, call ``on_open``, serve for
    ``seconds``, call ``on_close``, then drain what is still in flight.

    With ``trace`` (a ``trace.DeviceTrace``), the device is traced over the
    window (started before it opens, stopped after it closes) and each
    step's host span is kept."""
    res = LoopResult()
    names = OPS
    kws = [traffic.kwargs[o] for o in OPS]
    nxt, payload = traffic.next, traffic.payload
    submit, step, pop = sched.submit, sched.step, sched.responses.pop
    ops, qids, t_sub = res.ops, res.qids, res.t_submit
    answers, not_ok = res.answers, res.not_ok
    now = time.perf_counter
    first_id = None

    def send():
        o, q = nxt()
        ops.append(o)
        qids.append(q)
        t_sub.append(now())
        return submit(names[o], payload(o, q), kws[o]).id

    def collect(done):
        for r in done:
            pop(r.id, None)
            if r.status == "ok":
                answers.add(ops[r.id], r.id, r.result)
            else:
                not_ok.append((r.id, r.status))

    first_id = send()
    if first_id != 0:
        raise RuntimeError("the scheduler must be fresh: ids start at 0")
    for _ in range(traffic.clients - 1):
        send()

    # warm-up: the same stream, until ``warmup`` answers came back
    got = 0
    while got < traffic.warmup:
        done = step()
        collect(done)
        got += len(done)
        for _ in done:
            send()

    tracing = trace is not None
    if tracing:
        trace.start()
    stats0 = dict(sched.stats)
    gc_t = []

    def on_gc(phase, info):
        gc_t.append(now())

    on_open()
    lat = []
    longest = []
    gc.callbacks.append(on_gc)
    cpu0 = time.thread_time()
    t0 = now()
    t_end = t0 + float(seconds)
    steps = res.steps
    per_s = [0] * (int(seconds) + 2)
    n_done = 0
    while True:
        ts = now()
        if ts >= t_end:
            break
        done = step()
        t = now()
        if tracing:
            steps.append((ts, t))
        longest.append(t - ts)
        collect(done)
        n_done += len(done)
        per_s[min(int(t - t0), len(per_s) - 1)] += len(done)
        for r in done:
            lat.append(t - t_sub[r.id])
            send()
    t_stop = now()
    res.cpu_s = time.thread_time() - cpu0
    gc.callbacks.remove(on_gc)
    on_close()
    res.gc_n = len(gc_t) // 2
    res.gc_s = sum(gc_t[1::2]) - sum(gc_t[0::2])
    res.longest_steps_ms = sorted((x * 1e3 for x in longest),
                                  reverse=True)[:3]
    if tracing:
        trace.stop()
    res.window_s = t_stop - t0
    res.window_done = n_done
    res.per_second = per_s[: int(seconds)]
    res.latencies_ms = np.asarray(lat, np.float64) * 1e3
    stats1 = dict(sched.stats)
    res.counters = {k: stats1[k] - stats0[k] for k in stats1}

    # drain: every request sent gets its answer checked
    for _ in range(100 * traffic.clients + 100):
        if not sched.pending:
            break
        collect(step())
    res.outstanding = sched.pending
    return res
