"""Kernel-launch profiling: one timing ring per op.

``repro_torch.kernels.ops`` calls :func:`KernelProfiler.record` around its
kernel dispatches (behind a single ``enabled`` check — disabled cost is
one attribute read) with the launch geometry that actually matters for
perf triage: launch rows, block shape, pad factor (padded/live rows),
and shard count, plus host wall time with the op's device synchronized
(``torch.cuda.synchronize``) before the clock stops, so the timing is
honest under CUDA's asynchronous launches.

Each op keeps a fixed-capacity ring of :class:`LaunchRecord`; records
additionally fan out to

* an optional :class:`~repro_torch.obs.metrics.MetricsRegistry`
  (``kernel.launch_ms{op=...}`` histograms + ``kernel.launches`` counters),
* registered observers — the scheduler registers one that feeds
  ``LaunchPredictor.observe(("kernel", op), rows, seconds)`` so measured
  kernel time becomes a queryable prediction bucket alongside the
  service-time buckets the deadline shaper uses.

The module-level :data:`kernel_profiler` singleton is what ``ops.py``
consults; ``enabled_scope`` scopes activation (benches, tests) without
leaking global state.
"""
from __future__ import annotations

import weakref
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class LaunchRecord:
    op: str
    rows: int                # launch batch rows (post-pad)
    shape: Tuple[int, ...]   # launch block shape
    pad_factor: float        # rows / live rows (>= 1.0)
    n_shards: int
    seconds: float           # host wall time, device synchronized


class KernelProfiler:
    """Per-op timing rings + observer fan-out.  Off by default."""

    def __init__(self, capacity: int = 256):
        self.enabled = False
        self.capacity = capacity
        self.metrics = None  # Optional[MetricsRegistry]
        self._rings: Dict[str, Deque[LaunchRecord]] = {}
        self._observers: List[weakref.ref] = []

    # -- lifecycle ------------------------------------------------------
    def enable(self, metrics=None) -> None:
        self.enabled = True
        if metrics is not None:
            self.metrics = metrics

    def disable(self) -> None:
        self.enabled = False
        self.metrics = None

    @contextmanager
    def enabled_scope(self, metrics=None):
        prev_enabled, prev_metrics = self.enabled, self.metrics
        self.enable(metrics=metrics)
        try:
            yield self
        finally:
            self.enabled, self.metrics = prev_enabled, prev_metrics

    def clear(self) -> None:
        self._rings.clear()

    # -- observers (weakly held so schedulers don't leak) ---------------
    def add_observer(self, fn: Callable[[LaunchRecord], None]) -> None:
        ref = (weakref.WeakMethod(fn) if hasattr(fn, "__self__")
               else weakref.ref(fn))
        self._observers.append(ref)

    def _notify(self, rec: LaunchRecord) -> None:
        live = []
        for ref in self._observers:
            fn = ref()
            if fn is None:
                continue  # observer owner died; prune
            live.append(ref)
            fn(rec)
        self._observers = live

    # -- recording ------------------------------------------------------
    def record(
        self,
        op: str,
        *,
        rows: int,
        shape: Tuple[int, ...],
        seconds: float,
        pad_factor: float = 1.0,
        n_shards: int = 1,
    ) -> None:
        rec = LaunchRecord(op, int(rows), tuple(int(s) for s in shape),
                           float(pad_factor), int(n_shards), float(seconds))
        ring = self._rings.get(op)
        if ring is None:
            ring = self._rings[op] = deque(maxlen=self.capacity)
        ring.append(rec)
        m = self.metrics
        if m is not None:
            m.counter("kernel.launches", op=op).inc()
            m.histogram("kernel.launch_ms", op=op).observe(rec.seconds * 1e3)
            m.histogram("kernel.pad_factor", op=op).observe(rec.pad_factor)
        self._notify(rec)

    # -- queries --------------------------------------------------------
    def ring(self, op: str) -> List[LaunchRecord]:
        return list(self._rings.get(op, ()))

    def ops(self) -> List[str]:
        return sorted(self._rings)


kernel_profiler = KernelProfiler()
