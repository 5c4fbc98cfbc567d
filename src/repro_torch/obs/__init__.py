"""Observability for the serve/query stack: metrics, spans, kernel rings.

The port's copy of ``repro.obs``: plain Python, no torch and no JAX.

One :class:`Observability` bundle travels with a scheduler/engine pair:

* ``metrics`` — a :class:`~repro_torch.obs.metrics.MetricsRegistry` (always
  on by default; counter cost matches the old ``stats`` dict it
  replaced),
* ``tracer`` — a :class:`~repro_torch.obs.trace.Tracer` (off by default;
  enable with ``Observability(tracing=True)`` or ``obs.tracer.enabled
  = True``),
* ``profiler`` — the module-wide
  :data:`~repro_torch.obs.profile.kernel_profiler` (off by default; scope it
  on with ``obs.profile_kernels()``).

The scheduler binds its clock seam into the tracer (``bind_clock``), so
``VirtualClock`` replays produce deterministic traces, and exports go
through :mod:`repro_torch.obs.export` (Perfetto JSON + text metrics).
"""
from __future__ import annotations

from .export import (
    metrics_text,
    spans_to_trace_events,
    write_metrics,
    write_trace,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_INSTRUMENT,
    format_metric,
    merge_snapshots,
    quantile_from_snapshot,
)
from .profile import KernelProfiler, LaunchRecord, kernel_profiler
from .trace import NULL_SPAN, Span, Tracer


class Observability:
    """Metrics + tracer + kernel profiler, bundled per serve component."""

    def __init__(self, metrics=None, tracer=None, *, tracing=False,
                 profiler=None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=tracing)
        self.profiler = profiler if profiler is not None else kernel_profiler

    def bind_clock(self, clock) -> None:
        """Point the tracer at a component's clock seam (first bind wins)."""
        if self.tracer.clock is None:
            self.tracer.clock = clock

    def profile_kernels(self):
        """Context manager: kernel-launch rings on, feeding ``metrics``."""
        return self.profiler.enabled_scope(metrics=self.metrics)

    def snapshot(self) -> dict:
        return self.metrics.snapshot()


__all__ = [
    "Observability",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "NULL_INSTRUMENT",
    "format_metric",
    "merge_snapshots",
    "quantile_from_snapshot",
    "Tracer",
    "Span",
    "NULL_SPAN",
    "KernelProfiler",
    "LaunchRecord",
    "kernel_profiler",
    "spans_to_trace_events",
    "write_trace",
    "metrics_text",
    "write_metrics",
]
