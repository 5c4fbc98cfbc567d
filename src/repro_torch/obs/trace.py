"""Structured request spans for the serve/query stack.

A :class:`Span` is a named ``[start_s, end_s)`` interval with a parent
link and free-form attrs.  The :class:`Tracer` hands out span ids,
timestamps them from a pluggable monotonic clock (the scheduler binds
its own ``VirtualClock``/``MonotonicClock`` seam, so deterministic
replays produce bit-identical traces), and keeps finished + open spans
in one append-only list for export.

Two usage shapes:

* **Long-lived spans** (a request's ``request``/``queue`` spans live
  across many scheduler steps): ``start()`` / ``end()`` with an explicit
  ``parent``.  These do *not* touch the implicit current-span stack.
* **Scoped spans** (``batch_form``, ``launch``, engine-level spans):
  ``with tracer.span("launch", parent=step_span):``.  Scoped spans push
  themselves as the *current* span, so nested instrumentation deeper in
  the stack (``trie_engine``, ``resilience``) parents correctly without
  threading span objects through every signature.

Disabled tracers return the shared :data:`NULL_SPAN`; every operation
on it is a no-op, so the instrumented hot path pays one attribute check
when tracing is off.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Span:
    name: str
    span_id: int
    parent_id: int  # -1 for roots
    start_s: float
    end_s: Optional[float] = None  # None while open
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return (self.end_s - self.start_s) if self.end_s is not None else 0.0


class _NullSpan:
    """Shared stand-in when tracing is disabled — absorbs everything."""

    __slots__ = ()
    name = ""
    span_id = -1
    parent_id = -1
    start_s = 0.0
    end_s = 0.0
    duration_s = 0.0

    @property
    def attrs(self) -> dict:
        return {}  # fresh throwaway; writes vanish by design


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + sink.  Single-threaded by design (the serve loop
    is an event loop); ``spans`` is the export surface."""

    def __init__(self, enabled: bool = False, clock=None,
                 capacity: int = 1_000_000):
        self.enabled = enabled
        self.clock = clock  # needs .now() -> seconds; None = monotonic
        self.capacity = capacity
        self.spans: List[Span] = []
        self.dropped = 0
        self._next_id = 0
        self._stack: List[Span] = []  # scoped spans only

    # -- time -----------------------------------------------------------
    def now(self) -> float:
        return self.clock.now() if self.clock is not None else time.monotonic()

    # -- span lifecycle -------------------------------------------------
    def start(self, name: str, parent=None, **attrs):
        """Open a span.  ``parent`` may be a Span, ``None`` (inherit the
        current scoped span, or root if none), or ``False`` (force root)."""
        if not self.enabled:
            return NULL_SPAN
        if len(self.spans) >= self.capacity:
            self.dropped += 1
            return NULL_SPAN
        if parent is None:
            parent = self._stack[-1] if self._stack else None
        pid = parent.span_id if parent else -1
        sp = Span(name, self._next_id, pid, self.now(), None, attrs)
        self._next_id += 1
        self.spans.append(sp)
        return sp

    def end(self, span, **attrs) -> None:
        if span is None or span is NULL_SPAN:
            return
        if attrs:
            span.attrs.update(attrs)
        if span.end_s is None:
            span.end_s = self.now()

    def annotate(self, span, **attrs) -> None:
        if span is not None and span is not NULL_SPAN:
            span.attrs.update(attrs)

    @contextmanager
    def span(self, name: str, parent=None, **attrs):
        """Scoped span: pushed as the implicit current parent."""
        sp = self.start(name, parent=parent, **attrs)
        if sp is NULL_SPAN:
            yield sp
            return
        self._stack.append(sp)
        try:
            yield sp
        except BaseException as exc:
            sp.attrs.setdefault("error", type(exc).__name__)
            raise
        finally:
            self._stack.pop()
            self.end(sp)

    # -- export helpers -------------------------------------------------
    def finished(self) -> List[Span]:
        return [s for s in self.spans if s.end_s is not None]

    def clear(self) -> None:
        self.spans.clear()
        self._stack.clear()
        self.dropped = 0
