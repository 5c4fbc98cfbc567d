"""Exporters: Chrome/Perfetto ``trace_event`` JSON + plain-text metrics.

``spans_to_trace_events`` turns a tracer's span list into the Chrome
trace-event format that both ``chrome://tracing`` and
https://ui.perfetto.dev open directly: one ``ph: "X"`` (complete) event
per finished span, microsecond timestamps rebased to the earliest span,
chronologically ordered.  Spans are laid out on tracks (``tid``) by the
request that owns them — a span inherits the ``req`` attr from its
nearest annotated ancestor — so one Perfetto row shows a request's
``admit → queue → serve`` lifecycle while scheduler-step machinery
(``batch_form``, ``launch``, ``merge``) lives on the shared step track.

``metrics_text`` renders a ``MetricsRegistry`` (or a merged snapshot)
as one line per instrument — counters and gauges as ``name{labels} value``,
histograms with count/mean/p50/p99/max — greppable and diffable.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from .metrics import MetricsRegistry, quantile_from_snapshot
from .trace import Span

_STEP_TID = 1          # scheduler-step machinery track
_REQ_TRACKS = 61       # request spans spread over this many tracks


def _tid_for(span: Span, by_id: Dict[int, Span]) -> int:
    """Track id: nearest ancestor carrying a ``req`` attr wins."""
    cur: Optional[Span] = span
    seen = 0
    while cur is not None and seen < 64:
        req = cur.attrs.get("req")
        if req is not None:
            return 2 + int(req) % _REQ_TRACKS
        cur = by_id.get(cur.parent_id)
        seen += 1
    return _STEP_TID


def spans_to_trace_events(
    spans: Iterable[Span],
    *,
    pid: int = 1,
    process_name: str = "repro-serve",
) -> dict:
    """Chrome ``trace_event`` JSON object (``json.dump``-ready)."""
    finished = [s for s in spans if s.end_s is not None]
    by_id = {s.span_id: s for s in finished}
    origin = min((s.start_s for s in finished), default=0.0)
    events: List[dict] = []
    tids = set()
    for s in finished:
        tid = _tid_for(s, by_id)
        tids.add(tid)
        events.append({
            "ph": "X",
            "name": s.name,
            "cat": str(s.attrs.get("op", "serve")),
            "pid": pid,
            "tid": tid,
            "ts": round((s.start_s - origin) * 1e6, 3),
            "dur": round((s.end_s - s.start_s) * 1e6, 3),
            "args": {
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                **{k: _jsonable(v) for k, v in s.attrs.items()},
            },
        })
    events.sort(key=lambda e: (e["ts"], e["args"]["span_id"]))
    meta = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for tid in sorted(tids):
        label = ("scheduler steps" if tid == _STEP_TID
                 else f"requests %{_REQ_TRACKS} = {tid - 2}")
        meta.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": label},
        })
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def write_trace(path: str, spans: Iterable[Span], **kw) -> dict:
    doc = spans_to_trace_events(spans, **kw)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def metrics_text(source) -> str:
    """Plain-text dump of a ``MetricsRegistry`` or a ``snapshot()`` dict."""
    snap = source.snapshot() if isinstance(source, MetricsRegistry) else source
    lines: List[str] = []
    for k, v in snap.get("counters", {}).items():
        lines.append(f"{k} {v}")
    for k, v in snap.get("gauges", {}).items():
        lines.append(f"{k} {v:g}")
    for k, h in snap.get("histograms", {}).items():
        if not h["count"]:
            lines.append(f"{k} count=0")
            continue
        p50 = quantile_from_snapshot(h, 0.50)
        p99 = quantile_from_snapshot(h, 0.99)
        lines.append(
            f"{k} count={h['count']} mean={h['sum'] / h['count']:.4g} "
            f"p50={p50:.4g} p99={p99:.4g} "
            f"min={h['min']:.4g} max={h['max']:.4g}"
        )
    return "\n".join(lines) + "\n"


def write_metrics(path: str, source) -> str:
    text = metrics_text(source)
    with open(path, "w") as f:
        f.write(text)
    return text
