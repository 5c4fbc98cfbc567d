"""Process-local metrics: counters, gauges, log-scale latency histograms.

The serve stack needs exact-ish p50/p99 over request latencies without
keeping every sample, per-tenant/per-op breakdowns without a metric
explosion, and snapshots that merge across schedulers (or across bench
replays) — all with hot-path cost comparable to the ad-hoc ``stats``
dict this module replaces (a dict lookup + an int add).

Design:

* Instruments are identified by ``(name, sorted(labels))``.  The
  registry get-or-creates on first touch and hands back the *instrument
  object*; callers that care about the hot path hold the instrument and
  call ``inc()`` directly instead of re-resolving labels per event.
* ``Histogram`` uses fixed geometric buckets (``lo * growth**i``) so two
  histograms with the same binning merge by adding count vectors.
  Quantiles interpolate geometrically inside the owning bucket and are
  clamped to the tracked ``[min, max]``, so the relative error of
  ``quantile(q)`` vs. an exact oracle is bounded by one bucket's growth
  factor (default ``2**0.25 ~ 1.19``) — tested against
  ``numpy.percentile`` in ``tests/test_obs.py``.
* A disabled registry hands out shared no-op instruments, so
  ``registry.counter("x").inc()`` costs two attribute lookups and
  nothing else.

Snapshots are plain JSON-able dicts (see ``snapshot`` / federated
``merge_snapshots``), rendered to text by ``repro_torch.obs.export``.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[dict]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def format_metric(name: str, key: LabelKey) -> str:
    """``name{k="v",...}`` — the stable text form used in snapshots."""
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter.  ``inc`` is the whole hot-path API."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (queue depth, cache size)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, v: float) -> None:
        self.value += float(v)


class Histogram:
    """Fixed-bucket geometric histogram with quantile queries.

    Bucket ``0`` is the underflow bucket ``[0, lo)``; bucket ``i >= 1``
    covers ``[lo * growth**(i-1), lo * growth**i)``; the last bucket
    absorbs overflow.  Defaults cover 1e-3..1e7 (µs..hours when values
    are milliseconds) at ~19% relative resolution in 135 buckets.
    """

    __slots__ = ("name", "labels", "lo", "growth", "n_buckets", "counts",
                 "count", "total", "min", "max", "_log_g", "_log_lo")

    def __init__(
        self,
        name: str,
        labels: LabelKey = (),
        *,
        lo: float = 1e-3,
        hi: float = 1e7,
        growth: float = 2 ** 0.25,
    ):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError("need lo > 0, hi > lo, growth > 1")
        self.name = name
        self.labels = labels
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_g = math.log(growth)
        self._log_lo = math.log(lo)
        # +1 for the underflow bucket, +1 so hi itself still lands inside
        self.n_buckets = int(math.ceil(math.log(hi / lo) / self._log_g)) + 2
        self.counts = [0] * self.n_buckets
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording ------------------------------------------------------
    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        i = int((math.log(v) - self._log_lo) / self._log_g) + 1
        return min(i, self.n_buckets - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        if v < 0 or v != v:  # negative or NaN: count nothing, stay exact
            return
        self.counts[self._index(v)] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    # -- queries --------------------------------------------------------
    def _edges(self, i: int) -> Tuple[float, float]:
        if i == 0:
            return 0.0, self.lo
        return (self.lo * self.growth ** (i - 1), self.lo * self.growth ** i)

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 1] (geometric interpolation)."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            cum += c
            if cum >= target:
                lo_e, hi_e = self._edges(i)
                frac = (target - (cum - c)) / c
                if lo_e <= 0.0:  # underflow bucket: linear interp
                    est = hi_e * frac
                else:
                    est = lo_e * (hi_e / lo_e) ** frac
                return min(max(est, self.min), self.max)
        return self.max  # pragma: no cover - cum always reaches count

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    # -- snapshots ------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "lo": self.lo,
            "growth": self.growth,
            "n_buckets": self.n_buckets,
            "counts": {str(i): c for i, c in enumerate(self.counts) if c},
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }

    def merge_snapshot(self, snap: dict) -> None:
        """Fold a ``snapshot()`` dict (same binning) into this histogram."""
        if (snap["lo"], snap["growth"], snap["n_buckets"]) != (
            self.lo, self.growth, self.n_buckets
        ):
            raise ValueError("histogram binning mismatch; cannot merge")
        for i, c in snap["counts"].items():
            self.counts[int(i)] += c
        self.count += snap["count"]
        self.total += snap["sum"]
        if snap["min"] is not None:
            self.min = min(self.min, snap["min"])
        if snap["max"] is not None:
            self.max = max(self.max, snap["max"])


class _NullInstrument:
    """Shared sink for disabled registries: every method is a no-op."""

    __slots__ = ()
    name = ""
    labels: LabelKey = ()
    value = 0
    count = 0
    total = 0.0
    mean = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0


NULL_INSTRUMENT = _NullInstrument()


class MetricsRegistry:
    """Get-or-create home for every instrument in one process/component.

    ``enabled=False`` turns the registry into a sink: all factories
    return the shared :data:`NULL_INSTRUMENT` and nothing is recorded.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}

    # -- factories (get-or-create) --------------------------------------
    def counter(self, name: str, labels: Optional[dict] = None, **kw):
        if not self.enabled:
            return NULL_INSTRUMENT
        key = (name, _label_key({**(labels or {}), **kw}))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter(*key)
        return c

    def gauge(self, name: str, labels: Optional[dict] = None, **kw):
        if not self.enabled:
            return NULL_INSTRUMENT
        key = (name, _label_key({**(labels or {}), **kw}))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge(*key)
        return g

    def histogram(
        self, name: str, labels: Optional[dict] = None, *, hist_kw=None, **kw
    ):
        if not self.enabled:
            return NULL_INSTRUMENT
        key = (name, _label_key({**(labels or {}), **kw}))
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(*key, **(hist_kw or {}))
        return h

    # -- queries --------------------------------------------------------
    def value(self, name: str, labels: Optional[dict] = None, **kw) -> float:
        """Counter/gauge value (0 if the instrument was never touched)."""
        key = (name, _label_key({**(labels or {}), **kw}))
        inst = self._counters.get(key) or self._gauges.get(key)
        return inst.value if inst is not None else 0

    def counters_named(self, name: str) -> List[Counter]:
        return [c for (n, _), c in self._counters.items() if n == name]

    def histograms_named(self, name: str) -> List[Histogram]:
        return [h for (n, _), h in self._histograms.items() if n == name]

    def label_values(self, name: str, label: str) -> List[str]:
        """Distinct values of ``label`` seen on instruments named ``name``."""
        out = set()
        for kind in (self._counters, self._gauges, self._histograms):
            for (n, key) in kind:
                if n == name:
                    out.update(v for k, v in key if k == label)
        return sorted(out)

    # -- snapshots ------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able point-in-time view, keyed by the stable text form."""
        return {
            "counters": {
                format_metric(n, k): c.value
                for (n, k), c in sorted(self._counters.items())
            },
            "gauges": {
                format_metric(n, k): g.value
                for (n, k), g in sorted(self._gauges.items())
            },
            "histograms": {
                format_metric(n, k): h.snapshot()
                for (n, k), h in sorted(self._histograms.items())
            },
        }


def merge_snapshots(snaps: Iterable[dict]) -> dict:
    """Merge ``MetricsRegistry.snapshot()`` dicts: counters add, gauges
    last-write-wins, histograms add bucket vectors (same binning)."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0) + v
        out["gauges"].update(snap.get("gauges", {}))
        for k, h in snap.get("histograms", {}).items():
            if k not in out["histograms"]:
                out["histograms"][k] = {
                    **h, "counts": dict(h["counts"]),
                }
            else:
                acc = out["histograms"][k]
                if (acc["lo"], acc["growth"], acc["n_buckets"]) != (
                    h["lo"], h["growth"], h["n_buckets"]
                ):
                    raise ValueError(f"binning mismatch merging {k}")
                for i, c in h["counts"].items():
                    acc["counts"][i] = acc["counts"].get(i, 0) + c
                acc["count"] += h["count"]
                acc["sum"] += h["sum"]
                for f, pick in (("min", min), ("max", max)):
                    if h[f] is not None:
                        acc[f] = h[f] if acc[f] is None else pick(acc[f], h[f])
    return out


def quantile_from_snapshot(snap: dict, q: float) -> float:
    """Quantile query over a (possibly merged) histogram snapshot."""
    h = Histogram("_q", lo=snap["lo"], growth=snap["growth"],
                  hi=snap["lo"] * snap["growth"] ** (snap["n_buckets"] - 2))
    if h.n_buckets != snap["n_buckets"]:  # guard float edge in rebuild
        h.n_buckets = snap["n_buckets"]
        h.counts = [0] * h.n_buckets
    h.merge_snapshot(snap)
    return h.quantile(q)
