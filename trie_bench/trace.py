"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
only (host ops are not recorded, so the host pays little for the trace),
and the reading of its timeline.

The device's clock and the host's are tied by two markers: the trace
starts and ends with one tiny kernel launched on an idle device right
after a host timestamp, so each marker's device start sits a launch
latency (microseconds) after its host time.  Host spans (the loop's steps
and the engine's calls, on ``time.perf_counter``) map onto the device
timeline through the line through the two markers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class DeviceEvents:
    """The device events of the traced window, on the host's clock (ns)."""

    names: List[str]
    start: np.ndarray          # int64 ns, host clock
    end: np.ndarray
    window: Tuple[int, int]    # the two markers' starts, host clock
    drift_ns: float            # the markers' disagreement on the offset

    def busy_intervals(self) -> np.ndarray:
        """``[m, 2]``: the union of the events' intervals in the window."""
        lo, hi = self.window
        s = np.clip(self.start, lo, hi)
        e = np.clip(self.end, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        if s.size == 0:
            return np.zeros((0, 2), np.int64)
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.ones(s.shape[0], bool)
        new[1:] = s[1:] > e[:-1]
        idx = np.nonzero(new)[0]
        ends = np.append(idx[1:], s.shape[0]) - 1
        return np.stack([s[idx], e[ends]], axis=1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def by_name(self) -> Dict[str, float]:
        """Seconds on the device by event name."""
        out: Dict[str, float] = {}
        for n, s, e in zip(self.names, self.start.tolist(),
                           self.end.tolist()):
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def seconds_within(self, spans: Sequence[Tuple[int, int]],
                       kernels: Sequence[str]) -> np.ndarray:
        """Per span, the device seconds of the events whose name holds one
        of ``kernels`` and that start inside the span."""
        sel = np.array([any(k in n for k in kernels) for n in self.names],
                       bool)
        s, e = self.start[sel], self.end[sel]
        order = np.argsort(s)
        s, e = s[order], e[order]
        cum = np.concatenate([[0], np.cumsum(e - s)])
        out = np.zeros(len(spans))
        for i, (a, b) in enumerate(spans):
            i0, i1 = np.searchsorted(s, [a, b])
            out[i] = (cum[i1] - cum[i0]) / 1e9
        return out


class DeviceTrace:
    """Start and stop a CUDA-only profiler around a window."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.mark = torch.zeros(1, device=device)
        self.prof = None
        self.h = []

    def _marker(self):
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.h.append(time.perf_counter_ns())
        self.mark.add_(1.0)
        torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._marker()

    def stop(self):
        self._marker()
        self.prof.__exit__(None, None, None)

    def events(self) -> DeviceEvents:
        """The window's device events mapped to the host clock; raises when
        the trace holds none."""
        from torch.autograd import DeviceType

        raw = [(e.name(), e.start_ns(), e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        if len(raw) < 2:
            raise RuntimeError(
                f"the device trace holds {len(raw)} device events")
        raw.sort(key=lambda x: x[1])
        d0, d1 = raw[0][1], raw[-1][1]       # the two markers
        h0, h1 = self.h[0], self.h[-1]
        off0, off1 = d0 - h0, d1 - h1
        body = raw[1:-1]
        ds = np.array([x[1] for x in body], np.int64)
        du = np.array([x[2] for x in body], np.int64)
        # host = device - offset, the offset interpolated between markers
        frac = (ds - d0) / max(d1 - d0, 1)
        hs = (ds - (off0 + frac * (off1 - off0))).astype(np.int64)
        return DeviceEvents(
            names=[x[0] for x in body], start=hs, end=hs + du,
            window=(int(h0), int(h1)), drift_ns=float(off1 - off0),
        )


def short_name(name: str, width: int = 96) -> str:
    """A device event's name without its return type and arguments."""
    n = name[5:] if name.startswith("void ") else name
    cut = n.find("(")
    if cut > 0:
        n = n[:cut]
    return n[:width]


def breakdown(ev: DeviceEvents, host_spans: Sequence[Tuple[str, int, int]],
              top: int = 10) -> dict:
    """The device ops that took most time, and the longest idle gaps named
    by the innermost host span around each gap's middle."""
    agg: Dict[str, float] = {}
    for n, s in ev.by_name().items():
        k = short_name(n)
        agg[k] = agg.get(k, 0.0) + s
    ops = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    iv = ev.busy_intervals()
    lo, hi = ev.window
    starts = np.concatenate([[lo], iv[:, 1]])
    ends = np.concatenate([iv[:, 0], [hi]])
    gaps = ends - starts
    order = np.argsort(-gaps)[:top]
    spans = sorted(host_spans, key=lambda x: (x[1], -x[2]))
    out_gaps = []
    for g in order:
        if gaps[g] <= 0:
            continue
        mid = (starts[g] + ends[g]) // 2
        inner = "client"
        width = None
        for name, a, b in spans:
            if a <= mid < b and (width is None or b - a < width):
                inner, width = name, b - a
        out_gaps.append([inner, float(gaps[g]) / 1e9])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": out_gaps}
