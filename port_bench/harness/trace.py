"""What a ``--trace 1`` run reads: the device's operations as intervals from
``torch.profiler`` (CUDA activity only: recording every host operation as
well doubles the serving path's host time), and the benchmark's own spans,
which ``span()`` records on the host clock that the profiler's timestamps
share (nanoseconds since the epoch).

Busy time is the length of the union of the device intervals, never their
sum: a programmatic dependent launched early overlaps its primary, and a
sum would count that time twice.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

SPAN = "port_bench:"


class Spans:
    """The benchmark's own spans around its calls into the program: (name,
    start, end) in seconds since the epoch, kept only when ``on``."""

    def __init__(self, on: bool):
        self.on, self.kept = on, []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.kept.append((name, t0 * 1e-9, time.time_ns() * 1e-9))


def union_length(intervals, lo=None, hi=None) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """Seconds throughout. ``device``: [(name, start, end)] of every device
    operation; ``spans``: {name: [(start, end)]} of the benchmark's spans;
    ``host``: [(start, end, name)] of the host operations, by start."""

    def __init__(self, device, spans, host):
        self.device = device
        self.spans = spans
        self.host = sorted(host)
        self._host_starts = [h[0] for h in self.host]
        w = spans.get("window", [])
        self.lo, self.hi = (w[0][0], w[-1][1]) if w else (None, None)

    @classmethod
    def from_profiler(cls, prof, kept):
        """From the profiler's events and the kept spans."""
        device, spans, host = [], defaultdict(list), []
        for name, s, t in kept:
            spans[name].append((s, t))
        for e in prof.profiler.kineto_results.events():
            s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            name = e.name()
            if name.startswith(SPAN):
                # a span is recorded on the host and, as an annotation, on
                # the device: only the host's record is a span, and the
                # annotation is no device operation
                if not str(e.device_type()).endswith("CUDA"):
                    spans[name[len(SPAN):]].append((s, t))
            elif str(e.device_type()).endswith("CUDA"):
                device.append((name, s, t))
            else:
                host.append((s, t, name))
        for v in spans.values():
            v.sort()
        return cls(device, dict(spans), host)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self, match=None) -> float:
        """Union of the device operations (those ``match(name)`` accepts)
        inside the window."""
        return union_length([(s, e) for n, s, e in self.device
                             if match is None or match(n)], self.lo, self.hi)

    def count(self, span: str) -> int:
        return len(self.spans.get(span, []))

    def device_ops(self, top=10):
        """[[name, seconds]]: the device operations that took most time."""
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n] += min(e, self.hi) - max(s, self.lo) if e > self.lo and s < self.hi else 0.0
        return [[n[:160], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t):
        """The innermost host operation the trace holds at time t (the CUDA
        runtime's calls, where the profiler records them), by its name."""
        i = bisect.bisect_right(self._host_starts, t)
        best = None
        for j in range(i - 1, max(i - 200, -1), -1):
            s, e, n = self.host[j]
            if e >= t and (best is None or s >= best[0]):
                best = (s, n)
                break
        return best[1] if best else "no host operation"

    def _span_at(self, t):
        """The innermost of the benchmark's spans open at time t."""
        best = None
        for name, ivs in self.spans.items():
            if name == "window":
                continue
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1] and (best is None or ivs[i][0] > best[0]):
                best = (ivs[i][0], name)
        return best[1] if best else "between spans"

    def idle_gaps(self, top=10):
        """[[what the host was doing, seconds]]: the idle stretches of the
        window, summed by the benchmark's span and the host operation that
        ran at each one's middle."""
        by = defaultdict(float)
        for a, b in gaps([(s, e) for _, s, e in self.device], self.lo, self.hi):
            mid = 0.5 * (a + b)
            by[f"{self._span_at(mid)} / {self._host_at(mid)[:100]}"] += b - a
        return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def breakdown(self):
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}
