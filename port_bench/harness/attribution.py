"""The program's own spans (``repro_torch.tracing``) on the profiler's
timeline: each device operation charged to the innermost program span open
when the host launched it, and the readings that follow from that.

A kernel runs after its launch, often after the span that launched it has
closed (the host runs ahead of the card), and the backward's kernels are
launched from autograd's device thread. So an operation is charged by the
start of the host call that launched it (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ...), found through the CUPTI
correlation id the two share, and by time alone, never by thread. An
operation whose launch the trace does not hold is charged by its own start
and counted in ``unlinked``.

Request-scoped spans (``SCOPED``) overlap one another and are no layer of
the call stack: they are read for per-request times (``program``), and are
left out of ``spans``, so they never charge an operation or name an idle
gap.

``READERS`` holds a reader ``read(run)`` for each of the span metrics; a
``run`` here is a benchmark run whose ``trace`` is an ``AttributedTrace``.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

from harness.trace import Trace, gaps, union_length

SCOPED = ("serve.request", "serve.queued")


def timeline(spans):
    """(starts, names): from starts[i] to starts[i + 1] the innermost of
    the call-stack ``spans`` [(name, start, end)] is names[i] (None where
    none is open)."""
    marks = []
    for i, (name, s, e) in enumerate(spans):
        marks.append((s, 1, -e, i))
        marks.append((e, 0, 0, i))
    marks.sort()
    starts, names, stack = [], [], []
    for t, kind, _, i in marks:
        if kind:
            stack.append(i)
        else:
            stack.remove(i)
        name = spans[stack[-1]][0] if stack else None
        if starts and starts[-1] == t:
            names[-1] = name
        else:
            starts.append(t)
            names.append(name)
    return starts, names


def charge(ops, launches, spans):
    """[(span name or None, op start, op end)] for each device operation
    (name, start, end, correlation id), and the count of those whose launch
    ``launches`` {correlation id: launch start} lacks."""
    starts, names = timeline(spans)
    out, unlinked = [], 0
    for _, s, e, corr in ops:
        t = launches.get(corr)
        if t is None:
            unlinked += 1
            t = s
        i = bisect.bisect_right(starts, t) - 1
        out.append((names[i] if i >= 0 else None, s, e))
    return out, unlinked


class AttributedTrace(Trace):
    """A ``Trace`` that also holds the program's spans: whole in
    ``program`` (``tracing.Span``, nanoseconds), the call-stack ones by name
    in ``spans`` beside the benchmark's (seconds), and each device operation
    charged to one of those in ``charged``."""

    def __init__(self, device, spans, host, program, launches):
        by = defaultdict(list, {k: list(v) for k, v in spans.items()})
        stack = [(p.name, p.start * 1e-9, p.end * 1e-9) for p in program
                 if p.name not in SCOPED]
        for name, s, e in stack:
            by[name].append((s, e))
        for v in by.values():
            v.sort()
        super().__init__([(n, s, e) for n, s, e, _ in device], dict(by), host)
        self.program = program
        self.charged, self.unlinked = charge(device, launches, stack)

    @classmethod
    def from_profiler(cls, prof, kept, program):
        device, spans, host, launches = [], defaultdict(list), [], {}
        for name, s, t in kept:
            spans[name].append((s, t))
        for e in prof.profiler.kineto_results.events():
            s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            if str(e.device_type()).endswith("CUDA"):
                device.append((e.name(), s, t, e.correlation_id()))
            else:
                host.append((s, t, e.name()))
                corr = e.correlation_id()
                if corr and (corr not in launches or s < launches[corr]):
                    launches[corr] = s
        return cls(device, dict(spans), host, program, launches)

    def busy_by_span(self):
        """{program span or None: union of the intervals of the operations
        charged to it, inside the window}."""
        by = defaultdict(list)
        for name, s, e in self.charged:
            by[name].append((s, e))
        return {k: union_length(v, self.lo, self.hi) for k, v in by.items()}

    def idle_in(self, name):
        """Seconds inside the spans ``name`` (inside the window) that no
        device operation covers."""
        idle = gaps([(s, e) for _, s, e in self.device], self.lo, self.hi)
        ends = [b for _, b in idle]
        total = 0.0
        for lo, hi in self.spans.get(name, []):
            for a, b in idle[bisect.bisect_right(ends, lo):]:
                if a >= hi:
                    break
                total += min(b, hi) - max(a, lo)
        return total

    def span_seconds(self, name):
        """The summed length of the program's spans ``name``, from their
        nanoseconds (seconds since the epoch hold a float to ~0.2 us)."""
        return 1e-9 * sum(p.end - p.start for p in self.program if p.name == name)

    def requests(self):
        """{rid: {"queued", "request", "admit", "prefill": (start, end)}} of
        every request whose ``serve.request`` closed, seconds."""
        by_id = {p.id: p for p in self.program}
        out = defaultdict(dict)
        for p in self.program:
            if p.name in ("serve.request", "serve.queued", "serve.admit"):
                out[p.attrs["rid"]][p.name.split(".", 1)[1]] = (p.start * 1e-9,
                                                                 p.end * 1e-9)
            elif p.name == "serve.prefill" and p.parent in by_id:
                rid = by_id[p.parent].attrs["rid"]
                out[rid]["prefill"] = (p.start * 1e-9, p.end * 1e-9)
        return {r: v for r, v in out.items() if "request" in v}


def _phase_ms(phase):
    def read(run):
        if run.kind != "train" or not isinstance(run.trace, AttributedTrace):
            return None
        steps = run.trace.count("train.step")
        busy = run.trace.busy_by_span().get(phase, 0.0)
        return 1e3 * busy / steps if steps and busy > 0 else None
    return read


def _serve_ms(seconds):
    def read(run):
        if run.kind != "serve" or not isinstance(run.trace, AttributedTrace) \
                or not run.stats["decode_steps"]:
            return None
        v = seconds(run.trace)
        return 1e3 * v / run.stats["decode_steps"] if v > 0 else None
    return read


def queue_wait_ms(run):
    """Median ``serve.queued`` duration of the requests finished in the window."""
    if run.kind != "serve" or not isinstance(run.trace, AttributedTrace):
        return None
    waits = [v["queued"][1] - v["queued"][0] for v in run.trace.requests().values()
             if "queued" in v]
    return 1e3 * statistics.median(waits) if waits else None


READERS = {
    "forward_ms.train": _phase_ms("train.forward"),
    "backward_ms.train": _phase_ms("train.backward"),
    "optimizer_ms.train": _phase_ms("train.optimizer"),
    "decode_issue_ms": _serve_ms(lambda tr: tr.span_seconds("serve.chunk_issue")),
    "decode_idle_ms": _serve_ms(lambda tr: tr.idle_in("serve.decode_chunk")),
    "queue_wait_ms.serve": queue_wait_ms,
}
