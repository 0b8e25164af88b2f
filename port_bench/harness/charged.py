"""Readings of a traced training window from the device operations that
``harness/attribution.py`` charges to the program's spans: a run whose
``trace`` is an ``AttributedTrace`` (the drivers that record the program's
spans build one); any other run reads ``None``, as does a program that
records no such span."""
from __future__ import annotations

from harness.attribution import AttributedTrace
from harness.trace import union_length


def _traced(run):
    return (getattr(run, "kind", None) == "train" and isinstance(run.trace, AttributedTrace)
            and run.trace.count("step") > 0)


def charged_s(trace, match) -> float:
    """The union of the intervals, inside the window, of the operations
    charged to a span whose name ``match`` accepts."""
    return union_length([(s, e) for n, s, e in trace.charged if n is not None and match(n)],
                        trace.lo, trace.hi)


def charged_ms(run, match):
    """``charged_s`` a window step, in ms; None where nothing is charged."""
    if not _traced(run):
        return None
    busy = charged_s(run.trace, match)
    return 1e3 * busy / run.trace.count("step") if busy > 0 else None


def window_spans(trace, name):
    """The program's spans ``name`` that lie inside the window."""
    lo, hi = trace.lo * 1e9, trace.hi * 1e9
    return [p for p in trace.program if p.name == name and lo <= p.start and p.end <= hi]
