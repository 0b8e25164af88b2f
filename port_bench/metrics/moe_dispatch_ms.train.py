"""Device time a window step charged to ``moe.route``, ``moe.dispatch`` and
``moe.combine`` (the router, the sort into capacity buckets and the
weighted combine), forward and remat recompute passes."""
from harness.charged import charged_ms

SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    return charged_ms(run, lambda name: name in SPANS)
