"""The numbers ``correct`` compares, and their limits.

Norm gaps are taken by the worst leaf: the gap between the program's norm
of a leaf and the reference's, against the reference's norm of that leaf or
of the median leaf, whichever is larger, since some gradients are all but
zero."""
from __future__ import annotations

import json
import statistics
from pathlib import Path

LIMITS = Path(__file__).resolve().parents[1] / "limits"


def worst_norm_gap(prog: dict, ref: dict, keys=None):
    """(gap, leaf) over the leaves in ``keys`` (default all of ref)."""
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in ref)
    worst, at = 0.0, None
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def limits(workload: str) -> dict:
    """{number: limit} of a cell, from ``limits/<workload>.json``."""
    return {k: v["limit"] for k, v in
            json.loads((LIMITS / f"{workload}.json").read_text())["numbers"].items()}


def judge(numbers: dict, lim: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and a number that is not finite fails."""
    rows, ok = [], True
    for name, limit in lim.items():
        v = numbers.get(name)
        good = v is not None and v == v and abs(v) != float("inf") and v <= limit
        ok &= good
        rows.append((name, v, limit))
    return ok, rows
