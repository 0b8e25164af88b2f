"""Sub-model sizing shared by the dropout policies and the serving masks.

Only ``keep_count`` is ported so far; the policy registry comes with the
FL training slice.
"""
from __future__ import annotations


def keep_count(size: int, r: float, minimum: int = 1) -> int:
    return max(minimum, int(round(size * r)))
