"""FLuID's calibration, plainly: each FFN hidden unit's norm-relative update
sqrt(sum (w1 - w0)^2) / (sqrt(sum w0^2) + 1e-8), summed over the unit's
column of w_in and w_gate and its row of w_out; 128-unit blocks scored by
their mean; the round(blocks * r) highest-scoring blocks of a layer kept."""
from __future__ import annotations

import torch

BLOCK = 128


def unit_stats(w0: dict, w1: dict):
    """(L, F) float64 statistics from the stacked FFN leaves before (w0) and
    after (w1): w_in, w_gate (L, d, F), w_out (L, F, d)."""
    num = den = 0.0
    for key, axis in (("w_in", 1), ("w_gate", 1), ("w_out", 2)):
        if key in w0:
            a, b = w0[key].double(), w1[key].double()
            num = num + (b - a).square().sum(axis)
            den = den + a.square().sum(axis)
    return num.sqrt() / (den.sqrt() + 1e-8)


def block_stats(stats):
    L, F = stats.shape
    return stats.reshape(L, F // BLOCK, BLOCK).mean(-1)


def kept_count(blocks: int, r: float) -> int:
    return max(1, int(round(blocks * r)))
