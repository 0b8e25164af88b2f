"""Straggler detection + sub-model sizing from profiled client latencies.

A numpy copy of ``repro/core/straggler.py`` (same decisions for the same
latencies, tests/test_torch_fl.py), with the async backend's arrival
model (``ArrivalModel``, tests/test_torch_async.py).

The paper's rule (§5):
  * T_target = the next-slowest (non-straggler) client's end-to-end time;
  * Speedup_i = T_straggler_i / T_target;
  * r_i = the predefined sub-model size closest to 1/Speedup_i (training
    time is linear in sub-model size — paper App. A.3).
Recalibration happens every calibration step, so the straggler cohort can
change at runtime (paper Fig. 4b).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

DEFAULT_SIZES = (0.5, 0.65, 0.75, 0.85, 0.95, 1.0)


@dataclass
class StragglerPlan:
    stragglers: List[int]
    t_target: float
    speedups: Dict[int, float]
    rates: Dict[int, float]         # r_i per straggler


def detect_stragglers(latencies: Dict[int, float],
                      frac: Optional[float] = None,
                      gap_factor: float = 1.10) -> List[int]:
    """If frac given: slowest round(frac*C) clients (at least one for any
    frac > 0; frac == 0.0 selects nobody — it used to flag one client
    anyway through an unconditional max(1, ...), which made "dropout off"
    configs silently run dropout). frac outside [0, 1] is a ValueError
    rather than a silent over-selection. Else: the slow *band* — everyone
    above the largest adjacent gap in the sorted latencies, provided that
    gap exceeds gap_factor. The split must tolerate ties: population
    cohorts hold many stragglers at the *same* slow speed, so a walk that
    stops at the first non-gapped adjacent pair would never see past the
    tied band (it did, before the population layer)."""
    ids = sorted(latencies, key=lambda c: latencies[c], reverse=True)
    if frac is not None:
        if not 0.0 <= frac <= 1.0:
            raise ValueError(f"frac must be in [0, 1], got {frac}")
        if frac == 0.0:
            return []
        k = max(1, int(round(frac * len(ids))))
        return ids[:k]
    if len(ids) < 2:
        return []
    ratios = [latencies[ids[i]] / max(latencies[ids[i + 1]], 1e-12)
              for i in range(len(ids) - 1)]
    g = max(range(len(ratios)), key=ratios.__getitem__)
    return ids[:g + 1] if ratios[g] > gap_factor else []


def detect_band(latencies: Dict[int, float],
                gap_factor: float = 1.10) -> List[int]:
    """Population-robust straggler band split (the store-backed path).

    Adjacent-gap detection is noise-dominated at population cohort sizes:
    with ~3% multiplicative sim-time noise, the extreme order statistics
    of a 1.3x-slow band and the fast cluster touch once a cohort has
    thousands of draws, so no adjacent pair ever shows a 1.10 ratio. The
    bimodal *structure* survives any cohort size. Two candidate cuts over
    the sorted latencies, each accepted only if the two groups' medians
    are more than gap_factor apart (a unimodal cluster splits into halves
    ~1.08x apart at this repo's noise levels, under the 1.10 bar):

      1. the 1-D two-means (Otsu) cut — minimizes within-group variance;
         finds a slow *band* of any size, but prefers halving a wide
         cluster over isolating one outlier (absolute-SS objective);
      2. fallback: the largest-adjacent-difference cut — isolates a lone
         straggler cleanly, but at thousands of draws the biggest spacing
         sits in the extreme tail, not the inter-mode dip.

    Clients above an accepted cut still pass an individual latency >
    gap_factor * median(fast side) test, so a stray fast draw inside the
    dip is not penalized. Slowest-first, like detect_stragglers."""
    if len(latencies) < 3:
        return detect_stragglers(latencies, gap_factor=gap_factor)
    ids = sorted(latencies, key=latencies.__getitem__)
    x = np.asarray([latencies[c] for c in ids], np.float64)
    n = x.size

    def accept(cut):
        ref = float(np.median(x[:cut]))
        if not float(np.median(x[cut:])) > gap_factor * ref:
            return None
        return [c for c in reversed(ids[cut:])
                if latencies[c] > gap_factor * ref] or None

    cs, css = np.cumsum(x), np.cumsum(x * x)
    k = np.arange(1, n)
    s0, ss0 = cs[:-1], css[:-1]
    s1, ss1 = cs[-1] - s0, css[-1] - ss0
    within = (ss0 - s0 * s0 / k) + (ss1 - s1 * s1 / (n - k))
    band = accept(int(np.argmin(within)) + 1)
    if band is None:
        band = accept(int(np.argmax(np.diff(x))) + 1)
    return band or []


def pick_rate(speedup: float, sizes: Sequence[float] = DEFAULT_SIZES) -> float:
    """Predefined size closest to 1/speedup (never the full model)."""
    want = 1.0 / max(speedup, 1.0)
    cand = [s for s in sizes if s < 1.0]
    return min(cand, key=lambda s: abs(s - want))


def plan(latencies: Dict[int, float], frac: Optional[float] = None,
         sizes: Sequence[float] = DEFAULT_SIZES,
         gap_factor: float = 1.10) -> StragglerPlan:
    stragglers = detect_stragglers(latencies, frac=frac,
                                   gap_factor=gap_factor)
    return _plan_with(latencies, stragglers, sizes)


def _plan_with(latencies: Dict[int, float], stragglers: List[int],
               sizes: Sequence[float]) -> StragglerPlan:
    non = [c for c in latencies if c not in stragglers]
    if not stragglers or not non:
        return StragglerPlan([], max(latencies.values(), default=0.0), {}, {})
    t_target = max(latencies[c] for c in non)   # next-slowest client
    speedups = {c: latencies[c] / t_target for c in stragglers}
    rates = {c: pick_rate(s, sizes) for c, s in speedups.items()}
    return StragglerPlan(stragglers, t_target, speedups, rates)


def plan_from_store(store, client_ids: Sequence[int],
                    frac: Optional[float] = None,
                    sizes: Sequence[float] = DEFAULT_SIZES,
                    gap_factor: float = 1.10) -> StragglerPlan:
    """`plan` fed from a ClientStore's speed history instead of a per-round
    Python dict (fl/population.py).

    `store` is duck-typed: anything exposing `last_latency(ids)` — the most
    recent full-model-equivalent observation per client — works. Clients in
    `client_ids` with no observation yet (rounds_participated == 0, latency
    reported as NaN) are excluded, exactly as an absent dict key would be.
    Detection uses `detect_band` (density-dip split) instead of the
    adjacent-gap rule: population cohorts hold many stragglers at tied
    speeds and enough draws that sim-time noise fills any adjacent gap,
    while the dip between the cluster and the band survives any cohort
    size. On small clearly-separated cohorts both rules agree, so store-
    backed calibration matches the legacy `plan(latencies)` there. An
    explicit `frac` bypasses detection entirely, exactly as in `plan`.
    """
    ids = list(client_ids)
    last = np.asarray(store.last_latency(ids), np.float64)
    latencies = {cid: float(t) for cid, t in zip(ids, last)
                 if np.isfinite(t)}
    if not latencies:
        return StragglerPlan([], 0.0, {}, {})
    if frac is not None:
        return plan(latencies, frac=frac, sizes=sizes,
                    gap_factor=gap_factor)
    return _plan_with(latencies,
                      detect_band(latencies, gap_factor=gap_factor), sizes)


# ---------------------------------------------------------------------------
# Arrival-process model (asynchronous rounds, fl/async_rounds.py)

@dataclass
class ArrivalModel:
    """What happens to a dispatched client between "starts training" and
    "its delta reaches the server": the arrival process of the async
    buffered backend (fl/async_rounds.py).

    The base latency comes from the client speed model
    (``SimClient._sim_time``, with its own lognormal tail ``tail_sigma``, so
    the synchronous baseline sees the same distribution). This model adds
    the async-only failure modes:

      * ``tail_sigma``: extra multiplicative lognormal spread on async
        arrivals only;
      * ``drop_prob``: per-dispatch probability the client falls off
        mid-round; it reconnects after an Exp(reconnect_mean) pause and its
        delta lands in a later buffer with higher staleness;
      * ``max_drops``: cap on consecutive dropouts per dispatch.

    Draws come from a private seeded ``RandomState``: the lognormal first,
    then the drop loop. With everything at zero ``draw(t)`` returns
    ``(t, 0)`` and consumes no randomness, which the zero-spread
    fleet == async equivalence relies on."""
    tail_sigma: float = 0.0
    drop_prob: float = 0.0
    reconnect_mean: float = 30.0
    max_drops: int = 2
    seed: int = 0

    def __post_init__(self):
        if self.tail_sigma < 0.0:
            raise ValueError(f"tail_sigma must be >= 0, got {self.tail_sigma}")
        if not 0.0 <= self.drop_prob < 1.0:
            raise ValueError(f"drop_prob must be in [0, 1), "
                             f"got {self.drop_prob}")
        self._rng = np.random.RandomState(self.seed)

    def draw(self, base: float):
        """(arrival latency, n_dropouts) for one dispatched job whose
        compute+transfer time is ``base`` emulated seconds."""
        lat = float(base)
        if self.tail_sigma > 0.0:
            lat *= math.exp(self.tail_sigma * float(self._rng.randn()))
        drops = 0
        while (self.drop_prob > 0.0 and drops < self.max_drops
               and self._rng.rand() < self.drop_prob):
            lat += float(self._rng.exponential(self.reconnect_mean))
            drops += 1
        return max(lat, 1e-6), drops
