"""FLuID server — Algorithm 1 of the paper, framework-level.

Port of ``repro/core/fluid.py``: the same host-side logic, pointed at the
port's modules. The per-client stats it reads are torch fp32 tensors
(``core/invariant``); everything it decides is numpy or Python.

The server is agnostic to how clients execute: anything satisfying the
RoundBackend contract (fl/rounds.py: sequential, fleet, sharded_fleet,
and the async buffered backend) works, and the backend may change per
round. Per calibration step the server (1) records end-to-end client
times into the store's speed history, (2) re-detects stragglers and
T_target from that history, (3) re-derives per-straggler dropout rates r_i
from the linear time model and writes them back to the store, (4)
increments the drop threshold until enough neurons are invariant, and (5)
extracts tailored sub-models via the selected policy (random / ordered /
invariant).

Layering: core/ never imports fl/. The backend and the store are duck-typed
— the store needs `rates_of`, `update_from_round`, `assign_rates`, and
`last_latency` (consumed via core/straggler.plan_from_store); without a
store the server falls back to per-round dicts (legacy standalone use).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import invariant as inv
from repro_torch.core import straggler as strag
from repro_torch.core.dropout import get_policy, keep_count


@dataclass
class FluidConfig:
    method: str = "invariant"              # random | ordered | invariant | none
    submodel_sizes: Sequence[float] = strag.DEFAULT_SIZES
    fixed_rate: Optional[float] = None     # force one r for all stragglers
    straggler_frac: Optional[float] = None  # None => auto gap detection
    calibrate_every: int = 1
    warmup_rounds: int = 1                 # full-model rounds before dropout
    seed: int = 0


@dataclass
class RoundLog:
    round: int = 0
    round_time: float = 0.0                # max client sim time (sync FL)
    clock: float = 0.0                     # virtual wall-clock (async FL)
    staleness_mean: float = 0.0            # buffer staleness (async FL)
    staleness_max: float = 0.0
    straggler_time: float = 0.0
    t_target: float = 0.0
    stragglers: List[int] = field(default_factory=list)
    rates: Dict[int, float] = field(default_factory=dict)
    threshold: float = 0.0
    invariant_frac: float = 0.0
    calib_time: float = 0.0                # server-side overhead (real s)
    accuracy: float = float("nan")


class FluidServer:
    def __init__(self, params, unit_specs, backend=None, cfg=None,
                 eval_fn: Optional[Callable] = None, store=None):
        if cfg is None:
            raise ValueError("FluidServer needs a FluidConfig (cfg=...)")
        self.params = params
        self.unit_specs = unit_specs
        self.backend = backend        # default RoundBackend (fl/rounds.py)
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.store = store            # fl.population.ClientStore or None
        self.policy = get_policy(
            cfg.method if cfg.method != "none" else "ordered",
            unit_specs, seed=cfg.seed)
        self.th: Optional[float] = None
        self.plan: Optional[strag.StragglerPlan] = None
        self.round = 0
        self.history: List[RoundLog] = []

    # ------------------------------------------------------------------ views
    @property
    def engine(self):
        """The fleet engine of the default backend, if any (tests, bench)."""
        return getattr(self.backend, "engine", None)

    @property
    def clients(self):
        return self.backend.clients if self.backend is not None else []

    # ------------------------------------------------------------------ utils
    def _total_neurons(self) -> int:
        return sum(g["size"] for g in self.unit_specs)

    def _drop_target(self, rates: Dict[int, float]) -> int:
        if not rates:
            return 0
        r_min = min(rates.values())
        return sum(g["size"] - keep_count(g["size"], r_min)
                   for g in self.unit_specs)

    def _rate_for(self, cid: int) -> float:
        return (self.cfg.fixed_rate if self.cfg.fixed_rate is not None
                else self.plan.rates[cid])

    # ------------------------------------------------------------------ round
    def run_round(self, eval_now: bool = False, backend=None) -> RoundLog:
        """One synchronous FLuID round via `backend` (default: the one from
        __init__ — a population-scale caller passes a fresh cohort backend
        per round). Store slots are client ids."""
        cfg = self.cfg
        backend = self.backend if backend is None else backend
        if backend is None:
            raise ValueError("no RoundBackend: pass backend= to __init__ "
                             "or run_round")
        ids = [c.id for c in backend.clients]
        log = RoundLog(round=self.round)
        use_dropout = (cfg.method != "none"
                       and self.round >= cfg.warmup_rounds)

        # -------- sub-model assignment: the store's per-client dropout rate
        # (written by the previous calibration) decides who trains what
        keep_maps: Dict[int, dict] = {}
        rates_used: Dict[int, float] = {}
        if use_dropout and self.store is not None:
            for cid, r in zip(ids, self.store.rates_of(ids)):
                if r < 1.0:
                    keep_maps[cid] = self.policy.keep_map(float(r))
                    rates_used[cid] = float(r)
        elif (use_dropout and self.plan is not None
              and bool(self.plan.stragglers)):
            # storeless fallback: read the last plan directly
            for cid in self.plan.stragglers:
                if cid in ids:
                    r = self._rate_for(cid)
                    keep_maps[cid] = self.policy.keep_map(r)
                    rates_used[cid] = r

        # -------- broadcast + local training
        prev = self.params
        result = backend.run_round(self.params, keep_maps, rates_used)
        actual = dict(result.sim_times)

        # An async backend reports arrivals, not the dispatch cohort: who
        # was observed (sim_times), the rate each arrival actually trained
        # (rates_trained — assigned at ITS dispatch, not this round's), and
        # who calibration should reason about (calib_ids). Synchronous
        # backends expose none of these, and every fallback below
        # reproduces the synchronous behavior exactly.
        obs_rates = getattr(result, "rates_trained", None)
        if obs_rates is None:
            obs_rates = rates_used

        # full-model-equivalent latency: a straggler that trained a sub-model
        # of size r would take time/r on the full model (linear model, A.3)
        latencies = {cid: t / obs_rates.get(cid, 1.0)
                     for cid, t in actual.items()}
        log.round_time = max(actual.values())
        log.clock = float(getattr(result, "clock", 0.0))
        stale = getattr(result, "staleness", None)
        if stale is not None and len(stale):
            log.staleness_mean = float(np.mean(stale))
            log.staleness_max = float(np.max(stale))
        if self.plan and self.plan.stragglers:
            st = [actual[c] for c in self.plan.stragglers if c in actual]
            log.straggler_time = max(st) if st else 0.0
            log.t_target = self.plan.t_target
            log.stragglers = list(self.plan.stragglers)
            log.rates = dict(self.plan.rates)

        # -------- record observations (speed history feeds recalibration)
        # obs_ids: whoever was actually observed, in cohort order first
        # (== ids exactly for synchronous backends) then any arrival from
        # an earlier dispatch, in buffer order
        ids_set = set(ids)
        obs_ids = ([c for c in ids if c in actual]
                   + [c for c in actual if c not in ids_set])
        if self.store is not None and obs_ids:
            self.store = self.store.update_from_round(
                np.asarray(obs_ids, np.int32),
                np.asarray([latencies[c] for c in obs_ids], np.float32),
                np.asarray([obs_rates.get(c, 1.0) for c in obs_ids],
                           np.float32))

        # -------- aggregate
        self.params = result.aggregate(self.params)

        # -------- calibration (server-side; wall-clock measured as overhead)
        t0 = time.perf_counter()
        # calibration scope: the clients with fresh observations — the
        # cohort for synchronous backends, this buffer's arrivals for async
        calib_ids = list(getattr(result, "calib_ids", None) or ids)
        if self.round % cfg.calibrate_every == 0:
            per_client = result.non_straggler_stats(prev)
            if per_client:
                if self.th is None:
                    self.th = inv.initial_threshold(per_client)
                if self.store is not None:
                    self.plan = strag.plan_from_store(
                        self.store, calib_ids, frac=cfg.straggler_frac,
                        sizes=cfg.submodel_sizes)
                else:
                    self.plan = strag.plan(latencies,
                                           frac=cfg.straggler_frac,
                                           sizes=cfg.submodel_sizes)
                target = self._drop_target(
                    {c: cfg.fixed_rate for c in self.plan.stragglers}
                    if cfg.fixed_rate is not None else self.plan.rates)
                if target:
                    self.th = inv.calibrate_threshold(per_client, target,
                                                      self.th)
                self.policy.observe(per_client, self.th)
                log.threshold = float(self.th)
                log.invariant_frac = (inv.count_invariant(per_client, self.th)
                                      / self._total_neurons())
                if self.store is not None:
                    # write the new plan back: stragglers get their rate,
                    # everyone else observed returns to the full model
                    stragglers = set(self.plan.stragglers)
                    self.store = self.store.assign_rates(
                        np.asarray(calib_ids, np.int32),
                        np.asarray([self._rate_for(c) if c in stragglers
                                    else 1.0 for c in calib_ids],
                                   np.float32))
        log.calib_time = time.perf_counter() - t0

        if eval_now and self.eval_fn is not None:
            log.accuracy = float(self.eval_fn(self.params))
        self.history.append(log)
        self.round += 1
        return log

    def run(self, rounds: int, eval_every: int = 0):
        for i in range(rounds):
            ev = bool(eval_every) and ((i + 1) % eval_every == 0
                                       or i == rounds - 1)
            self.run_round(eval_now=ev)
        return self.history
