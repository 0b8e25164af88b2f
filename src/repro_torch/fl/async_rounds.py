"""Asynchronous buffered rounds: masked FedAvg without the cohort barrier
(port of ``repro/fl/async_rounds.py``).

The synchronous backends (fl/rounds.py) hold a barrier over the cohort:
one slow or disconnected client bounds the wall clock between
calibrations. This backend drops the barrier, FedBuff-style, and keeps
every FLuID invariant-dropout mechanism:

  * clients are dispatched with the current params and the keep-masks the
    store assigned them, in groups of exactly ``buffer_k`` (the last group
    capacity-padded through the fleet's ``members=``), so a group is one
    cohort program whatever number of clients happened to be free; with
    ``use_kernels`` each group's SGD steps launch the masked kernels once
    a step for the group;
  * each dispatched client's masked delta is computed at once (it depends
    only on the dispatch-time params) and its arrival is scheduled on a
    virtual clock (fl/rounds.EventLoop) at now + latency, the client speed
    model's draw passed through the arrival process
    (core/straggler.ArrivalModel: heavy tails, mid-round dropouts that
    reconnect and resume);
  * one round drains the first ``buffer_k`` arrivals off the clock and
    aggregates them with staleness-weighted masked FedAvg
    (core/aggregate.aggregate_buffered: the fleet's ``partial_sums`` /
    ``combine_partials`` chain, each weight discounted by (1+s)^(-a),
    max-normalized). A straggler that misses the buffer is not dropped:
    its delta lands in a later buffer with staleness = the server versions
    it missed.

With a zero-spread ArrivalModel and no client tail, arrival order is
dispatch order (the EventLoop breaks ties by push order), and a run with
buffer_k = concurrency = cohort_size reproduces the synchronous fleet run
bitwise (tests/test_torch_async.py): the lognormal(0) multiplier is never
drawn, staleness 0 scales by exactly 1.0, the rebuilt buffer bank is the
dispatch bank row for row, and the arrivals are summed in (version, slot)
order through the same add chain as ``aggregate_stacked``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregate import ClientUpdate, aggregate_buffered
from repro_torch.core.straggler import ArrivalModel
from repro_torch.core.tree import tree_map
from repro_torch.fl.fleet import CohortResult, FleetEngine
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.rounds import EventLoop


@dataclass
class AsyncConfig:
    """Async buffered-round policy.

    buffer_k: arrivals aggregated per server step (and the dispatch-group
    capacity). concurrency: target number of in-flight clients (FedBuff's
    M); must be >= buffer_k so a buffer can always fill.
    staleness_exponent: the ``a`` of the (1+s)^(-a) discount (0 = ignore
    staleness). flash_crowds: (server_step, extra) pairs: at that step the
    driver dispatches ``extra`` clients beyond the concurrency target, a
    reconnect surge that drains back over the following buffers."""
    buffer_k: int = 8
    concurrency: int = 64
    staleness_exponent: float = 0.5
    arrival: ArrivalModel = field(default_factory=ArrivalModel)
    flash_crowds: Sequence[Tuple[int, int]] = ()

    def __post_init__(self):
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}")
        if self.concurrency < self.buffer_k:
            raise ValueError(
                f"concurrency ({self.concurrency}) must be >= buffer_k "
                f"({self.buffer_k}): the buffer could never fill")
        if self.staleness_exponent < 0.0:
            raise ValueError(f"staleness_exponent must be >= 0, "
                             f"got {self.staleness_exponent}")


@dataclass
class _InFlight:
    """One dispatched client riding the event loop: which slot of which
    dispatch-group result it owns, and what the server knew at dispatch."""
    cid: int
    version: int                 # server version at dispatch
    slot: int                    # row in the dispatch group's stacked result
    result: CohortResult         # the (buffer_k,)-shaped dispatch outputs
    latency: float               # end-to-end arrival latency (sim seconds)
    rate: float                  # sub-model size trained
    stats: Optional[dict]        # dispatch-time invariant stats (non-strag)
    drops: int                   # mid-round dropouts survived


@dataclass
class AsyncRoundResult:
    """RoundResult over one drained buffer (fl/rounds.py protocol, plus
    the async-only fields core/fluid.FluidServer reads through getattr:
    clock, staleness, rates_trained, calib_ids)."""
    arrivals: List[_InFlight]    # canonical order: (dispatch version, slot)
    version: int                 # server version aggregating this buffer
    clock: float                 # virtual time when the buffer filled
    exponent: float

    @property
    def sim_times(self) -> Dict[int, float]:
        return {a.cid: a.latency for a in self.arrivals}

    @property
    def rates_trained(self) -> Dict[int, float]:
        """Rate each arrival actually trained (assigned at its dispatch)."""
        return {a.cid: a.rate for a in self.arrivals}

    @property
    def calib_ids(self) -> List[int]:
        """The clients with fresh observations: this buffer's arrivals,
        sorted like a cohort."""
        return sorted(a.cid for a in self.arrivals)

    @property
    def staleness(self) -> np.ndarray:
        return np.asarray([self.version - a.version for a in self.arrivals],
                          np.float32)

    def _buffer_bank(self):
        """(bank, idx) over the buffer, rebuilt from the arrivals' dispatch
        banks: all-ones row 0 + one row per distinct straggler mask, in
        first-encounter order over the canonical arrival order. The dedupe
        key is (dispatch result, row): rows of one dispatch bank are
        distinct by construction. For a single dispatch group encounter
        order is ascending-cid order, so the rebuilt bank is the dispatch
        bank exactly."""
        first = self.arrivals[0].result
        ones = tree_map(lambda b: b[0], first.mask_bank)
        rows, row_map, idx = [ones], {}, []
        for a in self.arrivals:
            r = a.result.idx_host[a.slot]
            if r == 0:
                idx.append(0)
                continue
            key = (id(a.result), r)
            if key not in row_map:
                row_map[key] = len(rows)
                rows.append(tree_map(lambda b: b[r], a.result.mask_bank))
            idx.append(row_map[key])
        bank = tree_map(lambda *rs: torch.stack(rs), *rows)
        return bank, torch.as_tensor(idx, dtype=torch.int64,
                                     device=first.mask_idx.device)

    def aggregate(self, global_params):
        """Staleness-weighted masked FedAvg over the buffer. The arrivals'
        rows, stacked in canonical order, are the inputs aggregate_stacked
        would see for a synchronous cohort."""
        deltas = tree_map(
            lambda *rows: torch.stack(rows),
            *[tree_map(lambda d: d[a.slot], a.result.deltas)
              for a in self.arrivals])
        weights = torch.stack([a.result.weights[a.slot]
                               for a in self.arrivals])
        bank, idx = self._buffer_bank()
        return aggregate_buffered(global_params, deltas, weights, bank, idx,
                                  self.staleness, self.exponent)

    def non_straggler_stats(self, prev_params) -> List[dict]:
        """Invariant-neuron stats of the buffer's full-model arrivals,
        computed at dispatch against the dispatch params (the delta's own
        baseline); ``prev_params`` is ignored: a mixed-staleness buffer has
        no single previous params."""
        del prev_params
        return [a.stats for a in self.arrivals if a.stats is not None]

    def updates(self) -> List[ClientUpdate]:
        out = []
        for a in self.arrivals:
            delta = tree_map(lambda d: d[a.slot], a.result.deltas)
            mask = None
            if a.cid in a.result.straggler_ids:
                row = a.result.idx_host[a.slot]
                mask = tree_map(lambda b: b[row], a.result.mask_bank)
            out.append(ClientUpdate(delta, int(a.result.weights[a.slot]),
                                    mask, a.latency, 0.0, a.cid))
        return out


class AsyncBufferedBackend:
    """RoundBackend without a barrier: dispatch at once, aggregate the
    first buffer_k arrivals, keep the rest in flight.

    Stateful across rounds (virtual clock, arrival heap, in-flight set,
    server version): construct once and re-point ``set_dispatch`` each
    round. ``clients`` is only the next dispatch group, not the buffer."""
    name = "async"

    def __init__(self, model_cls, unit_specs, cfg: AsyncConfig,
                 use_kernels: bool = False, device="cuda"):
        self.model_cls = model_cls
        self.unit_specs = unit_specs
        self.cfg = cfg
        self.use_kernels = bool(use_kernels)
        self.device = torch.device(device)
        self.loop = EventLoop()
        self.version = 0
        self.clients: List = []          # next dispatch group
        self.in_flight_ids: set = set()
        self.last_arrived: List[int] = []
        self.last_result: Optional[AsyncRoundResult] = None
        self.n_dispatched = 0
        self.total_drops = 0

    def set_dispatch(self, clients: Sequence) -> None:
        """Point the backend at the next round's dispatch group (clients
        already in flight are skipped at dispatch)."""
        self.clients = list(clients)

    def _dispatch_chunk(self, params, chunk, keep_maps, rates, members):
        """Run one capacity-padded dispatch group now and schedule its
        arrivals: the delta depends only on the dispatch params, so only
        its visibility to the server is delayed. A fresh FleetEngine a
        group, as in the reference."""
        engine = FleetEngine(self.model_cls, chunk, self.unit_specs,
                             use_kernels=self.use_kernels,
                             device=self.device)
        ids_here = {c.id for c in chunk}
        km = {cid: m for cid, m in keep_maps.items() if cid in ids_here}
        res = engine.run_cohort(params, km, rates, members=members)
        stats = res.non_straggler_stats(params)
        stat_slots = [i for i, cid in enumerate(res.client_ids)
                      if cid not in res.straggler_ids
                      and (members is None or members[i])]
        by_slot = dict(zip(stat_slots, stats))
        for slot, c in enumerate(chunk):
            if members is not None and not members[slot]:
                continue
            lat, drops = self.cfg.arrival.draw(res.sim_times[c.id])
            self.loop.push(
                self.loop.now + lat,
                _InFlight(c.id, self.version, slot, res, lat,
                          rates.get(c.id, 1.0), by_slot.get(slot), drops))
            self.in_flight_ids.add(c.id)
            self.n_dispatched += 1
            self.total_drops += drops

    def run_round(self, params, keep_maps: Dict[int, dict],
                  rates: Dict[int, float]) -> AsyncRoundResult:
        K = self.cfg.buffer_k
        group = [c for c in self.clients if c.id not in self.in_flight_ids]
        for i in range(0, len(group), K):
            chunk = list(group[i:i + K])
            members = None
            if len(chunk) < K:
                members = np.zeros(K, bool)
                members[:len(chunk)] = True
                # pad with clones under reserved negative ids: replace()
                # re-runs __post_init__, so the pads own fresh RNG streams
                # and the real clients' draws are untouched
                chunk += [dataclasses.replace(chunk[0], id=-(j + 1))
                          for j in range(K - len(chunk))]
            self._dispatch_chunk(params, chunk, keep_maps, rates, members)
        if len(self.loop) < K:
            raise RuntimeError(
                f"async buffer cannot fill: buffer_k={K} but only "
                f"{len(self.loop)} clients in flight — raise concurrency "
                f"or dispatch more clients")
        arrivals = [self.loop.pop()[1] for _ in range(K)]
        clock = self.loop.now
        # canonical aggregation order: (dispatch version, slot), equal to
        # client order for a single fresh dispatch group
        arrivals.sort(key=lambda a: (a.version, a.slot))
        for a in arrivals:
            self.in_flight_ids.discard(a.cid)
        self.last_arrived = [a.cid for a in arrivals]
        result = AsyncRoundResult(arrivals, self.version, clock,
                                  self.cfg.staleness_exponent)
        self.version += 1
        self.last_result = result
        return result


# ---------------------------------------------------------------------------
# Population driver

class AsyncPopulationSim(PopulationSim):
    """PopulationSim whose rounds are arrival buffers, not barriers.

    Each round: top the in-flight pool back up to ``concurrency`` by
    sampling only available clients (active and not in flight), dispatch
    them with the store's current rate assignments, drain one buffer, and
    let FluidServer record observations and recalibrate over the arrived
    clients. Flash crowds dispatch extra clients at configured steps.
    Built by ``build_population(PopulationConfig(backend="async",
    async_cfg=...))``."""

    def __init__(self, base: PopulationSim):
        self.__dict__.update(base.__dict__)
        self.acfg: AsyncConfig = self.cfg.async_cfg or AsyncConfig()
        if self.acfg.concurrency > self.cfg.n_clients:
            raise ValueError(
                f"concurrency ({self.acfg.concurrency}) exceeds the "
                f"population ({self.cfg.n_clients})")
        self.backend = AsyncBufferedBackend(
            self.model_cls, self.model_cls.UNIT_SPECS, self.acfg,
            use_kernels=self.cfg.use_kernels, device=self.device)

    @property
    def clock(self) -> float:
        """Virtual seconds elapsed (the async analogue of summing the
        synchronous per-round barrier times)."""
        return self.backend.loop.now

    def run_round(self, eval_now: bool = False):
        rnd = self.server.round
        need = self.acfg.concurrency - len(self.backend.in_flight_ids)
        need += sum(extra for step, extra in self.acfg.flash_crowds
                    if step == rnd)
        need = max(0, need)
        if need:
            ids = self.store.sample_cohort(self.cohort_noise(rnd), need,
                                           available_only=True)
            clients = self._materialize(ids)
            self.server.store = self.server.store.mark_in_flight(ids, True)
        else:
            clients = []
        self.backend.set_dispatch(clients)
        log = self.server.run_round(eval_now=eval_now, backend=self.backend)
        self.server.store = self.server.store.mark_in_flight(
            np.asarray(self.backend.last_arrived, np.int64), False)
        return log


def build_async_population(cfg, acfg: Optional[AsyncConfig] = None,
                           params=None) -> AsyncPopulationSim:
    """``build_population`` with backend='async'."""
    from repro_torch.fl.population import build_population
    cfg = dataclasses.replace(cfg, backend="async",
                              async_cfg=acfg if acfg is not None
                              else cfg.async_cfg)
    return build_population(cfg, params=params)
