"""RoundBackend protocol (port of ``repro/fl/rounds.py``).

``core/fluid.FluidServer`` drives rounds through a small contract:

    backend.clients                              -> the cohort (ordered)
    backend.run_round(params, keep_maps, rates)  -> result with
        .sim_times                 {cid: emulated seconds}
        .aggregate(params)         -> new global params (masked FedAvg)
        .non_straggler_stats(prev) -> per-client invariant-neuron stats
        .updates()                 -> per-client ClientUpdates

SequentialBackend is the numerical reference (one client at a time,
physically extracted sub-models); FleetBackend trains the whole cohort as
one batched program (fl/fleet.py), densely or through the kernels;
ShardedFleetBackend runs that program shard by shard and reduces
hierarchically (fl/shard_fleet.py). They agree up to float summation
order. AsyncBufferedBackend (fl/async_rounds.py) drops the barrier:
``run_round`` dispatches the cohort and drains the first K arrivals off
the ``EventLoop`` below, a deterministic (time, push-order) heap, so a
zero-latency-spread run resolves ties in dispatch order and the whole async
schedule reproduces from the seeds alone.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

from repro_torch.core import invariant as inv
from repro_torch.core import submodel as sub
from repro_torch.core.aggregate import ClientUpdate, aggregate
from repro_torch.core.tree import tree_map
from repro_torch.fl.fleet import FleetEngine
from repro_torch.fl.shard_fleet import ShardedFleetEngine

BACKEND_NAMES = ("sequential", "fleet", "sharded_fleet", "async")
PORTED_BACKENDS = BACKEND_NAMES


class EventLoop:
    """Virtual-clock event queue for emulated asynchrony.

    ``push(t, payload)`` schedules; ``pop()`` returns the earliest event
    and advances ``now`` monotonically (a pop never rewinds the clock).
    Ties on ``t`` break by push order, so with zero latency spread the
    async backend drains arrivals in exactly the order it dispatched
    them."""

    def __init__(self):
        self._heap: List[Tuple[float, int, object]] = []
        self._seq = 0
        self.now = 0.0

    def push(self, t: float, payload) -> None:
        heapq.heappush(self._heap, (float(t), self._seq, payload))
        self._seq += 1

    def pop(self):
        t, _, payload = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return t, payload

    def __len__(self) -> int:
        return len(self._heap)


class RoundResult(Protocol):
    sim_times: Dict[int, float]

    def aggregate(self, global_params): ...
    def non_straggler_stats(self, prev_params) -> List[dict]: ...
    def updates(self) -> List[ClientUpdate]: ...


class RoundBackend(Protocol):
    name: str
    clients: Sequence

    def run_round(self, params, keep_maps: Dict[int, dict],
                  rates: Dict[int, float]) -> RoundResult: ...


# ---------------------------------------------------------------------------
# Sequential reference

@dataclass
class SequentialResult:
    """Per-client ClientUpdates presented through the RoundResult contract."""
    _updates: List[ClientUpdate]
    unit_specs: list

    @property
    def sim_times(self) -> Dict[int, float]:
        return {u.client_id: u.sim_time for u in self._updates}

    def aggregate(self, global_params):
        return aggregate(global_params, self._updates)

    def non_straggler_stats(self, prev_params) -> List[Dict[str, object]]:
        """Per-client invariant-neuron stats (fp32, on the host)."""
        out = []
        for u in self._updates:
            if u.mask is None:
                new = tree_map(lambda p, d: p + d, prev_params, u.delta)
                stats = inv.neuron_stats(prev_params, new, self.unit_specs)
                out.append({g: v.cpu() for g, v in stats.items()})
        return out

    def updates(self) -> List[ClientUpdate]:
        return list(self._updates)


class SequentialBackend:
    """One client at a time; stragglers train physically extracted
    sub-models (core/submodel.extract) and their deltas are re-embedded in
    full coordinates — the paper-literal reference path."""
    name = "sequential"

    def __init__(self, clients: Sequence, unit_specs):
        self.clients = list(clients)
        self.unit_specs = unit_specs

    def run_round(self, params, keep_maps, rates) -> SequentialResult:
        updates: List[ClientUpdate] = []
        for c in self.clients:
            if c.id in keep_maps:
                keep = keep_maps[c.id]
                sub_params = sub.extract(params, self.unit_specs, keep)
                u = c.train(sub_params, keep_map=keep, rate=rates[c.id])
                full_delta, mask = sub.embed_delta(u.delta, params,
                                                   self.unit_specs, keep)
                u = ClientUpdate(full_delta, u.n_samples, mask,
                                 u.sim_time, u.real_time, c.id)
            else:
                u = c.train(params)
            updates.append(u)
        return SequentialResult(updates, self.unit_specs)


# ---------------------------------------------------------------------------
# Fleet backend: CohortResult already satisfies RoundResult

class FleetBackend:
    """The whole cohort as one batched masked-SGD program."""
    name = "fleet"

    def __init__(self, engine: FleetEngine):
        self.engine = engine

    @property
    def clients(self):
        return self.engine.clients

    def run_round(self, params, keep_maps, rates):
        return self.engine.run_cohort(params, keep_maps, rates)


class ShardedFleetBackend(FleetBackend):
    """The fleet program shard by shard, with hierarchical aggregation."""
    name = "sharded_fleet"


def make_backend(name: str, model_cls, clients, unit_specs,
                 use_kernels: bool = False, n_shards: Optional[int] = None,
                 async_cfg=None, device="cuda") -> RoundBackend:
    """A RoundBackend for one cohort. The sequential backend trains on the
    params' device; the others on ``device``.

    sharded_fleet takes ``n_shards`` (default 1: one card is one device).
    "async" builds an AsyncBufferedBackend with ``clients`` as its first
    dispatch group. Unlike the synchronous backends it is stateful across
    rounds (virtual clock, in-flight arrival heap, server version): reuse
    the instance and re-point ``set_dispatch(...)`` each round, as
    fl/async_rounds.AsyncPopulationSim does; a fresh one per round would
    discard every client in flight."""
    if name == "async":
        from repro_torch.fl.async_rounds import (AsyncBufferedBackend,
                                                 AsyncConfig)
        backend = AsyncBufferedBackend(model_cls, unit_specs,
                                       async_cfg or AsyncConfig(),
                                       use_kernels=use_kernels,
                                       device=device)
        backend.set_dispatch(clients)
        return backend
    if name == "sequential":
        return SequentialBackend(clients, unit_specs)
    if name == "fleet":
        return FleetBackend(FleetEngine(model_cls, clients, unit_specs,
                                        use_kernels=use_kernels,
                                        device=device))
    if name == "sharded_fleet":
        return ShardedFleetBackend(ShardedFleetEngine(
            model_cls, clients, unit_specs, n_shards=n_shards,
            use_kernels=use_kernels, device=device))
    raise ValueError(f"backend must be one of {BACKEND_NAMES}, got {name!r}")
