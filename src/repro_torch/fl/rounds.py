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
one batched program (fl/fleet.py), densely or through the kernels. They
agree up to float summation order. The sharded_fleet and async backends,
and the async ``EventLoop``, wait for a later slice (ROADMAP.md queue A).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Protocol, Sequence

from repro_torch.core import invariant as inv
from repro_torch.core import submodel as sub
from repro_torch.core.aggregate import ClientUpdate, aggregate
from repro_torch.core.tree import tree_map
from repro_torch.fl.fleet import FleetEngine

BACKEND_NAMES = ("sequential", "fleet", "sharded_fleet", "async")
PORTED_BACKENDS = ("sequential", "fleet")


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


def make_backend(name: str, model_cls, clients, unit_specs,
                 use_kernels: bool = False, device="cuda") -> RoundBackend:
    """A RoundBackend for one cohort. The sequential backend trains on the
    params' device; the fleet on ``device``."""
    if name == "sequential":
        return SequentialBackend(clients, unit_specs)
    if name == "fleet":
        return FleetBackend(FleetEngine(model_cls, clients, unit_specs,
                                        use_kernels=use_kernels,
                                        device=device))
    if name in BACKEND_NAMES:
        raise NotImplementedError(
            f"backend {name!r} is not ported yet (ROADMAP.md queue A); the "
            f"port has {PORTED_BACKENDS}")
    raise ValueError(f"backend must be one of {BACKEND_NAMES}, got {name!r}")
