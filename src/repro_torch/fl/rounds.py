"""RoundBackend protocol (port of ``repro/fl/rounds.py``).

``core/fluid.FluidServer`` drives rounds through a small contract:

    backend.clients                              -> the cohort (ordered)
    backend.run_round(params, keep_maps, rates)  -> result with
        .sim_times                 {cid: emulated seconds}
        .aggregate(params)         -> new global params (masked FedAvg)
        .non_straggler_stats(prev) -> per-client invariant-neuron stats
        .updates()                 -> per-client ClientUpdates

The port has the fleet backend (fl/fleet.py). The sequential,
sharded_fleet and async backends, and the async ``EventLoop``, wait for
later slices (ROADMAP.md queue A).
"""
from __future__ import annotations

from typing import Dict, List, Protocol, Sequence

from repro_torch.core.aggregate import ClientUpdate
from repro_torch.fl.fleet import FleetEngine

BACKEND_NAMES = ("sequential", "fleet", "sharded_fleet", "async")
PORTED_BACKENDS = ("fleet",)


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
                 use_kernels: bool = True, device="cuda") -> RoundBackend:
    """A RoundBackend for one cohort. Only "fleet" is ported."""
    if name == "fleet":
        return FleetBackend(FleetEngine(model_cls, clients, unit_specs,
                                        use_kernels=use_kernels,
                                        device=device))
    if name in BACKEND_NAMES:
        raise NotImplementedError(
            f"backend {name!r} is not ported yet (ROADMAP.md queue A); the "
            f"port has {PORTED_BACKENDS}")
    raise ValueError(f"backend must be one of {BACKEND_NAMES}, got {name!r}")
