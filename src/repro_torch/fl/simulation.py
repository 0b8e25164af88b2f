"""End-to-end FL simulation assembly: data -> ClientStore -> FluidServer
(port of ``repro/fl/simulation.py``).

An experiment is a typed ``SimulationConfig`` (workload, backend, policy,
cohort, speed model, device). The port runs every workload of the
reference's small-cohort simulation — the paper's ``femnist`` (CNN),
``cifar10`` (VGG-9) and ``shakespeare`` (LSTM), the ``synth`` probe MLP,
and the kernel workloads ``femnist_kernel`` and ``femnist_attn`` — on the
synchronous backends ``sequential`` (the default: one client at a time,
stragglers on physically extracted sub-models) and ``fleet`` (the cohort
as one batched program; dense by default, through the hand-written
masked-FFN and head-masked kernels with ``use_kernels=True``, which only
the two kernel workloads' models support), and on ``sharded_fleet`` (the
fleet's program shard by shard, reduced hierarchically; fl/shard_fleet.py).
``backend="async"`` is population-scale only (fl/population.py).

``device`` defaults to "cuda", and a config that asks for the card raises
on a machine without one. With ``device="cpu"`` the cohort trains on the
CPU, and the kernel path runs the kernels' plain versions (the tests do
so).

The reference draws its initial params from ``jax.random``; the port draws
them from a seeded ``torch.Generator``. ``build_simulation(cfg, params=...)``
takes given initial params instead, e.g. the reference's, carried over with
``interop.params_from_numpy``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.dropout import available_policies
from repro_torch.core.fluid import FluidConfig, FluidServer
from repro_torch.core.tree import tree_map
from repro_torch.data.partition import partition_non_iid
from repro_torch.data.synthetic import make_dataset
from repro_torch.fl.client import FleetClient, SimClient
from repro_torch.fl.population import ClientStore
from repro_torch.fl.rounds import BACKEND_NAMES, make_backend
from repro_torch.models.kernel_models import KERNEL_MODELS
from repro_torch.models.small import MODELS

BACKENDS = tuple(n for n in BACKEND_NAMES if n != "async")

WORKLOADS = {
    # dataset, model, paper lr, batch size
    "femnist": ("femnist", "femnist_cnn", 0.004, 10),
    "cifar10": ("cifar10", "cifar_vgg9", 0.01, 20),
    "shakespeare": ("shakespeare", "shakespeare_lstm", 0.001, 32),
    # kernel-capable variants: same datasets, models whose masked matmuls
    # can route through the kernels (use_kernels=True, fleet only)
    "femnist_kernel": ("femnist", "kernel_mlp", 0.02, 10),
    "femnist_attn": ("femnist", "kernel_attn", 0.02, 10),
    # population-scale probe workload: 32-dim vector MLP
    "synth": ("synth", "synth_mlp", 0.05, 20),
}


@dataclass
class CohortConfig:
    """Who trains: fleet composition + per-client hyperparameters (one
    value for the cohort, or one per client). `lr=None` defers to the
    workload's paper default."""
    n_clients: int = 5
    straggler_ids: Sequence[int] = (0,)
    local_epochs: Union[int, Sequence[int]] = 1
    lr: Union[None, float, Sequence[float]] = None
    n_data: int = 2000
    slow_factor: float = 1.3

    def _per_client(self, val, default, name: str) -> list:
        if val is None:
            val = default
        if np.ndim(val) == 0:
            return [type(default)(val)] * self.n_clients
        vals = list(val)
        if len(vals) != self.n_clients:
            raise ValueError(f"{name} must be a scalar or length "
                             f"{self.n_clients}, got length {len(vals)}")
        return [type(default)(v) for v in vals]

    def client_lrs(self, default_lr: float) -> List[float]:
        return self._per_client(self.lr, default_lr, "lr")

    def client_epochs(self) -> List[int]:
        return self._per_client(self.local_epochs, 1, "local_epochs")


@dataclass
class SimulationConfig:
    """A complete experiment: workload x backend x dropout policy x cohort,
    the straggler speed model, and the device the cohort trains on."""
    workload: str = "femnist"
    backend: str = "sequential"            # see BACKENDS
    policy: str = "invariant"              # see core.dropout.available_policies
    cohort: CohortConfig = field(default_factory=CohortConfig)
    speeds: Optional[Dict[int, float]] = None   # None => default_speeds()
    fixed_rate: Optional[float] = None
    straggler_frac: Optional[float] = None
    use_kernels: bool = False     # fleet backend: masked matmuls through kernels
    n_shards: Optional[int] = None  # sharded_fleet: logical shard count
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if (torch.device(self.device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"SimulationConfig(device={self.device!r}) needs a CUDA "
                f"device and none is available; pass device='cpu' to run "
                f"the kernels' plain versions")
        if self.use_kernels and self.backend != "fleet":
            raise ValueError("use_kernels=True requires backend='fleet' "
                             "(the kernel path lives in the cohort program)")
        if self.workload not in WORKLOADS:
            raise ValueError(f"workload must be one of "
                             f"{tuple(WORKLOADS)}, got {self.workload!r}")
        if self.backend == "async":
            raise ValueError(
                "backend='async' is population-scale only — use "
                "build_population(PopulationConfig(backend='async', "
                "async_cfg=AsyncConfig(...)))")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.policy != "none" and self.policy not in available_policies():
            raise ValueError(f"unknown dropout policy {self.policy!r}; "
                             f"available: {available_policies()} or 'none'")
        if self.n_shards is not None and self.backend != "sharded_fleet":
            raise ValueError("n_shards only applies to backend="
                             "'sharded_fleet'")


@dataclass
class Simulation:
    server: FluidServer
    clients: List[SimClient]
    model_cls: type
    ds: object
    backend: str = "sequential"

    @property
    def store(self) -> ClientStore:
        """The simulation's ClientStore (slot i == client i)."""
        return self.server.store

    def set_speed(self, client_id: int, speed: float):
        """Emulate runtime condition changes (paper Fig. 4b); writes
        through to the ClientStore."""
        for c in self.clients:
            if c.id == client_id:
                c.speed = speed
                self.server.store = self.server.store.set_speed(
                    [client_id], [speed])
                return
        raise KeyError(client_id)


def default_speeds(n_clients: int, straggler_ids: Sequence[int],
                   base: float = 10.0, slow_factor: float = 1.3,
                   seed: int = 0) -> Dict[int, float]:
    """Per-epoch seconds mirroring the paper's phone fleet: clustered
    non-stragglers + slow_factor x stragglers (Fig. 4a)."""
    rng = np.random.RandomState(seed)
    vals = base * (1.0 + 0.05 * rng.randn(n_clients))
    speeds = {i: float(vals[i]) for i in range(n_clients)}
    for s in straggler_ids:
        speeds[s] = base * slow_factor
    return speeds


def _build(cfg: SimulationConfig, params=None) -> Simulation:
    co = cfg.cohort
    ds_name, model_name, lr, bs = WORKLOADS[cfg.workload]
    model_cls = (MODELS[model_name] if model_name in MODELS
                 else KERNEL_MODELS[model_name])
    dev = torch.device(cfg.device)
    ds = make_dataset(ds_name, n=co.n_data, n_test=max(400, co.n_data // 5),
                      n_partitions=max(co.n_clients * 2, 16), seed=cfg.seed)
    parts = partition_non_iid(ds, co.n_clients, seed=cfg.seed)
    speeds = cfg.speeds
    if speeds is None:
        speeds = default_speeds(co.n_clients, co.straggler_ids,
                                slow_factor=co.slow_factor, seed=cfg.seed)
    lrs = co.client_lrs(lr)
    epochs = co.client_epochs()
    client_cls = SimClient if cfg.backend == "sequential" else FleetClient
    clients = [client_cls(i, model_cls, ds.x[parts[i]], ds.y[parts[i]],
                          speed=speeds[i], batch_size=bs, lr=lrs[i],
                          local_epochs=epochs[i], seed=cfg.seed)
               for i in range(co.n_clients)]
    if params is None:
        params = model_cls.init(cfg.seed, device=dev)
    else:
        params = tree_map(lambda t: torch.as_tensor(t).to(dev), params)

    xt = torch.as_tensor(ds.x_test, device=dev)
    yt = torch.as_tensor(ds.y_test, device=dev)

    def eval_fn(p):
        with torch.no_grad():
            logits = model_cls.apply(p, xt)
        return float((logits.argmax(-1) == yt).float().mean())

    # one store slot per client: speeds + latency history + assigned rates
    store = ClientStore.empty(co.n_clients).register(
        np.arange(co.n_clients),
        np.asarray([speeds[i] for i in range(co.n_clients)], np.float32),
        np.arange(co.n_clients))
    fcfg = FluidConfig(method=cfg.policy, fixed_rate=cfg.fixed_rate,
                       straggler_frac=cfg.straggler_frac, seed=cfg.seed)
    backend = make_backend(cfg.backend, model_cls, clients,
                           model_cls.UNIT_SPECS, use_kernels=cfg.use_kernels,
                           n_shards=cfg.n_shards, device=dev)
    server = FluidServer(params, model_cls.UNIT_SPECS, backend, fcfg,
                         eval_fn=eval_fn, store=store)
    return Simulation(server, clients, model_cls, ds, cfg.backend)


def build_simulation(config: SimulationConfig, params=None) -> Simulation:
    """Build from a SimulationConfig; ``params`` (a tree of tensors with
    the model's keys) replaces the seeded initial params."""
    if not isinstance(config, SimulationConfig):
        raise TypeError(f"build_simulation takes a SimulationConfig, got "
                        f"{type(config).__name__}")
    return _build(config, params)


def run_experiment(config: SimulationConfig, rounds: int,
                   eval_every: Optional[int] = None, params=None):
    """Build a SimulationConfig and run it for `rounds` rounds."""
    if eval_every is None:
        eval_every = max(1, rounds // 5)
    sim = build_simulation(config, params)
    hist = sim.server.run(rounds, eval_every=eval_every)
    return sim, hist
