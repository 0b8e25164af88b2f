"""Population layer: the client registry and the round driver (port of
``repro/fl/population.py``).

FLuID's server decisions (straggler membership, dropout rate, sub-model
shape) are functions of per-client performance profiles. At 10^5-10^6
registered clients of which a few hundred train a round, the registry is
struct-of-arrays: ``ClientStore`` holds every client's speed, observed
latencies (EMA and a ring buffer), straggler history, assigned dropout
rate, data shard, participation count, and active and in-flight flags.
Its ops (every update returns a new store):

  * ``register(slots, speeds, shards)``: activate clients in bulk;
  * ``sample_cohort(gumbel, size)``: seeded sampling without replacement,
    Gumbel top-k over the eligible clients, ids sorted;
  * ``update_from_round(ids, lat, rates)``: one round's observed latencies
    into the EMA and ring history, participation bumped;
  * ``assign_rates(ids, rates)``: the calibration plan written back, so the
    next cohort holding those clients trains the right sub-model;
  * ``set_speed(ids, speeds)``: emulation ground truth (mid-run drift);
  * ``mark_in_flight(ids, value)``: the async backend's dispatch and
    arrival bookkeeping.

**Where the store lives.** On the host, as numpy float32/int32 arrays. It
is the server's control plane: a per-round host decision over (N,)
arrays, well under a millisecond at N = 10^5, whose results (a cohort's
ids, rates and speeds) the host needs anyway to build the cohort. The
reference's jitted float32 updates give the same values. The cohort's
training runs on ``PopulationConfig.device`` (the card by default).

**Cohort noise.** The reference draws its Gumbel field from ``jax.random``
(``fold_in(PRNGKey(seed), round)``), a stream torch cannot reproduce. The
port splits the draw from the choice: ``_sample_cohort(mask, gumbel,
size)`` is the pure top-k, and ``PopulationSim.cohort_noise(rnd)`` draws
the round's (N,) float32 field from a CPU ``torch.Generator`` seeded from
(seed, round), so a seed gives the same cohorts on any host. Handing both
packages the same field (tests/test_torch_population.py overrides
``cohort_noise`` with the reference's) gives the same cohorts.

``PopulationSim`` drives rounds against the store: sample a cohort,
materialize its clients from the data-shard partitions, hand them to a
``RoundBackend`` (fl/rounds.py: sequential / fleet / sharded_fleet), and
let ``core/fluid.FluidServer`` run the FLuID round against the store.
``backend="async"`` gives ``fl/async_rounds.AsyncPopulationSim``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.fluid import FluidConfig, FluidServer

_EMA = np.float32(0.25)          # weight of the newest observation
DEFAULT_HISTORY = 4              # latency ring-buffer depth per client


@dataclass(frozen=True)
class ClientStore:
    """Struct-of-arrays registry; slot i holds client i."""
    speed: np.ndarray                 # (N,) f32 ground-truth s/epoch (emulation)
    speed_ema: np.ndarray             # (N,) f32 EMA of observed latencies
    speed_hist: np.ndarray            # (N, H) f32 latency ring buffer (NaN=empty)
    straggler_ema: np.ndarray         # (N,) f32 EMA of straggler membership
    dropout_rate: np.ndarray          # (N,) f32 assigned sub-model size (1=full)
    data_shard: np.ndarray            # (N,) i32 dataset partition id
    rounds_participated: np.ndarray   # (N,) i32
    active: np.ndarray                # (N,) bool registered & eligible
    in_flight: np.ndarray             # (N,) bool dispatched, not yet arrived

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    @property
    def history(self) -> int:
        return self.speed_hist.shape[1]

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @classmethod
    def empty(cls, capacity: int, history: int = DEFAULT_HISTORY):
        return cls(
            speed=np.zeros((capacity,), np.float32),
            speed_ema=np.zeros((capacity,), np.float32),
            speed_hist=np.full((capacity, history), np.nan, np.float32),
            straggler_ema=np.zeros((capacity,), np.float32),
            dropout_rate=np.ones((capacity,), np.float32),
            data_shard=np.zeros((capacity,), np.int32),
            rounds_participated=np.zeros((capacity,), np.int32),
            active=np.zeros((capacity,), bool),
            in_flight=np.zeros((capacity,), bool))

    def _set(self, name, idx, values) -> "ClientStore":
        arr = getattr(self, name).copy()
        arr[np.asarray(idx, np.int64)] = values
        return dataclasses.replace(self, **{name: arr})

    def register(self, slots, speeds, data_shards) -> "ClientStore":
        """Activate `slots` with emulation speeds + data-shard assignment."""
        return (self._set("speed", slots, np.asarray(speeds, np.float32))
                ._set("data_shard", slots, np.asarray(data_shards, np.int32))
                ._set("active", slots, True))

    def sample_cohort(self, gumbel, size: int,
                      available_only: bool = False) -> np.ndarray:
        """Seeded without-replacement sample of ``size`` active clients:
        the ``size`` best of ``gumbel`` (an (N,) float32 noise field, e.g.
        ``PopulationSim.cohort_noise``) over the eligible slots, ids
        sorted. ``available_only=True`` also excludes clients in flight.

        Raises ValueError when fewer than ``size`` clients are eligible:
        top-k over the -inf scores of ineligible slots would otherwise hand
        back unregistered or in-flight ids."""
        mask = self.active
        if available_only:
            mask = mask & ~self.in_flight
        pool = int(mask.sum())
        if size > pool:
            raise ValueError(
                f"sample_cohort: requested {size} clients but only {pool} "
                f"are {'available' if available_only else 'active'} "
                f"(capacity {self.capacity})")
        return _sample_cohort(mask, gumbel, size)

    def mark_in_flight(self, ids, value: bool) -> "ClientStore":
        """Flip the in-flight flag for ``ids`` (async dispatch/arrival
        bookkeeping, fl/async_rounds.py)."""
        return self._set("in_flight", ids, bool(value))

    def update_from_round(self, ids, latencies, rates) -> "ClientStore":
        """Record one round's observations for the cohort `ids`.

        latencies: full-model-equivalent seconds (a rate-r straggler's t/r);
        rates: the sub-model size each client trained (1.0 = full). The
        first observation seeds the EMAs directly. fp32 throughout."""
        ids = np.asarray(ids, np.int64)
        lat = np.asarray(latencies, np.float32)
        rates = np.asarray(rates, np.float32)
        pos = self.rounds_participated[ids] % self.history
        first = self.rounds_participated[ids] == 0
        was = (rates < 1.0).astype(np.float32)
        one = np.float32(1.0)
        ema = np.where(first, lat, (one - _EMA) * self.speed_ema[ids]
                       + _EMA * lat)
        sema = np.where(first, was, (one - _EMA) * self.straggler_ema[ids]
                        + _EMA * was)
        hist = self.speed_hist.copy()
        hist[ids, pos] = lat
        rp = self.rounds_participated.copy()
        np.add.at(rp, ids, 1)
        return dataclasses.replace(
            self._set("speed_ema", ids, ema)._set("straggler_ema", ids, sema),
            speed_hist=hist, rounds_participated=rp)

    def assign_rates(self, ids, rates) -> "ClientStore":
        """Write calibration output: dropout rate each client trains next."""
        return self._set("dropout_rate", ids, np.asarray(rates, np.float32))

    def set_speed(self, ids, speeds) -> "ClientStore":
        """Mutate emulation ground truth (mid-run drift, paper Fig. 4b)."""
        return self._set("speed", ids, np.asarray(speeds, np.float32))

    # ------------------------------------------------------ host-side views
    def rates_of(self, ids) -> np.ndarray:
        return self.dropout_rate[np.asarray(ids, np.int64)]

    def speeds_of(self, ids) -> np.ndarray:
        return self.speed[np.asarray(ids, np.int64)]

    def shards_of(self, ids) -> np.ndarray:
        return self.data_shard[np.asarray(ids, np.int64)]

    def last_latency(self, ids) -> np.ndarray:
        """Most recent observed latency per client; NaN if never observed.
        This is what core/straggler.plan_from_store calibrates from."""
        idx = np.asarray(ids, np.int64)
        rp = self.rounds_participated[idx]
        pos = (rp - 1) % self.history
        out = self.speed_hist[idx][np.arange(idx.size), pos].astype(np.float64)
        out[rp == 0] = np.nan
        return out


def _sample_cohort(mask, gumbel, size: int) -> np.ndarray:
    """Gumbel top-k over an eligibility mask: scores are the noise where
    eligible and -inf elsewhere, the ``size`` best are taken and their ids
    sorted. Exclusions (in-flight clients) only remove candidates; they
    never reshuffle the scores of the rest."""
    g = torch.as_tensor(gumbel, dtype=torch.float32).cpu()
    score = torch.where(torch.as_tensor(np.asarray(mask, bool)), g,
                        torch.tensor(-np.inf, dtype=torch.float32))
    _, ids = torch.topk(score, size)
    return np.sort(ids.numpy()).astype(np.int32)


def gumbel_field(seed: int, rnd: int, n: int) -> torch.Tensor:
    """(n,) float32 standard Gumbel noise from a CPU ``torch.Generator``
    seeded from (seed, rnd): -log(-log(u)), u uniform in [tiny, 1)."""
    state = np.random.SeedSequence((int(seed), int(rnd))).generate_state(
        2, np.uint32)
    gen = torch.Generator().manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))
    u = torch.rand(n, generator=gen, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Population speed model (vectorized form of simulation.default_speeds)

def population_speeds(n: int, straggler_frac: float = 0.1,
                      base: float = 10.0, slow_factor: float = 1.3,
                      seed: int = 0) -> np.ndarray:
    """Per-epoch seconds for a whole population: a clustered fast majority
    plus a ``straggler_frac`` slow minority at slow_factor x base (paper
    Fig. 4a's 10-32% slower phones). Noise is clipped so the fast cluster
    never overlaps the slow band."""
    rng = np.random.RandomState(seed)
    speeds = base * (1.0 + 0.05 * np.clip(rng.randn(n), -2.5, 2.5))
    slow = rng.rand(n) < straggler_frac
    speeds[slow] = base * slow_factor
    return speeds.astype(np.float32)


# ---------------------------------------------------------------------------
# Round driver: store -> cohort -> backend -> FluidServer -> store

@dataclass
class PopulationConfig:
    """A population-scale experiment: registry size, per-round cohort,
    which RoundBackend executes the cohort, and the device it trains on."""
    n_clients: int = 100_000
    cohort_size: int = 100
    workload: str = "synth"
    backend: str = "fleet"            # fl.rounds.BACKEND_NAMES
                                      # ("async" => AsyncPopulationSim)
    policy: str = "invariant"
    n_shards: Optional[int] = None    # sharded_fleet: logical shards (None
                                      # => 1, one card)
    n_partitions: int = 64            # dataset shards clients map onto
    samples_per_partition: int = 100
    straggler_frac_pop: float = 0.1   # fraction of the population that is slow
    slow_factor: float = 1.3
    base_speed: float = 10.0
    local_epochs: int = 1
    fixed_rate: Optional[float] = None
    straggler_frac: Optional[float] = None   # detection override (None=gap)
    use_kernels: bool = False
    history: int = DEFAULT_HISTORY
    tail_sigma: float = 0.0           # client-side lognormal latency tail
    async_cfg: Optional[object] = None  # fl.async_rounds.AsyncConfig when
                                        # backend == "async"
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if (torch.device(self.device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                f"PopulationConfig(device={self.device!r}) needs a CUDA "
                f"device and none is available; pass device='cpu' to run "
                f"the kernels' plain versions")


class PopulationSim:
    """Drives FLuID rounds against a ClientStore.

    Each round: sample a cohort from the store with the round's noise
    field, materialize FleetClients over the cohort's data shards (with the
    store's current ground-truth speeds, so drift applied via ``set_speed``
    is visible to the next sample), build the configured RoundBackend, and
    run one FluidServer round, which records latencies back into the store
    and re-plans dropout rates from its history."""

    def __init__(self, cfg: PopulationConfig, store: ClientStore,
                 server: FluidServer, model_cls, ds, partitions,
                 lr: float, batch_size: int):
        self.cfg = cfg
        self.server = server
        self.model_cls = model_cls
        self.ds = ds
        self._parts = partitions          # list of index arrays into ds
        self.lr = lr
        self.batch_size = batch_size
        self.device = torch.device(cfg.device)

    # ------------------------------------------------------------- state
    @property
    def store(self) -> ClientStore:
        return self.server.store

    def set_speed(self, client_id: int, speed: float):
        """Drift emulation: visible to the next cohort sample + round."""
        self.server.store = self.server.store.set_speed([client_id], [speed])

    # ------------------------------------------------------------- round
    def cohort_noise(self, rnd: int) -> torch.Tensor:
        """Round ``rnd``'s (N,) float32 Gumbel field (``gumbel_field`` of
        (seed, rnd)); override it to replay another source's noise."""
        return gumbel_field(self.cfg.seed, rnd, self.store.capacity)

    def cohort_ids(self, rnd: Optional[int] = None) -> np.ndarray:
        rnd = self.server.round if rnd is None else rnd
        return self.store.sample_cohort(self.cohort_noise(rnd),
                                        self.cfg.cohort_size)

    def _materialize(self, ids: np.ndarray) -> List:
        from repro_torch.fl.client import FleetClient
        speeds = self.store.speeds_of(ids)
        shards = self.store.shards_of(ids)
        seed = self.cfg.seed + 65537 * self.server.round
        return [FleetClient(int(cid), self.model_cls,
                            self.ds.x[self._parts[s]],
                            self.ds.y[self._parts[s]],
                            speed=float(sp), batch_size=self.batch_size,
                            lr=self.lr, local_epochs=self.cfg.local_epochs,
                            tail_sigma=self.cfg.tail_sigma, seed=seed)
                for cid, sp, s in zip(ids, speeds, shards)]

    def run_round(self, eval_now: bool = False):
        from repro_torch.fl.rounds import make_backend
        ids = self.cohort_ids()
        clients = self._materialize(ids)
        backend = make_backend(self.cfg.backend, self.model_cls, clients,
                               self.model_cls.UNIT_SPECS,
                               use_kernels=self.cfg.use_kernels,
                               n_shards=self.cfg.n_shards,
                               device=self.device)
        return self.server.run_round(eval_now=eval_now, backend=backend)

    def run(self, rounds: int, eval_every: int = 0):
        for i in range(rounds):
            ev = bool(eval_every) and ((i + 1) % eval_every == 0
                                       or i == rounds - 1)
            self.run_round(eval_now=ev)
        return self.server.history


def build_population(cfg: PopulationConfig, params=None) -> PopulationSim:
    """Assemble store + dataset + FluidServer for a population run.

    Data: ``n_partitions`` IID partitions of a ``workload`` dataset; every
    client maps onto one partition (many-to-one), so 10^5 clients share
    O(n_partitions) arrays and any cohort has identical shard shapes.
    ``params`` (a tree of tensors with the model's keys, e.g. the
    reference's through ``interop.params_from_numpy``) replaces the seeded
    initial params."""
    # late imports: simulation imports this module for the ClientStore
    from repro_torch.core.tree import tree_map
    from repro_torch.data.partition import partition_iid
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.fl.rounds import BACKEND_NAMES
    from repro_torch.fl.simulation import WORKLOADS
    from repro_torch.models.kernel_models import KERNEL_MODELS
    from repro_torch.models.small import MODELS

    if cfg.backend not in BACKEND_NAMES:
        raise ValueError(f"backend must be one of {BACKEND_NAMES}, "
                         f"got {cfg.backend!r}")
    if cfg.async_cfg is not None and cfg.backend != "async":
        raise ValueError("async_cfg only applies to backend='async'")
    if cfg.backend == "async" and cfg.n_shards is not None:
        raise ValueError("backend='async' does not shard (dispatch groups "
                         "are buffer_k-sized fleet programs)")
    ds_name, model_name, lr, bs = WORKLOADS[cfg.workload]
    model_cls = (MODELS[model_name] if model_name in MODELS
                 else KERNEL_MODELS[model_name])
    dev = torch.device(cfg.device)
    n_data = cfg.n_partitions * cfg.samples_per_partition
    ds = make_dataset(ds_name, n=n_data, n_test=max(400, n_data // 5),
                      n_partitions=cfg.n_partitions, seed=cfg.seed)
    parts = partition_iid(ds, cfg.n_partitions, seed=cfg.seed)

    speeds = population_speeds(cfg.n_clients, cfg.straggler_frac_pop,
                               base=cfg.base_speed,
                               slow_factor=cfg.slow_factor, seed=cfg.seed)
    shard_rng = np.random.RandomState(cfg.seed + 1)
    shards = shard_rng.randint(0, cfg.n_partitions, size=cfg.n_clients)
    store = ClientStore.empty(cfg.n_clients, history=cfg.history).register(
        np.arange(cfg.n_clients), speeds, shards)

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

    fcfg = FluidConfig(method=cfg.policy, fixed_rate=cfg.fixed_rate,
                       straggler_frac=cfg.straggler_frac, seed=cfg.seed)
    server = FluidServer(params, model_cls.UNIT_SPECS, cfg=fcfg,
                         eval_fn=eval_fn, store=store)
    sim = PopulationSim(cfg, store, server, model_cls, ds, parts,
                        lr=lr, batch_size=bs)
    if cfg.backend == "async":
        from repro_torch.fl.async_rounds import AsyncPopulationSim
        return AsyncPopulationSim(sim)
    return sim
