"""The client registry of the population layer (port of ``repro/fl/population.py``).

Only ``ClientStore`` is ported: the struct-of-arrays record of every
client's speed, observed latencies, straggler history and assigned dropout
rate, which ``core/fluid.FluidServer`` reads and writes each round. It
lives on the host as numpy float32/int32 arrays — the FL server's
decisions are host-side, and the reference's jitted float32 updates give
the same values. Every op returns a new store.

Cohort sampling (Gumbel top-k on ``jax.random``), the async in-flight
flags, ``PopulationSim`` and ``build_population`` wait for the population
and async slices (ROADMAP.md queue A).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

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

    @property
    def history(self) -> int:
        return self.speed_hist.shape[1]

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
            active=np.zeros((capacity,), bool))

    def _set(self, name, idx, values) -> "ClientStore":
        arr = getattr(self, name).copy()
        arr[np.asarray(idx, np.int64)] = values
        return dataclasses.replace(self, **{name: arr})

    def register(self, slots, speeds, data_shards) -> "ClientStore":
        """Activate `slots` with emulation speeds + data-shard assignment."""
        return (self._set("speed", slots, np.asarray(speeds, np.float32))
                ._set("data_shard", slots, np.asarray(data_shards, np.int32))
                ._set("active", slots, True))

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

    def last_latency(self, ids) -> np.ndarray:
        """Most recent observed latency per client; NaN if never observed.
        This is what core/straggler.plan_from_store calibrates from."""
        idx = np.asarray(ids, np.int64)
        rp = self.rounds_participated[idx]
        pos = (rp - 1) % self.history
        out = self.speed_hist[idx][np.arange(idx.size), pos].astype(np.float64)
        out[rp == 0] = np.nan
        return out
