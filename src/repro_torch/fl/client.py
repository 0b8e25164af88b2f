"""Emulated FL clients (port of ``repro/fl/client.py``).

Each client owns a non-IID data shard and a *speed model* calibrated to the
paper's measurement (App. A.3): end-to-end round time is linear in sub-model
size r, with multiplicative noise, plus a communication term proportional
to the transferred parameter count. Local training is real SGD (in
fl/fleet.py); only wall-clock is modeled.

Every client draws from its own ``np.random.RandomState`` in the
reference's order — one permutation per local epoch (``_epoch_order``),
then one noise draw for the round's time (``_sim_time``) — so a port round
sees the same batches and the same times as the reference's.

Only the fleet's path is ported: ``SimClient.train`` / ``evaluate`` (the
sequential backend) and the async backend's lognormal latency tail
(``tail_sigma``) wait for later slices (ROADMAP.md queue A).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


def make_weighted_kernel_loss(model_cls):
    """Sample-weighted mean cross-entropy per client, through the model's
    kernel path: ``loss(params, xb, yb, wb, kmasks) -> (C,)``.

    With weights 1 on a client's real samples and 0 on padding this is the
    client's own mean loss; an all-zero weight row (a padded step) gives a
    constant 0, hence a zero gradient — a no-op SGD step."""
    def loss(params, xb, yb, wb, kmasks):
        logits = model_cls.apply_kernels(params, xb, kmasks)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yb[..., None].long())[..., 0]
        return ((wb * (lse - gold)).sum(-1)
                / torch.clamp(wb.sum(-1), min=1.0))
    return loss


@dataclass
class SimClient:
    id: int
    model_cls: type
    x: np.ndarray
    y: np.ndarray
    speed: float                     # seconds per epoch at r = 1.0
    comm_s_per_mparam: float = 0.05  # transfer seconds per 1e6 params (x2)
    noise: float = 0.03
    batch_size: int = 20
    local_epochs: int = 1
    lr: float = 0.01
    seed: int = 0
    _rng: np.random.RandomState = field(init=False, repr=False)

    def __post_init__(self):
        # the reference's seed derivation, kept in RandomState's [0, 2**32)
        self._rng = np.random.RandomState((self.seed + 1000 * self.id)
                                          % (2 ** 32))

    @property
    def n_samples(self) -> int:
        return len(self.y)

    @property
    def eff_batch_size(self) -> int:
        return min(self.batch_size, self.n_samples)

    def _epoch_order(self) -> np.ndarray:
        """One epoch's minibatch sample order (consumes one RNG draw)."""
        bs = self.eff_batch_size
        nb = self.n_samples // bs
        return self._rng.permutation(self.n_samples)[:nb * bs]

    def _sim_time(self, rate: float, n_params: int) -> float:
        """End-to-end emulated seconds (one RNG draw): linear in sub-model
        size, plus transfer."""
        sim = (self.speed * self.local_epochs * rate
               * (1.0 + self.noise * self._rng.randn()))
        sim += 2 * self.comm_s_per_mparam * n_params / 1e6
        return max(sim, 1e-6)


@dataclass
class FleetClient(SimClient):
    """Batched-path client: same shard, speed model, and RNG stream as
    SimClient; trains inside fl/fleet.py's cohort program."""

    def local_batches(self):
        """(xs, ys) for one round: (local_epochs * nb, bs, ...) numpy arrays,
        consuming the RNG exactly like the reference."""
        bs = self.eff_batch_size
        nb = self.n_samples // bs
        orders = np.concatenate([self._epoch_order()
                                 for _ in range(self.local_epochs)])
        xs = self.x[orders].reshape(self.local_epochs * nb, bs,
                                    *self.x.shape[1:])
        ys = self.y[orders].reshape(self.local_epochs * nb, bs)
        return xs, ys

    def draw_sim_time(self, rate: float, n_params: int) -> float:
        """The post-training noise draw, in the reference's RNG order."""
        return self._sim_time(rate, n_params)
