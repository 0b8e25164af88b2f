"""Emulated FL clients (port of ``repro/fl/client.py``).

Each client owns a non-IID data shard and a *speed model* calibrated to the
paper's measurement (App. A.3): end-to-end round time is linear in sub-model
size r, with multiplicative noise, plus a communication term proportional
to the transferred parameter count. Local training is real SGD; only
wall-clock is modeled.

Two execution paths share the same data and speed model:
  * ``SimClient.train`` — the sequential reference: one client at a time,
    plain minibatch SGD on the params it is given (a straggler's physically
    extracted sub-model).
  * ``FleetClient`` — the batched path: exposes the epoch batch order and
    the time model so fl/fleet.py can train a whole cohort as one program.

Every client draws from its own ``np.random.RandomState`` in the
reference's order — one permutation per local epoch (``_epoch_order``),
then one noise draw for the round's time (``_sim_time``) — so a port round
sees the same batches and the same times as the reference's. A lognormal
latency tail (``tail_sigma > 0``, the population and async runs) draws one
more normal after the noise.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.aggregate import ClientUpdate
from repro_torch.core.tree import tree_leaves, tree_map


def _xent(logits, yb):
    """Per-sample softmax cross-entropy, ``lse - gold``."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, yb[..., None].long())[..., 0]


def make_loss(model_cls):
    """Mean softmax cross-entropy — the sequential path's loss."""
    def loss(params, xb, yb):
        return _xent(model_cls.apply(params, xb), yb).mean()
    return loss


def make_weighted_loss(model_cls):
    """Sample-weighted mean cross-entropy of one client (fl/fleet.py's
    dense path runs it on each client's slice of the cohort's params).

    With weights 1 on a client's real samples and 0 on padding this equals
    the client's own mean loss; an all-zero weight row (a padded step)
    gives a constant 0, hence a zero gradient — a no-op SGD step."""
    def loss(params, xb, yb, wb):
        return ((wb * _xent(model_cls.apply(params, xb), yb)).sum()
                / torch.clamp(wb.sum(), min=1.0))
    return loss


def make_weighted_kernel_loss(model_cls):
    """Sample-weighted mean cross-entropy per client, through the model's
    kernel path: ``loss(params, xb, yb, wb, kmasks) -> (C,)``.

    With weights 1 on a client's real samples and 0 on padding this is the
    client's own mean loss; an all-zero weight row (a padded step) gives a
    constant 0, hence a zero gradient — a no-op SGD step."""
    def loss(params, xb, yb, wb, kmasks):
        logits = model_cls.apply_kernels(params, xb, kmasks)
        return ((wb * _xent(logits, yb)).sum(-1)
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
    tail_sigma: float = 0.0          # lognormal heavy-tail sigma (0 = off)
    batch_size: int = 20
    local_epochs: int = 1
    lr: float = 0.01
    seed: int = 0
    _rng: np.random.RandomState = field(init=False, repr=False)

    def __post_init__(self):
        # the reference's seed derivation, kept in RandomState's [0, 2**32):
        # the async backend's capacity pads carry negative ids
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
        """End-to-end emulated seconds (one RNG draw; a second when
        tail_sigma > 0): linear in sub-model size, times a lognormal tail
        draw, plus transfer. At tail_sigma 0 no extra draw is consumed, so
        every seeded run without a tail is unchanged."""
        sim = (self.speed * self.local_epochs * rate
               * (1.0 + self.noise * self._rng.randn()))
        if self.tail_sigma > 0.0:
            sim *= math.exp(self.tail_sigma * float(self._rng.randn()))
        sim += 2 * self.comm_s_per_mparam * n_params / 1e6
        return max(sim, 1e-6)

    def train(self, params, keep_map=None, rate: float = 1.0) -> ClientUpdate:
        """The client's local epochs of plain minibatch SGD, ``w -= lr *
        g``, on the device the params lie on. Draws one permutation per
        epoch, then the round's noise. ``sim_time`` counts the parameters
        of the tree given (a straggler's sub-model)."""
        t0 = time.perf_counter()
        loss = make_loss(self.model_cls)
        bs = self.eff_batch_size
        nb = self.n_samples // bs
        dev = tree_leaves(params)[0].device
        w = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
        leaves = tree_leaves(w)
        for _ in range(self.local_epochs):
            order = self._epoch_order()
            xs = torch.as_tensor(self.x[order].reshape(nb, bs, *self.x.shape[1:]),
                                 device=dev)
            ys = torch.as_tensor(self.y[order].reshape(nb, bs), device=dev)
            for s in range(nb):
                grads = torch.autograd.grad(loss(w, xs[s], ys[s]), leaves)
                with torch.no_grad():
                    for a, g in zip(leaves, grads):
                        a -= self.lr * g
        with torch.no_grad():
            delta = tree_map(lambda a, p: a.detach() - p, w, params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        real = time.perf_counter() - t0
        n_par = sum(p.numel() for p in tree_leaves(params))
        return ClientUpdate(delta, self.n_samples, None,
                            self._sim_time(rate, n_par), real, self.id)

    def evaluate(self, params, x=None, y=None) -> float:
        """Accuracy of ``params`` on the client's shard (or on x, y)."""
        x = self.x if x is None else x
        y = self.y if y is None else y
        dev = tree_leaves(params)[0].device
        with torch.no_grad():
            logits = self.model_cls.apply(params, torch.as_tensor(x, device=dev))
        return float((logits.argmax(-1).cpu() == torch.as_tensor(y)).float().mean())


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
