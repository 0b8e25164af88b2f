"""Vectorized client-fleet execution (port of ``repro/fl/fleet.py``).

The whole cohort trains as one batched program:

  * Sub-models are dense keep-masks (core/submodel.keep_mask), deduplicated
    into a (K, ...) bank (core/maskbank.MaskBank) and indexed per client;
    full-model clients use the all-ones row 0.
  * Where the reference vmaps one client's SGD over the cohort, the port
    carries the client axis C explicitly: params are stacked (C, ...) once
    a round (``w0 = apply_mask(params, bank[idx])``), and each SGD step is
    a forward over all clients, ``loss.sum()`` over the clients'
    weighted-mean losses, one ``backward()``, and ``w -= lr * m * g`` under
    ``no_grad``. The forward is the reference's choice of two:
      - dense (``use_kernels=False``, the default): ``make_weighted_loss``
        of ``model_cls.apply`` on each client's slice of the masked params,
        one client after another in the forward, one backward for all —
        any model (convs, pooling, the LSTM). A client's forward and
        backward are then the sequential path's own ops, so a full-model
        client's delta is the sequential one bit for bit, as the
        reference's vmap gives on XLA. ``torch.func.vmap`` would batch the
        convs into a grouped conv that sums in another order, and the
        CNNs' training amplifies that one-ulp noise (a max-pool window or
        a ReLU input near a tie sends the gradient another way) until the
        invariant keep-maps part from the sequential run's;
      - kernels (``use_kernels=True``): the model's ``apply_kernels``,
        where a step launches the masked-FFN forward, dx and dW kernels
        (and the head-masked ones) once each for the whole cohort.
    Both give the same gradients up to float summation order.
  * Shards pad to the cohort-max step count and batch size with sample
    weight 0, so ragged shards and per-client step counts share the
    program; an all-zero step is an exact no-op.
  * Gradients are mask-projected each step, so deltas come back mask-zeroed
    in full coordinates and aggregation is one masked-FedAvg reduce
    (core/aggregate.aggregate_stacked).

The round's host data is built in numpy, in the reference's RNG order, and
moved to the device once a round.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import invariant as inv
from repro_torch.core import submodel as sub
from repro_torch.core.aggregate import ClientUpdate, aggregate_stacked
from repro_torch.core.maskbank import MaskBank
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.fl.client import (FleetClient, make_weighted_kernel_loss,
                                   make_weighted_loss)


@dataclass
class CohortResult:
    """Stacked outputs of one fleet round + per-client views."""
    engine: "FleetEngine"
    deltas: dict                    # tree of (C, ...) leaves, mask-zeroed
    weights: torch.Tensor           # (C,) sample counts
    mask_bank: dict                 # tree of (K, ...) leaves
    mask_idx: torch.Tensor          # (C,) int64
    client_ids: List[int]
    sim_times: Dict[int, float]
    straggler_ids: frozenset
    members: Optional[np.ndarray] = None   # (C,) bool; None = all real

    def _is_member(self, i: int) -> bool:
        return self.members is None or bool(self.members[i])

    @functools.cached_property
    def idx_host(self) -> List[int]:
        """mask_idx on the host, read once."""
        return self.mask_idx.cpu().tolist()

    def aggregate(self, global_params):
        """Masked FedAvg of the cohort (== core.aggregate.aggregate).
        Padding slots (members[i] == False) carry zero weight and zero
        deltas, so they cancel out of both sums."""
        return aggregate_stacked(global_params, self.deltas, self.weights,
                                 self.mask_bank, self.mask_idx)

    def non_straggler_stats(self, prev_params) -> List[Dict[str, torch.Tensor]]:
        """Per-client invariant-neuron stats of the real full-model clients
        (fp32, on the host), computed batched over the selected clients on
        the device (``neuron_stats`` of their stacked new trees, as the
        reference vmaps it) and brought to the host in one copy per unit
        group."""
        sel = [i for i, cid in enumerate(self.client_ids)
               if cid not in self.straggler_ids and self._is_member(i)]
        if not sel:
            return []
        rows = torch.as_tensor(sel, device=self.mask_idx.device)
        new = tree_map(lambda p, d: p + d.index_select(0, rows), prev_params,
                       self.deltas)
        stacked = inv.neuron_stats(prev_params, new, self.engine.unit_specs)
        host = {g: v.cpu() for g, v in stacked.items()}
        return [{g: v[j] for g, v in host.items()} for j in range(len(sel))]

    def updates(self) -> List[ClientUpdate]:
        """Sequential-style ClientUpdates of the real clients (tests /
        inspection)."""
        out = []
        for i, cid in enumerate(self.client_ids):
            if not self._is_member(i):
                continue
            mask = None
            if cid in self.straggler_ids:
                row = self.idx_host[i]
                mask = tree_map(lambda b: b[row], self.mask_bank)
            out.append(ClientUpdate(tree_map(lambda d: d[i], self.deltas),
                                    int(self.weights[i]), mask,
                                    self.sim_times[cid], 0.0, cid))
        return out


class FleetEngine:
    """Runs a homogeneous-model client fleet as one batched program per
    round. Per-client learning rates, step counts and sub-model masks are
    data, not program structure."""

    def __init__(self, model_cls, clients: Sequence[FleetClient], unit_specs,
                 use_kernels: bool = False, device="cuda"):
        self.model_cls = model_cls
        self.clients = list(clients)
        self.unit_specs = unit_specs
        self.use_kernels = bool(use_kernels)
        self.device = torch.device(device)
        if not self.clients:
            raise ValueError("FleetEngine needs at least one client")
        if self.use_kernels and not hasattr(model_cls, "apply_kernels"):
            raise ValueError(
                f"use_kernels=True needs a model exposing apply_kernels / "
                f"kernel_masks (see models/kernel_models.py); "
                f"{model_cls.__name__} does not")
        # batch dim pads to the cohort max; smaller shards get sample weights
        self.bs = max(c.eff_batch_size for c in self.clients)
        self.client_steps = np.array(
            [c.local_epochs * (c.n_samples // c.eff_batch_size)
             for c in self.clients], np.int32)
        self.steps = int(self.client_steps.max())
        self.lrs = np.array([c.lr for c in self.clients], np.float32)
        if self.use_kernels:
            self._loss = make_weighted_kernel_loss(model_cls)
        else:
            one = make_weighted_loss(model_cls)
            self._loss = lambda w, xb, yb, wb: torch.stack(
                [one(tree_map(lambda a: a[c], w), xb[c], yb[c], wb[c])
                 for c in range(xb.shape[0])])
        self._ones_mask: Optional[dict] = None
        self._bank_cache = None        # (fingerprint, bank, idx, n_by_row)

    # ------------------------------------------------------------- internals
    def _stacked_data(self, n_steps: Optional[np.ndarray] = None):
        """(xs, ys, sw) on the device: per-client epoch batches padded to
        (steps, bs); sw is 1.0 on real samples, 0.0 on batch/step padding.
        Built on the host, consuming each client's RNG as the reference
        does, and moved to the device in one copy each. n_steps (C,) caps
        each client's real SGD steps by zero-weighting the tail."""
        C = len(self.clients)
        feat = self.clients[0].x.shape[1:]
        xs = np.zeros((C, self.steps, self.bs, *feat),
                      self.clients[0].x.dtype)
        ys = np.zeros((C, self.steps, self.bs), np.int64)
        sw = np.zeros((C, self.steps, self.bs), np.float32)
        for i, c in enumerate(self.clients):
            x, y = c.local_batches()
            s, b = x.shape[0], x.shape[1]
            xs[i, :s, :b] = x
            ys[i, :s, :b] = y
            sw[i, :s, :b] = 1.0
            if n_steps is not None:
                sw[i, int(n_steps[i]):] = 0.0
        to = functools.partial(torch.as_tensor, device=self.device)
        return to(xs), to(ys), to(sw)

    def _mask_bank(self, params, keep_maps: Dict[int, dict]):
        """(bank, idx, n_params_by_row): all-ones row 0 + one row per
        *distinct* straggler keep-map; idx maps client position -> bank row.
        Cached across rounds while the keep-maps are unchanged."""
        km_fp = {cid: tuple((g, kept.tobytes())
                            for g, kept in sorted(km.items()))
                 for cid, km in keep_maps.items()}
        fp = tuple(sorted(km_fp.items()))
        if self._bank_cache is not None and self._bank_cache[0] == fp:
            return self._bank_cache[1:]
        if self._ones_mask is None:
            self._ones_mask = tree_map(
                lambda p: torch.ones(p.shape, dtype=torch.float32,
                                     device=p.device), params)
        bank_obj = MaskBank(self._ones_mask, device=self.device)
        row_of = {cid: bank_obj.row_for(
            km_fp[cid],
            functools.partial(sub.keep_mask, params, self.unit_specs,
                              keep_maps[cid]))
            for cid in sorted(keep_maps)}
        bank = bank_obj.stacked()
        idx = torch.tensor([row_of.get(c.id, 0) for c in self.clients],
                           dtype=torch.int64, device=self.device)
        # exact integer param counts per row, int64 across leaves
        n_by_row = sum(b.reshape(b.shape[0], -1).sum(1, dtype=torch.int64)
                       .cpu().numpy() for b in tree_leaves(bank))
        self._bank_cache = (fp, bank, idx, n_by_row)
        return bank, idx, n_by_row

    def _run(self, params, bank, idx, xs, ys, sw, lrs):
        """Masked local SGD for the whole cohort; returns the (C, ...)
        mask-zeroed deltas."""
        m = tree_map(lambda b: b[idx], bank)
        w0 = sub.apply_mask(tree_map(lambda p: p[None], params), m)
        loss = self._loss
        if self.use_kernels:
            loss = functools.partial(loss, kmasks=self.model_cls.kernel_masks(m))
        w = tree_map(lambda a: a.clone().requires_grad_(True), w0)
        leaves, masks = tree_leaves(w), tree_leaves(m)
        lr_of = [lrs.reshape((-1,) + (1,) * (a.ndim - 1)) for a in leaves]
        for s in range(self.steps):
            loss(w, xs[:, s], ys[:, s], sw[:, s]).sum().backward()
            with torch.no_grad():
                for a, mk, lr in zip(leaves, masks, lr_of):
                    a -= lr * mk * a.grad
                    a.grad = None
        with torch.no_grad():
            return tree_map(lambda a, b: a.detach() - b, w, w0)

    def _execute(self, params, bank, idx, xs, ys, sw, lrs, weights):
        """Run the cohort program. Returns (deltas, extra): extra is None
        here; the sharded engine (fl/shard_fleet.py) returns its shards'
        aggregation partials."""
        return self._run(params, bank, idx, xs, ys, sw, lrs), None

    def _wrap_result(self, extra, **kw) -> CohortResult:
        return CohortResult(**kw)

    # ------------------------------------------------------------------- API
    def run_cohort(self, params, keep_maps: Dict[int, dict],
                   rates: Optional[Dict[int, float]] = None,
                   lr=None, n_steps=None, members=None) -> CohortResult:
        """One FL round for the whole fleet: keep_maps/rates per straggler
        client id (absent => full model).

        lr: optional scalar or (C,) array overriding the clients' learning
        rates; n_steps: optional (C,) ints capping each client's real SGD
        steps. Both are data: the program is the same.

        members: optional (C,) bool marking which slots are real clients,
        for callers that keep the cohort capacity-padded while dispatching
        fewer (fl/async_rounds.py pads every dispatch group to buffer_k). A
        padding slot runs 0 SGD steps (all its sample weights are zero, so
        its delta is exactly zero), carries zero aggregation weight, draws
        no sim time, and is left out of the stats and updates()."""
        rates = rates or {}
        C = len(self.clients)
        if lr is None:
            lrs = self.lrs
        else:
            lrs = np.broadcast_to(np.asarray(lr, np.float32), (C,))
        if n_steps is not None:
            n_steps = np.asarray(n_steps, np.int32)
            if n_steps.shape != (C,):
                raise ValueError(f"n_steps must be ({C},), "
                                 f"got {n_steps.shape}")
        if members is not None:
            members = np.asarray(members, bool)
            if members.shape != (C,):
                raise ValueError(f"members must be ({C},), "
                                 f"got {members.shape}")
            base_steps = self.client_steps if n_steps is None else n_steps
            n_steps = np.where(members, base_steps, 0).astype(np.int32)
        xs, ys, sw = self._stacked_data(n_steps)
        bank, idx, n_by_row = self._mask_bank(params, keep_maps)
        w_host = np.asarray([c.n_samples for c in self.clients], np.float32)
        if members is not None:
            w_host = np.where(members, w_host, 0.0).astype(np.float32)
        weights = torch.as_tensor(w_host, device=self.device)
        deltas, extra = self._execute(
            params, bank, idx, xs, ys, sw,
            torch.tensor(lrs, dtype=torch.float32, device=self.device),
            weights)
        idx_host = idx.cpu().numpy()
        sim_times = {c.id: c.draw_sim_time(rates.get(c.id, 1.0),
                                           int(n_by_row[idx_host[i]]))
                     for i, c in enumerate(self.clients)
                     if members is None or members[i]}
        return self._wrap_result(
            extra, engine=self, deltas=deltas, weights=weights,
            mask_bank=bank, mask_idx=idx,
            client_ids=[c.id for c in self.clients], sim_times=sim_times,
            straggler_ids=frozenset(keep_maps), members=members)
