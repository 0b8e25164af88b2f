"""Masked FedAvg aggregation (paper Algorithm 1, line 16).

Port of ``repro/core/aggregate.py``. Clients return deltas (new -
broadcast); stragglers' deltas arrive in full coordinates with a
participation mask. Each element is averaged over the clients that trained
it, weighted by sample count:

    w_new = w + sum_c(n_c * mask_c * delta_c) / sum_c(n_c * mask_c)

The async buffer's form, ``aggregate_buffered``, discounts each arrival's
weight by ``staleness_scale`` before both sums.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.core.tree import tree_leaves, tree_map


@dataclass
class ClientUpdate:
    delta: dict                 # full-coordinate delta tree
    n_samples: int
    mask: Optional[dict] = None  # None = trained the full model
    sim_time: float = 0.0
    real_time: float = 0.0
    client_id: int = -1


def partial_sums(stacked_deltas, weights, mask_idx, num_masks: int):
    """The two sufficient statistics of masked FedAvg over (C, ...) stacked
    deltas: ``num = sum_c w_c * delta_c`` and ``w_per_mask[k] = sum of w_c
    over the clients on bank row k`` ((K,) float32)."""
    weights = weights.float()
    rows = torch.arange(num_masks, device=weights.device)
    w_per_mask = weights @ (mask_idx.long()[:, None] == rows).float()
    num = tree_map(lambda d: torch.tensordot(weights, d.float(), dims=1),
                   stacked_deltas)
    return num, w_per_mask


def combine_partials(global_params, num, w_per_mask, mask_bank):
    """w_new = w + num / (sum_k w_per_mask_k * bank_k) where den > 0."""
    den = tree_map(lambda b: torch.tensordot(w_per_mask, b, dims=1),
                   mask_bank)
    return tree_map(
        lambda p, n, d: p + torch.where(d > 0, n / torch.clamp(d, min=1e-12),
                                        torch.zeros_like(n)).to(p.dtype),
        global_params, num, den)


def aggregate_stacked(global_params, stacked_deltas, weights,
                      mask_bank, mask_idx):
    """Masked FedAvg over a stacked cohort (fl/fleet.py): deltas are
    already mask-zeroed, so the numerator is one weighted reduce and the
    denominator factors through the K distinct bank rows."""
    k = tree_leaves(mask_bank)[0].shape[0]
    num, w_per_mask = partial_sums(stacked_deltas, weights, mask_idx, k)
    return combine_partials(global_params, num, w_per_mask, mask_bank)


def staleness_scale(staleness, exponent):
    """Per-arrival staleness discount for buffered async FedAvg,
    normalized so a uniformly stale buffer is plain masked FedAvg:

        scale_i = (1 + s_i)^(-a) / max_j (1 + s_j)^(-a)

    s_i is the number of server versions between client i's dispatch and
    its arrival, ``a`` the exponent. The max-normalization gives two exact
    identities: an all-fresh buffer scales by exactly 1.0, and a uniformly
    stale one by x/x == 1.0. fp32; (C,) on the device of ``staleness``
    (numpy input lands on the CPU)."""
    s = torch.as_tensor(staleness, dtype=torch.float32)
    a = torch.as_tensor(exponent, dtype=torch.float32, device=s.device)
    raw = (1.0 + s) ** (-a)
    return raw / raw.max()


def aggregate_buffered(global_params, stacked_deltas, weights,
                       mask_bank, mask_idx, staleness, exponent):
    """``aggregate_stacked`` for an async arrival buffer
    (fl/async_rounds.py): each arrival's sample-count weight is scaled by
    ``staleness_scale`` before both the numerator and the per-mask
    denominator, so coordinates only a stale straggler trained still
    average to its (discounted) delta. With zero staleness the scaled
    weights equal ``weights`` bitwise and this is ``aggregate_stacked``."""
    scale = staleness_scale(staleness, exponent).to(weights.device)
    w = weights.float() * scale
    k = tree_leaves(mask_bank)[0].shape[0]
    num, w_per_mask = partial_sums(stacked_deltas, w, mask_idx, k)
    return combine_partials(global_params, num, w_per_mask, mask_bank)


def aggregate(global_params, updates: Sequence[ClientUpdate]):
    """Participation-weighted FedAvg over per-client updates."""
    num = tree_map(torch.zeros_like, global_params)
    den = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                         device=x.device), global_params)
    for u in updates:
        w = float(u.n_samples)
        if u.mask is None:
            num = tree_map(lambda a, d: a + w * d.to(a.dtype), num, u.delta)
            den = tree_map(lambda a: a + w, den)
        else:
            num = tree_map(lambda a, d, m: a + (w * m * d).to(a.dtype),
                           num, u.delta, u.mask)
            den = tree_map(lambda a, m: a + w * m, den, u.mask)
    return tree_map(
        lambda p, n, d: p + torch.where(d > 0, n / torch.clamp(d, min=1e-12),
                                        torch.zeros_like(n)).to(p.dtype),
        global_params, num, den)
