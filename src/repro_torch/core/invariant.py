"""Invariant-neuron statistics and drop-threshold calibration (paper §4, §5).

Port of ``repro/core/invariant.py``, in torch fp32 on whatever device the
params lie on. A neuron's update statistic for one client is

    g_i = ||w(t) - w(t-1)|| / (||w(t-1)|| + eps)

over every weight that produces it. A neuron is *invariant* at threshold th
when g_i <= th for the strict majority of non-straggler clients. The
initial threshold is the client-average of the per-client minimum stat; it
grows geometrically until enough neurons are invariant (Algorithm 1, lines
9 and 22). Comparisons with th happen in fp32, as in the reference.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

EPS = 1e-8
TH_GROWTH = 1.25


def _get(tree, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _per_unit(arr, axis, tile, size, lead=0):
    """Group an array's producer weights by unit: -> (*lead axes, size, -1).

    Mirrors submodel.expand_indices' grammar: tile>0 is tile-major (unit
    index fastest along the axis), tile<0 is unit-major (each unit owns
    |tile| contiguous slots — the attention-head layout). ``lead`` leading
    axes (a stacked client axis) stay in front."""
    a = torch.movedim(arr, axis + lead, lead)
    front = a.shape[:lead]
    if tile < 0:
        return a.reshape(*front, size, -1)
    return (a.reshape(*front, tile, size, -1).transpose(lead, lead + 1)
            .reshape(*front, size, -1))


def neuron_stats_for_group(prev_tree, new_tree, group,
                           kind: str = "norm") -> torch.Tensor:
    """Per-neuron relative update statistic over the group's producers.

    kind="norm" (default): ||Δw|| / (||w(t-1)|| + eps) per neuron.
    kind="max": the per-weight max of |Δw| / (|w(t-1)| + eps) (dominated by
    near-zero weights; the reference keeps it for ablation). Returns
    (size,) float32; (C, size) when new_tree's leaves carry a leading
    client axis over prev_tree's (C clients' new trees stacked, as the
    fleet's are), each row the statistic of one client."""
    size = group["size"]
    dev = _get(prev_tree, group["out"][0][0]).device
    if kind == "max":
        stats = torch.zeros((size,), dtype=torch.float32, device=dev)
        for path, axis, tile in group["out"]:
            w0 = _get(prev_tree, path).float()
            w1 = _get(new_tree, path).float()
            rel = (w1 - w0).abs() / (w0.abs() + EPS)
            lead = w1.ndim - w0.ndim
            stats = torch.maximum(stats,
                                  _per_unit(rel, axis, tile, size, lead).amax(-1))
        return stats
    num = torch.zeros((size,), dtype=torch.float32, device=dev)
    den = torch.zeros((size,), dtype=torch.float32, device=dev)
    for path, axis, tile in group["out"]:
        w0 = _get(prev_tree, path).float()
        w1 = _get(new_tree, path).float()
        lead = w1.ndim - w0.ndim
        num = num + _per_unit(torch.square(w1 - w0), axis, tile, size,
                              lead).sum(-1)
        den = den + _per_unit(torch.square(w0), axis, tile, size).sum(1)
    return torch.sqrt(num) / (torch.sqrt(den) + EPS)


def neuron_stats(prev_tree, new_tree, unit_specs,
                 kind: str = "norm") -> Dict[str, torch.Tensor]:
    """{group: neuron_stats_for_group}: (size,) per group, or (C, size)
    for a stacked new_tree."""
    return {g["name"]: neuron_stats_for_group(prev_tree, new_tree, g, kind)
            for g in unit_specs}


def initial_threshold(per_client_stats: Sequence[Dict[str, torch.Tensor]]):
    """Average over clients of the min percent-update over all neurons."""
    mins = [torch.cat([v.reshape(-1) for v in cs.values()]).min()
            for cs in per_client_stats]
    return float(torch.stack(mins).mean())


def invariant_counts(per_client_stats, th: float) -> Dict[str, np.ndarray]:
    """Per group: #clients (int32) for which each neuron is below th."""
    out = {}
    for g in per_client_stats[0]:
        votes = torch.stack([cs[g] <= th for cs in per_client_stats])
        out[g] = votes.sum(dim=0).to(torch.int32).cpu().numpy()
    return out


def mean_stats(per_client_stats) -> Dict[str, np.ndarray]:
    return {g: torch.stack([cs[g] for cs in per_client_stats]).mean(dim=0)
            .cpu().numpy()
            for g in per_client_stats[0]}


def invariant_mask(per_client_stats, th: float) -> Dict[str, np.ndarray]:
    """Neurons invariant for the strict majority of clients."""
    n = len(per_client_stats)
    return {g: c > n / 2
            for g, c in invariant_counts(per_client_stats, th).items()}


def count_invariant(per_client_stats, th: float) -> int:
    return int(sum(v.sum() for v in invariant_mask(per_client_stats,
                                                   th).values()))


def calibrate_threshold(per_client_stats, n_drop_target: int, th0: float,
                        max_iters: int = 200) -> float:
    """Increment th until #invariant >= n_drop_target (Algorithm 1 l.22)."""
    th = max(float(th0), EPS)
    for _ in range(max_iters):
        if count_invariant(per_client_stats, th) >= n_drop_target:
            return th
        th *= TH_GROWTH
    return th


def calibrate_threshold_per_group(per_client_stats,
                                  drop_targets: Dict[str, int], th0: float,
                                  max_iters: int = 200) -> Dict[str, float]:
    """Per-layer thresholds (paper: 'FLuID can have a different drop
    threshold for each layer'): calibrate_threshold on each group alone."""
    return {g: calibrate_threshold([{g: cs[g]} for cs in per_client_stats],
                                   target, th0, max_iters)
            for g, target in drop_targets.items()}
