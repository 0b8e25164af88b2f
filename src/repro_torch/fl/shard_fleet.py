"""Sharded cohort executor on one card (port of ``repro/fl/shard_fleet.py``).

The reference splits the cohort into S logical shards of equal size and
runs them under ``shard_map`` over a mesh's data axis: each device runs its
shards through the identical cohort program, reduces each shard to the
masked-FedAvg sufficient statistics (``core/aggregate.partial_sums``), and
a psum finishes the hierarchical aggregation.

On one card there is no mesh, so the shard axis is a Python loop over
contiguous client ranges ``[s*Cs, (s+1)*Cs)``: each shard runs the fleet's
cohort program (``FleetEngine._run``, through the kernels when
``use_kernels``), and its partials are kept as ``shard_partials``. ``num``
and ``w_per_mask`` are the shards' partials added in a fixed left-to-right
chain and ``aggregate`` applies them with ``combine_partials``, with no
second pass over the deltas. That is the reference's numerics contract:
the logical shard count S is part of the numerical program, the
per-shard reduction is the fleet's, and the cross-shard sum is a fixed
chain (the reference's local chain plus a psum, which on one device is
the plain chain). S defaults to 1, the reference's
``gcd(cohort, devices)`` on one device; results for different S agree
with the unsharded fleet up to float summation order.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from repro_torch.core.aggregate import combine_partials, partial_sums
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.fl.client import FleetClient
from repro_torch.fl.fleet import CohortResult, FleetEngine


def _tree_add(t1, t2):
    return tree_map(torch.add, t1, t2)


@dataclass
class ShardedCohortResult(CohortResult):
    """CohortResult + the hierarchically reduced aggregation partials."""
    num: Optional[dict] = None                 # tree of param-shaped sums
    w_per_mask: Optional[torch.Tensor] = None  # (K,)
    shard_partials: Optional[tuple] = None     # ((S, ...) num, (S, K) w)

    def aggregate(self, global_params):
        """Apply the reduced partials (core/aggregate.combine_partials): no
        second pass over the (C, ...) deltas."""
        return combine_partials(global_params, self.num, self.w_per_mask,
                                self.mask_bank)


class ShardedFleetEngine(FleetEngine):
    """FleetEngine whose cohort runs as S equal shards, reduced
    hierarchically.

    n_shards: the logical shard count S (default 1). S must divide the
    cohort; shard s holds clients [s*Cs, (s+1)*Cs) in client order."""

    def __init__(self, model_cls, clients: Sequence[FleetClient], unit_specs,
                 n_shards: Optional[int] = None, use_kernels: bool = False,
                 device="cuda"):
        super().__init__(model_cls, clients, unit_specs,
                         use_kernels=use_kernels, device=device)
        n_shards = 1 if n_shards is None else int(n_shards)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        c = len(self.clients)
        if c % n_shards:
            raise ValueError(
                f"cohort size {c} must divide evenly into n_shards="
                f"{n_shards} (equal shards keep one compiled shape)")
        self.n_shards = n_shards

    def _execute(self, params, bank, idx, xs, ys, sw, lrs, weights):
        s, cs = self.n_shards, len(self.clients) // self.n_shards
        k = tree_leaves(bank)[0].shape[0]
        ds, parts = [], []
        for i in range(s):
            sl = slice(i * cs, (i + 1) * cs)
            d = self._run(params, bank, idx[sl], xs[sl], ys[sl], sw[sl],
                          lrs[sl])
            parts.append(partial_sums(d, weights[sl], idx[sl], k))
            ds.append(d)
        deltas = tree_map(lambda *a: torch.cat(a), *ds)
        stacked = tree_map(lambda *a: torch.stack(a), *parts)
        num, wpm = functools.reduce(_tree_add, parts)   # fixed chain
        return deltas, (num, wpm, stacked)

    def _wrap_result(self, extra, **kw) -> ShardedCohortResult:
        num, wpm, pr = extra
        return ShardedCohortResult(num=num, w_per_mask=wpm,
                                   shard_partials=pr, **kw)
