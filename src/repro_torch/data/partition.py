"""Client data partitioning: writer-based non-IID (LEAF style) and IID.

A numpy copy of ``repro/data/partition.py``, bitwise equal for a seed."""
from __future__ import annotations

import numpy as np


def partition_non_iid(ds, n_clients: int, seed: int = 0):
    """Group examples by writer/role, assign writers to clients (LEAF style)."""
    rng = np.random.RandomState(seed)
    writers = np.unique(ds.writer)
    rng.shuffle(writers)
    buckets = [[] for _ in range(n_clients)]
    for i, w in enumerate(writers):
        buckets[i % n_clients].append(w)
    out = []
    for ws in buckets:
        idx = np.where(np.isin(ds.writer, ws))[0]
        rng.shuffle(idx)
        out.append(idx)
    return out


def partition_iid(ds, n_clients: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(ds.y))
    return np.array_split(idx, n_clients)
