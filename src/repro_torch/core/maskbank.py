"""Deduplicated mask bank (port of ``repro/core/maskbank.py``).

The serving engine stacks 0/1 masks into a bank of K *distinct* rows and
carries a per-request int row index into it, so mask memory scales with the
number of distinct sub-models, not the number of requests.

With ``capacity=K`` ``stacked()`` always returns K rows — unused tail rows
repeat row 0 (the all-ones full model) — so the bank's shape never changes
with admissions. When full, rows not referenced by any live request are
evicted in place. Row 0 is always the caller-supplied all-ones mask.

A mask pytree here is a list (per segment) of dicts (per unit layer) of
dicts (per masked key) of tensors, as ``transformer_hooks.full_masks``
builds it.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Iterable, List, Optional

import torch

from repro_torch.core.tree import tree_map

FULL_MODEL = "__full__"      # reserved fingerprint of row 0


class MaskBank:
    def __init__(self, ones_row, capacity: Optional[int] = None,
                 device="cuda"):
        if capacity is not None and capacity < 2:
            raise ValueError("capacity must allow row 0 plus one sub-model")
        self.capacity = capacity
        self.device = torch.device(device)
        self._rows: List = [ones_row]
        self._fp_of_row: List[Hashable] = [FULL_MODEL]
        self._row_of_fp: Dict[Hashable, int] = {FULL_MODEL: 0}
        self._stacked = None

    def __len__(self) -> int:
        return len(self._rows)

    def row(self, i: int):
        """Host-side mask pytree stored at row i."""
        return self._rows[i]

    def row_for(self, fp: Hashable, build: Callable[[], object],
                in_use: Iterable[int] = ()) -> int:
        """Bank row holding the mask fingerprinted ``fp``; built via
        ``build()`` on a miss. ``in_use`` rows are protected from eviction."""
        got = self._row_of_fp.get(fp)
        if got is not None:
            return got
        if self.capacity is not None and len(self._rows) >= self.capacity:
            return self._replace(self._evictable(in_use), fp, build)
        self._rows.append(build())
        self._fp_of_row.append(fp)
        self._row_of_fp[fp] = len(self._rows) - 1
        self._stacked = None
        return len(self._rows) - 1

    def _evictable(self, in_use: Iterable[int]) -> int:
        live = set(in_use) | {0}
        for r in range(1, len(self._rows)):
            if r not in live:
                return r
        raise RuntimeError(
            f"mask bank full: all {self.capacity} rows referenced by live "
            "requests — raise bank capacity or drain the batch first")

    def _replace(self, victim: int, fp, build) -> int:
        del self._row_of_fp[self._fp_of_row[victim]]
        self._rows[victim] = build()
        self._fp_of_row[victim] = fp
        self._row_of_fp[fp] = victim
        self._stacked = None
        return victim

    def stacked(self):
        """Bank on ``self.device``: pytree with (K, ...) leaves. With a
        capacity set, K == capacity always (tail padded with row 0)."""
        if self._stacked is None:
            rows = list(self._rows)
            if self.capacity is not None:
                rows += [self._rows[0]] * (self.capacity - len(rows))
            self._stacked = tree_map(
                lambda *ls: torch.stack(
                    [torch.as_tensor(x) for x in ls]).to(self.device), *rows)
        return self._stacked
