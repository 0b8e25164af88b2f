"""Sub-models over unit-spec'd param trees (port of ``repro/core/submodel.py``).

keep_mask():    dense 0/1 participation mask in full-model coordinates —
                what the fleet trains with (forward(mask * params) equals
                forward(extract(params)) on the kept coordinates).
apply_mask():   zero the dropped coordinates.
extract():      gather the kept rows/cols into a smaller tree.
embed_delta():  scatter a sub-model delta back into full coordinates, with
                its participation mask.

Tile factors expand kept neuron indices into structured axes; see
``expand_indices`` for the grammar.
"""
from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map


def _get(tree, path):
    node = tree
    for p in path.split("/"):
        node = node[p]
    return node


def _set(tree, path, value):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def expand_indices(keep: np.ndarray, tile: int, size: int) -> np.ndarray:
    """Kept unit indices -> kept axis indices.

    tile > 0 (tile-major): {t*size + i : t < tile, i in keep}.
    tile < 0 (unit-major): {i*|tile| + t : i in keep, t < |tile|} — each
    unit owns |tile| contiguous slots (the attention-head layout)."""
    if tile == 1:
        return keep
    if tile < 0:
        t = -tile
        return (keep[:, None] * t + np.arange(t)[None, :]).reshape(-1)
    return (np.arange(tile)[:, None] * size + keep[None, :]).reshape(-1)


def _axis_indices(unit_specs, keep_map) -> Dict[str, Dict[int, np.ndarray]]:
    """path -> {axis: kept index array}."""
    out: Dict[str, Dict[int, np.ndarray]] = {}
    for g in unit_specs:
        keep = np.asarray(keep_map[g["name"]])
        for role in ("out", "in"):
            for path, axis, tile in g[role]:
                idx = expand_indices(keep, tile, g["size"])
                axes = out.setdefault(path, {})
                # same array referenced twice on one axis: intersect
                axes[axis] = (np.intersect1d(axes[axis], idx)
                              if axis in axes else idx)
    return out


def _kept_grid(target, axes):
    """Open index grid of the kept coordinates of ``target``."""
    idxs = [torch.arange(n, device=target.device) for n in target.shape]
    for axis, idx in axes.items():
        idxs[axis] = torch.as_tensor(np.asarray(idx), device=target.device)
    return torch.meshgrid(*idxs, indexing="ij")


def extract(params, unit_specs, keep_map):
    """Gather the sub-model. Returns a new tree."""
    sub = copy.deepcopy(tree_map(lambda x: x, params))
    for path, axes in _axis_indices(unit_specs, keep_map).items():
        arr = _get(sub, path)
        for axis, idx in sorted(axes.items()):
            arr = torch.index_select(
                arr, axis, torch.as_tensor(np.asarray(idx), device=arr.device))
        _set(sub, path, arr)
    return sub


def keep_mask(full_like, unit_specs, keep_map):
    """Dense float32 0/1 participation mask in full-model coordinates: 1.0
    on the kept rows/cols of every array a group touches, and on every
    array no group touches (transferred whole, fully trained)."""
    mask = tree_map(lambda x: torch.ones_like(x, dtype=torch.float32),
                    full_like)
    for path, axes in _axis_indices(unit_specs, keep_map).items():
        target = _get(full_like, path)
        m = torch.zeros(target.shape, dtype=torch.float32,
                        device=target.device)
        m[_kept_grid(target, axes)] = 1.0
        _set(mask, path, m)
    return mask


def apply_mask(params, mask):
    """Zero the dropped coordinates (broadcasts a stacked (C, ...) mask)."""
    return tree_map(lambda p, m: p * m.to(p.dtype), params, mask)


def embed_delta(sub_delta, full_like, unit_specs, keep_map):
    """Scatter a sub-model delta into full coordinates. Returns
    (full_delta, mask), mask == keep_mask for this keep_map."""
    full_delta = tree_map(
        lambda s, f: (s.to(f.dtype) if s.shape == f.shape
                      else torch.zeros_like(f)), sub_delta, full_like)
    mask = keep_mask(full_like, unit_specs, keep_map)
    for path, axes in _axis_indices(unit_specs, keep_map).items():
        target = _get(full_like, path)
        d = torch.zeros_like(target)
        d[_kept_grid(target, axes)] = _get(sub_delta, path).to(target.dtype)
        _set(full_delta, path, d)
    return full_delta, mask


def submodel_sizes(params, unit_specs, keep_map):
    """(#params sub, #params full) — the transfer/compute saving."""
    n_sub = sum(x.numel() for x in tree_leaves(extract(params, unit_specs,
                                                        keep_map)))
    return n_sub, sum(x.numel() for x in tree_leaves(params))
