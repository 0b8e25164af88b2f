"""Bring the JAX reference's pytrees into the port, key for key.

The caller converts the reference's arrays to numpy first
(``jax.tree.map(np.asarray, tree)``); this module never sees a JAX array
and imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device``. With ``dtype``, matrices are cast to it and vectors (norm
    scales, biases, RWKV-6's mix_*, w_decay and w_u) keep their own type,
    as ``init_params`` stores them. A model's layers sit under "stack" with
    a leading repeat axis, so there a vector is (R, n)."""
    def conv(a, lead):
        t = torch.from_numpy(np.array(a)).to(device)
        return t.to(dtype) if dtype is not None and t.ndim - lead >= 2 else t
    if isinstance(tree, dict) and "stack" in tree:
        return {k: tree_map(lambda a, lead=int(k == "stack"): conv(a, lead), sub)
                for k, sub in tree.items()}
    return tree_map(lambda a: conv(a, 0), tree)


def masks_from_numpy(tree):
    """Mask pytree (list per segment of nested dicts) of numpy 0/1 arrays
    -> the same tree of host float32 tensors, as ``rate_masks`` builds."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)
