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
    ``device``. With ``dtype``, matrices (ndim >= 2) are cast to it and
    vectors (norm scales, biases) keep their own type."""
    def conv(a):
        t = torch.from_numpy(np.array(a)).to(device)
        return t.to(dtype) if dtype is not None and t.ndim >= 2 else t
    return tree_map(conv, tree)


def masks_from_numpy(tree):
    """Mask pytree (list per segment of nested dicts) of numpy 0/1 arrays
    -> the same tree of host float32 tensors, as ``rate_masks`` builds."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)
