"""Bring the JAX reference's pytrees into the port, key for key.

The caller converts the reference's arrays to numpy first
(``jax.tree.map(np.asarray, tree)``); this module never sees a JAX array
and imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map


# leaves kept in their own type under a ``dtype``, though two-dimensional:
# the attention projections' per-head bias vectors (H, hd), and an MoE
# router (d, E), fp32 in the reference whatever param_dtype is
KEEP_TYPE = ("bq", "bk", "bv", "bo", "router")


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device``. With ``dtype``, matrices are cast to it and vectors (norm
    scales, biases, the attention's per-head biases, RWKV-6's mix_*,
    w_decay and w_u, MLA's q_norm and kv_norm, RG-LRU's a_param, w_a, b_a,
    w_i, b_i and conv_b) and an MoE router keep their own type, as
    ``init_params`` stores them. RG-LRU's conv_w (K, w) is a matrix in
    both: it is used in the compute dtype, so storing it cast gives the
    same numbers. A model's layers sit under "stack" with a leading repeat
    axis (the encoder–decoder's 'enc' and 'dec' stacks too), so there a
    vector is (R, n). The tensors own their memory, on the CPU too: they
    never alias the caller's arrays."""
    def conv(a, lead, name):
        # np.array copies: the tensors never share the caller's buffers (an
        # in-place optimizer step would write into them, and into a JAX
        # array that aliases the same numpy buffer on the CPU)
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":         # ml_dtypes' bf16 (Arctic's params)
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
        else:
            t = torch.from_numpy(a).to(device)
        matrix = t.ndim - lead >= 2 and name not in KEEP_TYPE
        return t.to(dtype) if dtype is not None and matrix else t

    def walk(sub, lead, name=None):
        if isinstance(sub, dict):
            return {k: walk(v, lead, k) for k, v in sub.items()}
        return conv(sub, lead, name)
    if isinstance(tree, dict) and "stack" in tree:
        return {k: walk(sub, int(k == "stack")) for k, sub in tree.items()}
    return walk(tree, 0)


def masks_from_numpy(tree):
    """Mask pytree of numpy 0/1 arrays -> the same tree of host float32
    tensors, as ``rate_masks`` and ``build_masks`` build: a list per
    segment of nested dicts ('ffn', an MoE layer's 'moe' and 'experts'),
    or an encoder–decoder's {'enc': {'ffn'}, 'dec': {'ffn'}}."""
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)
