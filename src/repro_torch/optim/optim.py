"""SGD, SGD with momentum and AdamW over the port's params trees (port of
``repro/optim/optim.py``), with the reference's defaults and dtypes.

``update(grads, state, params, lr) -> (params, state)`` keeps the
reference's signature but updates in place and returns the same tensors:
the reference's functional update would hold a second copy of every param
and moment (50 GB more for StableLM-2-12B on 8 layers). The arithmetic is
the reference's, operation for operation (AdamW's on the card in one
kernel a leaf, ``kernels/adamw.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import adamw as adamw_kernel


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable   # (grads, state, params, lr) -> (params, state), in place


def _zeros_like_tree(params, dtype=None):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype), params)


def _leaves(*trees):
    return zip(*(tree_leaves(t) for t in trees))


def sgd():
    def init(params):
        return {}

    @torch.no_grad()
    def update(grads, state, params, lr):
        for p, g in _leaves(params, grads):
            p.sub_(g.to(p.dtype).mul(lr))
        return params, state
    return Optimizer("sgd", init, update)


def sgdm(momentum=0.9):
    """The momentum buffer keeps the *param* dtype, as the reference's."""
    def init(params):
        return {"m": _zeros_like_tree(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        for p, m, g in _leaves(params, state["m"], grads):
            m.mul_(momentum).add_(g.to(m.dtype))
            p.sub_(m.to(p.dtype).mul(lr))
        return params, state
    return Optimizer("sgdm", init, update)


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
    """m and v in fp32, the step count ``t`` an int32 scalar on the params'
    device, the bias corrections computed in fp32 there (no host sync).
    Each leaf's step is ``kernels/adamw.adamw_update``: one hand-written
    kernel launch on the card, the plain chain on the CPU, the same bits."""
    def init(params):
        dev = tree_leaves(params)[0].device
        return {"m": _zeros_like_tree(params, torch.float32),
                "v": _zeros_like_tree(params, torch.float32),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        t = state["t"].add_(1).float()
        bc1, bc2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
        for p, m, v, g in _leaves(params, state["m"], state["v"], grads):
            adamw_kernel.adamw_update(p, g, m, v, bc1, bc2, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay, lr=lr)
        return params, state
    return Optimizer("adamw", init, update)


_FACTORIES = {"sgd": sgd, "sgdm": sgdm, "adamw": adamw}


def make_optimizer(name: str) -> Optimizer:
    return _FACTORIES[name]()


def init_opt(name: str, params):
    return make_optimizer(name).init(params)


def opt_update(name: str, grads, state, params, lr):
    return make_optimizer(name).update(grads, state, params, lr)
