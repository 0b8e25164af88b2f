"""The train step's kernel switch (the part of ``repro/launch/sharding.py``
the port has so far; the mesh pieces come with the dry-run).

``train_kernels_context(ffn=True)`` routes the train step's masked FFN
through the differentiable training kernels (``models/layers.apply_ffn``).
The reference's ``interpret`` flag has no counterpart: a tensor on the card
launches the kernels, one on the CPU runs their plain versions. The switch
is process-wide, not per thread: autograd runs a CUDA backward, and with
it a block-remat recompute, on its own device threads.
"""
from __future__ import annotations

import contextlib

_TRAIN_KERNELS = {"ffn": False}


def train_kernel_flags() -> dict:
    """Which kernels the train step takes: {'ffn': bool}; off by default
    (the dense masked FFN)."""
    return dict(_TRAIN_KERNELS)


@contextlib.contextmanager
def train_kernels_context(ffn: bool = False):
    """Opt the train step into the masked-FFN training kernels while the
    context is open, the backward included."""
    prev = train_kernel_flags()
    _TRAIN_KERNELS["ffn"] = ffn
    try:
        yield
    finally:
        _TRAIN_KERNELS.update(prev)
