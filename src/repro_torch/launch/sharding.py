"""The step routes of ``repro/launch/sharding.py`` that mean something on
one card: the train step's kernel switch and the decode step's two math
routes.

``train_kernels_context(ffn=True)`` routes the train step's masked FFN
through the differentiable training kernels (``models/layers.apply_ffn``).
The reference's ``interpret`` flag has no counterpart: a tensor on the card
launches the kernels, one on the CPU runs their plain versions. The switch
is process-wide, not per thread: autograd runs a CUDA backward, and with
it a block-remat recompute, on its own device threads.

``decode_cache_context("seq")`` and ``uniform_pos_context(True)`` keep the
reference's thread-local idiom. On a mesh they pin the KV cache's sequence
axis to the model axis and make the cache write one dynamic-update-slice;
on one card they only select math routes of ``models/attention.attn_decode``
(the grouped attention ``_sdpa_grouped`` in place of the flash-decode
kernel, and one slot written for every row). The reference's mesh, pspec
and parameter-sharding rules (and ``launch/mesh.py``) have no counterpart:
the port's dry-run runs the step on the meta device (``launch/dryrun.py``),
where the reference lowers it on a mesh of placeholder devices.
"""
from __future__ import annotations

import contextlib
import threading

_TRAIN_KERNELS = {"ffn": False}
_STATE = threading.local()


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


def decode_cache_mode() -> str:
    """'auto' (the default: decode attention through the flash-decode
    kernel) or 'seq' (the reference's sequence-sharded cache: the grouped
    attention ``_sdpa_grouped``, which never expands K/V to the query
    heads)."""
    return getattr(_STATE, "decode_cache", "auto")


@contextlib.contextmanager
def decode_cache_context(mode: str):
    if mode not in ("auto", "seq"):
        raise ValueError(f"decode cache mode must be 'auto' or 'seq', got {mode!r}")
    prev = decode_cache_mode()
    _STATE.decode_cache = mode
    try:
        yield
    finally:
        _STATE.decode_cache = prev


def uniform_pos() -> bool:
    """True => all rows decode at the same position (a synchronized batch):
    the new K/V go to slot pos[0] % C of every row, one slot write."""
    return getattr(_STATE, "uniform_pos", False)


@contextlib.contextmanager
def uniform_pos_context(on: bool):
    prev = uniform_pos()
    _STATE.uniform_pos = on
    try:
        yield
    finally:
        _STATE.uniform_pos = prev
