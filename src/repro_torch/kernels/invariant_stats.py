"""Per-neuron relative-update statistic (port of
``repro/kernels/invariant_stats.py``).

``invariant_stats`` dispatches on where its tensors lie: on a CUDA tensor
it launches the hand-written kernels in ``csrc/invariant_stats.cu`` (which
replace the Pallas ``_kernel``: slab partials, then a fixed-order sum) and
counts the launch; on a CPU tensor it runs ``invariant_stats_plain``, on
a meta tensor the launch's checks and then ``invariant_stats_plain``.
There is no fallback from the card to the plain version. Like the
reference's, it is an entry point that no main path calls: the server's
calibration computes its statistic over several leaves in plain torch
(``core/invariant.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

EPS = 1e-8
SLAB_ROWS = 32                 # csrc/invariant_stats.cu SLAB

launches = _build.LaunchCounter()


def invariant_stats_plain(w0, w1):
    """Plain version (``repro/kernels/ref.py::invariant_stats_ref``):
    (d_in, n) -> (n,) fp32 ||W1[:,j] - W0[:,j]|| / (||W0[:,j]|| + eps)."""
    w0, w1 = w0.float(), w1.float()
    num = torch.sqrt(torch.sum(torch.square(w1 - w0), dim=0))
    den = torch.sqrt(torch.sum(torch.square(w0), dim=0))
    return num / (den + EPS)


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.invariant_stats_launch.argtypes = [p] * 4 + [i] * 3 + [p]
    lib.invariant_stats_launch.restype = i


_build.register_binding("invariant_stats", _bind)


def _check(w0, w1):
    """The launch's refusals (a ValueError)."""
    dtype, dev = w0.dtype, w0.device
    if dtype not in _build.DTYPE_CODE:
        raise ValueError(f"invariant_stats kernel takes {list(_build.DTYPE_CODE)}, got {dtype}")
    _build.check_operand("w0", w0, dtype, dev)
    _build.check_operand("w1", w1, dtype, dev)


def _launch(w0, w1):
    d_in, n = w0.shape
    dtype, dev = w0.dtype, w0.device
    slabs = -(-d_in // SLAB_ROWS)
    partials = torch.empty((2, slabs, n), dtype=torch.float32, device=dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    err = _build.load("invariant_stats").invariant_stats_launch(
        w0.data_ptr(), w1.data_ptr(), partials.data_ptr(), out.data_ptr(), d_in, n,
        _build.DTYPE_CODE[dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"invariant_stats kernel launch failed: CUDA error {err}")
    launches.n += 1
    return out


def invariant_stats(w0, w1):
    """w0, w1: (d_in, n), same shape and dtype. Returns (n,) fp32, the sums
    taken in fp32. CUDA tensors launch the kernel, CPU tensors run the
    plain version, meta tensors take the launch's checks and then the plain
    version."""
    if w0.ndim != 2 or w0.shape != w1.shape or w0.numel() == 0:
        raise ValueError(f"w0, w1 must be one non-empty (d_in, n) shape, got "
                         f"{tuple(w0.shape)} and {tuple(w1.shape)}")
    if w0.dtype != w1.dtype:
        raise ValueError(f"w0, w1 must share a dtype, got {w0.dtype} and {w1.dtype}")
    if _build.checked_as_card(w0):
        _check(w0, w1)
    if _build.runs_plain(w0):
        return invariant_stats_plain(w0, w1)
    return _launch(w0, w1)
