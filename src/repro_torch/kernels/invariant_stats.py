"""Per-neuron relative-update statistic (port of
``repro/kernels/invariant_stats.py``).

``invariant_stats`` dispatches on where its tensors lie: on a CUDA tensor
it launches the hand-written kernel in ``csrc/invariant_stats.cu`` (which
replaces the Pallas ``_kernel``: one launch, a thread-block cluster per
strip of columns whose blocks take slabs of rows and sum in a fixed order;
``launch_geometry`` says how a shape is cut) and counts the launch;
on a CPU tensor it runs ``invariant_stats_plain``, on a meta tensor the
launch's checks and then ``invariant_stats_plain``. There is no fallback
from the card to the plain version. Like the reference's, it is an entry
point that no main path calls: the server's calibration computes its
statistic over several leaves in plain torch (``core/invariant.py``).
"""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

import torch

from repro_torch.kernels import _build

EPS = 1e-8


def _source_constants(*names):
    """The values of ``constexpr int`` constants of csrc/invariant_stats.cu,
    read from the source, so that the geometry below cannot drift from it."""
    src = (Path(__file__).parent / "csrc" / "invariant_stats.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in names)


# threads a block, rows a thread has in flight, blocks of a cluster at most
THREADS, UNROLL, MAX_CLUSTER = _source_constants("THREADS", "UNROLL", "MAX_CLUSTER")
LANES_PER_ROW = (32, 16, 8)    # a row group's lanes, widest first

launches = _build.LaunchCounter()


def invariant_stats_plain(w0, w1):
    """Plain version (``repro/kernels/ref.py::invariant_stats_ref``):
    (d_in, n) -> (n,) fp32 ||W1[:,j] - W0[:,j]|| / (||W0[:,j]|| + eps)."""
    w0, w1 = w0.float(), w1.float()
    num = torch.sqrt(torch.sum(torch.square(w1 - w0), dim=0))
    den = torch.sqrt(torch.sum(torch.square(w0), dim=0))
    return num / (den + EPS)


def launch_geometry(d_in, n, elem, n_sm=132):
    """How the kernel cuts a (d_in, n) pair of elem-byte weights: ``vb``
    bytes a lane loads (the widest of 16, 8, 4, 2 that divides a row's
    bytes) and ``vec`` columns a lane; ``lpr`` lanes a row group, the
    widest of 32, 16, 8 that still gives the n_sm SMs a block each (else
    8), so ``groups`` row groups a block and ``cols`` columns a strip;
    ``strips``; ``cs`` blocks a cluster, a block per slab of ``rows`` rows
    (fewer than 8 where d_in is below 8 rounds of a block's rows)."""
    vb = next(w for w in (16, 8, 4, 2) if (n * elem) % w == 0)
    for lpr in LANES_PER_ROW:
        groups = THREADS // lpr
        cs = max(1, min(MAX_CLUSTER, -(-d_in // (groups * UNROLL))))
        cols = lpr * vb // elem
        strips = -(-n // cols)
        if strips * cs >= n_sm:
            break
    return {"vb": vb, "vec": vb // elem, "lpr": lpr, "groups": groups, "cols": cols,
            "strips": strips, "cs": cs, "rows": -(-d_in // cs)}


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.invariant_stats_launch.argtypes = [p] * 3 + [i] * 6 + [p]
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
    geo = launch_geometry(d_in, n, w0.element_size(), _build.sm_count(dev))
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    err = _build.load("invariant_stats").invariant_stats_launch(
        w0.data_ptr(), w1.data_ptr(), out.data_ptr(), d_in, n, _build.DTYPE_CODE[dtype],
        geo["vb"], geo["lpr"], geo["cs"], torch.cuda.current_stream(dev).cuda_stream)
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
