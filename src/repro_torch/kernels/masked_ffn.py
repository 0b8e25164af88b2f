"""Per-row-masked FFN forward (port of ``repro/kernels/masked_ffn.py``).

    y = (act(x @ W_in) [* act(x @ W_gate)] ⊙ row_mask) @ W_out

``masked_ffn_batch`` dispatches on where its tensors lie: on a CUDA tensor
it launches the hand-written kernel in ``csrc/masked_ffn.cu`` (which
replaces the Pallas ``_fwd_kernel``) and counts the launch; on a CPU tensor
it runs ``masked_ffn_batch_plain``. There is no fallback from the card to
the plain version. The block-mask ``masked_ffn`` and the backward kernels
(``_dx_kernel``, ``_dw_kernel``) come with the training slice.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

BLOCK_NEURONS = 128

_ACTS = {"relu": torch.relu,
         "relu2": lambda h: torch.square(torch.relu(h)),
         "gelu": lambda h: F.gelu(h, approximate="tanh"),
         "silu": F.silu}
_ACT_CODE = {"relu": 0, "relu2": 1, "gelu": 2, "silu": 3}   # csrc/masked_ffn.cu

launches = _build.LaunchCounter()


def _validate(x, w_in, w_out, w_gate, mask):
    """The reference's ValueErrors (per-row form), word for word."""
    if x.ndim != 2:
        raise ValueError(f"x must be (M, d), got shape {tuple(x.shape)}")
    M, d = x.shape
    if w_in.ndim != 2 or w_in.shape[0] != d:
        raise ValueError(f"w_in must be (d={d}, F), got {tuple(w_in.shape)}")
    Fh = w_in.shape[1]
    if Fh % BLOCK_NEURONS != 0:
        raise ValueError(
            f"masked FFN hidden dim F={Fh} must be a multiple of "
            f"BLOCK_NEURONS={BLOCK_NEURONS}; pad w_in/w_out (and the mask) "
            f"to 128 alignment — anything else would mis-tile the block "
            f"skip (DESIGN.md §10)")
    if tuple(w_out.shape) != (Fh, d):
        raise ValueError(f"w_out must be (F={Fh}, d={d}), got {tuple(w_out.shape)}")
    if w_gate is not None and tuple(w_gate.shape) != (d, Fh):
        raise ValueError(f"w_gate must be (d={d}, F={Fh}), got {tuple(w_gate.shape)}")
    if tuple(mask.shape) != (M, Fh):
        raise ValueError(
            f"row_mask must be (M={M}, F={Fh}) — one 0/1 neuron mask per "
            f"row of x — got {tuple(mask.shape)}")


def masked_ffn_batch_plain(x, w_in, w_out, row_mask, w_gate=None, act="silu"):
    """Plain version of the kernel's arithmetic: fp32 products, hidden
    activations times each row's own (M, F) mask, rounded to x.dtype before
    the down product as the Pallas ``_fwd_kernel`` rounds them. In fp32 this
    is ``repro/kernels/ref.py::masked_ffn_batch_ref`` exactly."""
    xf = x.float()
    h = xf @ w_in.float()
    if w_gate is not None:
        h = _ACTS[act](xf @ w_gate.float()) * h
    else:
        h = _ACTS[act](h)
    h = (h * row_mask.float()).to(x.dtype)
    return (h.float() @ w_out.float()).to(x.dtype)


def _launch(x, w_in, w_out, row_mask, w_gate, act):
    dtype, dev = x.dtype, x.device
    if dtype not in _build.DTYPE_CODE:
        raise ValueError(f"masked_ffn_batch kernel takes {list(_build.DTYPE_CODE)}, "
                         f"got {dtype}")
    M, d = x.shape
    Fh = w_in.shape[1]
    if d % (16 // x.element_size()):
        raise ValueError(f"d={d} must be a multiple of {16 // x.element_size()}"
                         f" for 16-byte loads of {dtype}")
    for name, t in (("x", x), ("w_in", w_in), ("w_out", w_out),
                    ("w_gate", w_gate)):
        if t is not None:
            _build.check_operand(name, t, dtype, dev)
    _build.check_operand("row_mask", row_mask, torch.float32, dev)
    lib = _build.load("masked_ffn")
    keep = torch.empty((-(-M // 8), Fh // BLOCK_NEURONS), dtype=torch.int32,
                       device=dev)
    scratch = torch.empty((lib.masked_ffn_scratch_floats(M, d, Fh),),
                          dtype=torch.float32, device=dev)
    y = torch.empty((M, d), dtype=dtype, device=dev)
    err = lib.masked_ffn_batch_launch(
        x.data_ptr(), w_in.data_ptr(),
        None if w_gate is None else w_gate.data_ptr(), w_out.data_ptr(),
        row_mask.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
        y.data_ptr(), M, d, Fh, _ACT_CODE[act], _build.DTYPE_CODE[dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_ffn_batch kernel launch failed: CUDA error {err}")
    launches.n += 1
    return y


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_ffn_scratch_floats.argtypes = [i, i, i]
    lib.masked_ffn_scratch_floats.restype = ctypes.c_longlong
    lib.masked_ffn_batch_launch.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.masked_ffn_batch_launch.restype = i


_build.register_binding("masked_ffn", _bind)


def masked_ffn_batch(x, w_in, w_out, row_mask, w_gate=None, *,
                     act: str = "silu"):
    """Per-ROW-masked FFN forward: each row of x carries its own sub-model.

    Shapes: ``x`` (M, d); ``w_in`` [, ``w_gate``] (d, F); ``w_out`` (F, d);
    ``row_mask`` (M, F) 0/1 (neuron-granular, exact). Returns (M, d) in
    ``x.dtype``. F must be a multiple of 128 (ValueError otherwise). An
    (8-row, 128-neuron) tile that no row keeps is skipped; a row whose mask
    is all zero comes out exactly 0. CUDA tensors launch the kernel (same
    dtype for x and the weights, contiguous; the mask is used as fp32), CPU
    tensors run the plain version."""
    _validate(x, w_in, w_out, w_gate, row_mask)
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    if x.device.type == "cpu":
        return masked_ffn_batch_plain(x, w_in, w_out, row_mask, w_gate, act)
    return _launch(x, w_in, w_out, row_mask.to(torch.float32).contiguous(),
                   w_gate, act)
