"""Head-masked attention projections (port of ``repro/kernels/masked_attn.py``).

Invariant dropout at attention granularity drops whole heads: the Q/K/V
columns and the O rows of one head form a closed set, so zeroing all four
makes the head's contribution exactly zero. Two differentiable forms, in
the fleet's training layout (the client axis C written out where the
reference runs under ``jax.vmap``):

* ``masked_head_proj(x, w, head_mask)`` — y = x·W per head slab, dropped
  heads' columns exactly 0 (Q, K, V). x (C, M, din), w (C, din, H·hd),
  heads contiguous and head-dim fastest.
* ``masked_head_merge(a, w, head_mask)`` — y = Σ over kept heads of
  a[:, h]·W[h, :] (O). a (C, M, H·hd), w (C, H·hd, d).

head_mask is (C, H) 0/1. Each form is a ``torch.autograd.Function`` that
saves only (input, weight, mask); its forward is one kernel and its
backward two. A CUDA tensor launches the hand-written kernel of
``csrc/masked_attn.cu`` and counts the launch, a CPU tensor runs the
kernel's plain PyTorch version, a meta tensor the launch's checks and then
the plain version; there is no fallback from the card:

  kernel (launch counter)   plain version                 replaces (Pallas)
  masked_head_proj          masked_head_proj_plain        _proj_kernel :54
  masked_head_proj_dx       masked_head_proj_dx_plain     _proj_dx_kernel :68
  masked_head_proj_dw       masked_head_proj_dw_plain     _proj_dw_kernel :85
  masked_head_merge         masked_head_merge_plain       _merge_kernel :103
  masked_head_merge_da      masked_head_merge_da_plain    _merge_da_kernel :120
  masked_head_merge_dw      masked_head_merge_dw_plain    _proj_dw_kernel :85

The plain versions add their fp32 terms in the Pallas kernels' order: the
sums over heads (dx, merge forward) in head order, the dW sums over
128-row m-tiles in order. ``masked_attention`` composes the two forms
around a causal softmax in plain torch ops, as the reference does in jnp.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

BLOCK_M = 128                 # rows of an m-tile of the dW sums (Pallas block_m)

LAUNCHES = {name: _build.LaunchCounter() for name in (
    "masked_head_proj", "masked_head_proj_dx", "masked_head_proj_dw",
    "masked_head_merge", "masked_head_merge_da", "masked_head_merge_dw")}


def _validate(x, w, head_mask, merge: bool):
    """The reference's ValueErrors (``_validate_proj``), with C in front."""
    if x.ndim != 3:
        raise ValueError(f"x must be (C, M, din), got {tuple(x.shape)}")
    C, _, din = x.shape
    if w.ndim != 3 or tuple(w.shape[:2]) != (C, din):
        raise ValueError(f"w must be (C={C}, {din}, dout), got {tuple(w.shape)}")
    H = head_mask.shape[1] if head_mask.ndim == 2 else -1
    if head_mask.ndim != 2 or head_mask.shape[0] != C or H < 1:
        raise ValueError(f"head_mask must be (C={C}, H) 0/1, got "
                         f"{tuple(head_mask.shape)}")
    ax = 1 if merge else 2            # the head-partitioned axis of w
    if w.shape[ax] % H != 0:
        raise ValueError(
            f"w axis {ax} ({w.shape[ax]}) must divide evenly into H={H} "
            f"heads — the head-masked kernels tile W per head "
            f"(DESIGN.md §10); pad the projection or fix the mask length")


def _ct(t):
    """The type the kernels compute in: fp32 (fp64 stays fp64, so that the
    plain versions can be gradient-checked)."""
    return t.to(torch.float64 if t.dtype == torch.float64 else torch.float32)


def _col_keep(head_mask, width):
    """(C, H) head mask -> (C, 1, width) bool, one entry per column of a
    head-partitioned axis (heads contiguous)."""
    keep = head_mask != 0
    return keep.repeat_interleave(width // keep.shape[-1], dim=-1)[..., None, :]


def _sum_mtiles(a, b):
    """Σ over 128-row m-tiles, in order, of a_tᵀ·b_t (the dW accumulation
    of ``_proj_dw_kernel``)."""
    acc = 0
    for m0 in range(0, a.shape[-2], BLOCK_M):
        acc = acc + (a[..., m0:m0 + BLOCK_M, :].transpose(-1, -2)
                     @ b[..., m0:m0 + BLOCK_M, :])
    return acc


def _sum_heads(a, w, head_mask, w_cols):
    """Σ over kept heads, in head order, of a[:, h]·W_h, where W_h is the
    head's columns of w transposed (w_cols) or its rows (not w_cols)."""
    H = head_mask.shape[-1]
    hs = a.shape[-1] // H
    keep = head_mask != 0
    out = torch.zeros(a.shape[:-1] + (w.shape[-2] if w_cols else w.shape[-1],),
                      dtype=a.dtype, device=a.device)
    for h in range(H):
        s = slice(h * hs, (h + 1) * hs)
        wh = w[..., s].transpose(-1, -2) if w_cols else w[..., s, :]
        out = torch.where(keep[..., h, None, None], out + a[..., s] @ wh, out)
    return out


def masked_head_proj_plain(x, w, head_mask):
    """Plain version of the projection kernel: y[:, h] = x·W[:, h] for kept
    heads, exact zeros for dropped ones; fp32 products, in x.dtype."""
    y = _ct(x) @ _ct(w)
    return torch.where(_col_keep(head_mask, y.shape[-1]), y, 0).to(x.dtype)


def masked_head_proj_dx_plain(gy, w, head_mask):
    """Plain version of the projection's dx kernel: Σ over kept heads, in
    head order, of gy[:, h]·W[:, h]ᵀ in fp32; in gy.dtype."""
    return _sum_heads(_ct(gy), _ct(w), head_mask, w_cols=True).to(gy.dtype)


def masked_head_proj_dw_plain(gy, x, head_mask):
    """Plain version of the projection's dW kernel: dW[:, h] = Σ over
    128-row m-tiles of x_tᵀ·gy_t[:, h] for kept heads, exact zeros for
    dropped ones; fp32, in x.dtype."""
    dw = _sum_mtiles(_ct(x), _ct(gy))
    return torch.where(_col_keep(head_mask, dw.shape[-1]), dw, 0).to(x.dtype)


def masked_head_merge_plain(a, w, head_mask):
    """Plain version of the merge kernel: Σ over kept heads, in head order,
    of a[:, h]·W[h, :] in fp32; in a.dtype."""
    return _sum_heads(_ct(a), _ct(w), head_mask, w_cols=False).to(a.dtype)


def masked_head_merge_da_plain(gy, w, head_mask):
    """Plain version of the merge's da kernel: da[:, h] = gy·W[h, :]ᵀ for
    kept heads, exact zeros for dropped ones; fp32, in gy.dtype."""
    da = _ct(gy) @ _ct(w).transpose(-1, -2)
    return torch.where(_col_keep(head_mask, da.shape[-1]), da, 0).to(gy.dtype)


def masked_head_merge_dw_plain(gy, a, head_mask):
    """Plain version of the merge's dW kernel: dW[h, :] = Σ over 128-row
    m-tiles of a_t[:, h]ᵀ·gy_t for kept heads, exact zeros for dropped
    ones; fp32, in a.dtype."""
    dw = _sum_mtiles(_ct(a), _ct(gy))
    keep = _col_keep(head_mask, dw.shape[-2]).transpose(-1, -2)
    return torch.where(keep, dw, 0).to(a.dtype)


# ---------------------------------------------------------------------------
# the kernels of csrc/masked_attn.cu

# the slab and sum kernels: (body, transposed weight) of each
_SLAB, _SUM = 0, 1
_MM = {"masked_head_proj": (_SLAB, 0), "masked_head_merge_da": (_SLAB, 1),
       "masked_head_proj_dx": (_SUM, 1), "masked_head_merge": (_SUM, 0)}


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_attn_mm_geometry.argtypes = [i] * 7 + [ctypes.POINTER(i)]
    lib.masked_attn_mm_geometry.restype = None
    lib.masked_attn_dw_geometry.argtypes = [i] * 5 + [ctypes.POINTER(i)]
    lib.masked_attn_dw_geometry.restype = None
    for name in LAUNCHES:
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [p] * 4 + [i] * 6 + [p]
        fn.restype = i


_build.register_binding("masked_attn", _bind)


def _plain_here(name, a, b, head_mask):
    """Whether ``name`` runs its plain version on these operands (CPU or
    meta tensors); on CUDA and meta tensors, first the launch's refusals
    (a ValueError)."""
    if _build.checked_as_card(a):
        dtype, dev = a.dtype, a.device
        if dtype not in _build.DTYPE_CODE:
            raise ValueError(f"{name} kernel takes {list(_build.DTYPE_CODE)}, got {dtype}")
        _build.check_operand("a", a, dtype, dev)
        _build.check_operand("b", b, dtype, dev)
        _build.check_operand("head_mask", head_mask, torch.float32, dev)
    return _build.runs_plain(a)


def _launch(name, a, b, head_mask, out_shape, M, width, hd):
    """Launch ``name``'s kernel on (a, b, head_mask) into a new tensor of
    ``out_shape``, type of ``a``; ``width`` is the non-head width (din or
    d)."""
    dtype, dev = a.dtype, a.device
    lib = _build.load("masked_attn")
    C, H = head_mask.shape
    out = torch.empty(out_shape, dtype=dtype, device=dev)
    err = getattr(lib, f"{name}_launch")(
        a.data_ptr(), b.data_ptr(), head_mask.data_ptr(), out.data_ptr(),
        C, M, width, H, hd, _build.DTYPE_CODE[dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name].n += 1
    return out


def dw_launch_geometry(C, M, H, I, J):
    """How the dW kernels (``masked_head_proj_dw``, ``masked_head_merge_dw``)
    launch for C clients of M rows, H heads and an I x J slab (proj: din x
    hd; merge: hd x d): ``cluster`` blocks share a (client, head) slab's
    ``m_tiles`` 128-row m-tiles, ``blocks`` in all. Builds the kernels."""
    out = (ctypes.c_int * 3)()
    _build.load("masked_attn").masked_attn_dw_geometry(C, M, H, I, J, out)
    return {"cluster": out[0], "blocks": out[1], "m_tiles": out[2]}


def mm_launch_geometry(name, C, M, width, H, hd):
    """How the slab and sum kernels (``masked_head_proj``,
    ``masked_head_merge_da``, ``masked_head_proj_dx``,
    ``masked_head_merge``) launch for C clients of M rows, the non-head
    ``width`` (din or d) and H heads of hd: ``blocks`` in all,
    ``threads`` a block, ``smem`` bytes of shared memory a block (fp32),
    ``heads`` a block (the slab kernels), and whether it takes the
    ``large`` tile (fewer, fuller blocks where the grid is large). Builds
    the kernels."""
    out = (ctypes.c_int * 5)()
    _build.load("masked_attn").masked_attn_mm_geometry(*_MM[name], C, M, width,
                                                      H, hd, out)
    return {"blocks": out[0], "threads": out[1], "smem": out[2],
            "heads": out[3], "large": bool(out[4])}


def proj_fwd(x, w, head_mask):
    """Projection forward (no autograd): CUDA tensors launch the
    ``masked_head_proj`` kernel, CPU tensors run its plain version."""
    if _plain_here("masked_head_proj", x, w, head_mask):
        return masked_head_proj_plain(x, w, head_mask)
    C, M, din = x.shape
    N = w.shape[-1]
    return _launch("masked_head_proj", x, w, head_mask, (C, M, N), M,
                   din, N // head_mask.shape[-1])


def proj_dx(gy, w, head_mask):
    """dL/dx of the projection: the ``masked_head_proj_dx`` kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if _plain_here("masked_head_proj_dx", gy, w, head_mask):
        return masked_head_proj_dx_plain(gy, w, head_mask)
    C, M, N = gy.shape
    din = w.shape[-2]
    return _launch("masked_head_proj_dx", gy, w, head_mask, (C, M, din), M,
                   din, N // head_mask.shape[-1])


def proj_dw(gy, x, head_mask):
    """dL/dW of the projection: the ``masked_head_proj_dw`` kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if _plain_here("masked_head_proj_dw", gy, x, head_mask):
        return masked_head_proj_dw_plain(gy, x, head_mask)
    C, M, N = gy.shape
    din, hd = x.shape[-1], N // head_mask.shape[-1]
    return _launch("masked_head_proj_dw", gy, x, head_mask, (C, din, N), M,
                   din, hd)


def merge_fwd(a, w, head_mask):
    """Merge forward (no autograd): the ``masked_head_merge`` kernel on
    CUDA tensors, its plain version on CPU tensors."""
    if _plain_here("masked_head_merge", a, w, head_mask):
        return masked_head_merge_plain(a, w, head_mask)
    C, M, N = a.shape
    d = w.shape[-1]
    return _launch("masked_head_merge", a, w, head_mask, (C, M, d), M,
                   d, N // head_mask.shape[-1])


def merge_da(gy, w, head_mask):
    """dL/da of the merge: the ``masked_head_merge_da`` kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if _plain_here("masked_head_merge_da", gy, w, head_mask):
        return masked_head_merge_da_plain(gy, w, head_mask)
    C, M, d = gy.shape
    N = w.shape[-2]
    return _launch("masked_head_merge_da", gy, w, head_mask, (C, M, N), M,
                   d, N // head_mask.shape[-1])


def merge_dw(gy, a, head_mask):
    """dL/dW of the merge: the ``masked_head_merge_dw`` kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if _plain_here("masked_head_merge_dw", gy, a, head_mask):
        return masked_head_merge_dw_plain(gy, a, head_mask)
    C, M, d = gy.shape
    N = a.shape[-1]
    return _launch("masked_head_merge_dw", gy, a, head_mask, (C, N, d), M,
                   d, N // head_mask.shape[-1])


class MaskedHeadProj(torch.autograd.Function):
    """The reference's ``_proj_vjp`` custom_vjp: saves only (x, w, mask);
    forward one kernel, backward the dx and dW kernels. The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, head_mask):
        ctx.save_for_backward(x, w, head_mask)
        return proj_fwd(x, w, head_mask)

    @staticmethod
    def backward(ctx, gy):
        x, w, head_mask = ctx.saved_tensors
        gy = gy.contiguous()
        return proj_dx(gy, w, head_mask), proj_dw(gy, x, head_mask), None


class MaskedHeadMerge(torch.autograd.Function):
    """The reference's ``_merge_vjp`` custom_vjp: saves only (a, w, mask);
    forward one kernel, backward the da and dW kernels. The mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, a, w, head_mask):
        ctx.save_for_backward(a, w, head_mask)
        return merge_fwd(a, w, head_mask)

    @staticmethod
    def backward(ctx, gy):
        a, w, head_mask = ctx.saved_tensors
        gy = gy.contiguous()
        return merge_da(gy, w, head_mask), merge_dw(gy, a, head_mask), None


def masked_head_proj(x, w, head_mask):
    """Head-masked input projection y = x·W (Q/K/V side), differentiable.

    x (C, M, din); w (C, din, H·hd), heads contiguous, head-dim fastest;
    head_mask (C, H) 0/1. Returns (C, M, H·hd) in x.dtype; the columns of
    a client's dropped heads are exact zeros, kept by skipping. H must
    divide w.shape[2] (ValueError otherwise). dW slabs of dropped heads are
    exact zeros."""
    _validate(x, w, head_mask, merge=False)
    return MaskedHeadProj.apply(x.contiguous(), w.contiguous(),
                                head_mask.to(torch.float32).contiguous())


def masked_head_merge(a, w, head_mask):
    """Head-masked output merge y = a·W (O side), differentiable.

    a (C, M, H·hd) per-head outputs; w (C, H·hd, d); head_mask (C, H) 0/1.
    Returns (C, M, d) in a.dtype, summing only the kept heads, in head
    order, in fp32. H must divide a.shape[2] and w.shape[1] (ValueError
    otherwise). dW rows of dropped heads are exact zeros."""
    _validate(a, w, head_mask, merge=True)
    return MaskedHeadMerge.apply(a.contiguous(), w.contiguous(),
                                 head_mask.to(torch.float32).contiguous())


def masked_attention(x, wq, wk, wv, wo, head_mask, n_heads: int,
                     proj=masked_head_proj, merge=masked_head_merge):
    """Head-masked causal multi-head self-attention over a client axis.

    x (C, B, S, d); wq/wk/wv (C, d, H·hd); wo (C, H·hd, d); head_mask
    (C, H) 0/1 with H == n_heads. Returns (C, B, S, d) in x.dtype.
    Q/K/V go through ``masked_head_proj`` and O through
    ``masked_head_merge``; the scores (over sqrt(hd)), the causal -1e30
    fill, the softmax and the value product are plain torch ops, as the
    reference leaves them outside any Pallas call. A dropped head projects
    to zero, so its output is zero whatever its (uniform) softmax.
    ``proj``/``merge`` replace the two forms (``ops`` passes its own, so
    that a caller who swaps them in ``ops`` reaches them here)."""
    C, B, S, d = x.shape
    if tuple(head_mask.shape) != (C, n_heads):
        raise ValueError(f"head_mask must be (C={C}, n_heads={n_heads}), "
                         f"got {tuple(head_mask.shape)}")
    H = n_heads
    hd = wq.shape[-1] // H
    x2 = x.reshape(C, B * S, d)
    q, k, v = (proj(x2, w, head_mask).reshape(C, B, S, H, hd)
               for w in (wq, wk, wv))
    scores = torch.einsum("cbqhe,cbkhe->cbhqk", q, k) / math.sqrt(float(hd))
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("cbhqk,cbkhe->cbqhe", probs, v).reshape(C, B * S, H * hd)
    return merge(ctx, wo, head_mask).reshape(C, B, S, d)
