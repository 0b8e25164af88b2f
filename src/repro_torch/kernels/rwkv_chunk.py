"""Chunked RWKV-6 WKV recurrence (port of ``repro/kernels/rwkv_chunk.py``).

``rwkv_chunk_scan`` dispatches on where its tensors lie: on a CUDA tensor it
launches the hand-written kernels in ``csrc/rwkv_chunk.cu`` (which replace
the Pallas ``_kernel``: a state pass per chunk, the state carried in chunk
order, and an output pass over pairs of sub-blocks, counted as one
launch); on a CPU tensor it runs ``rwkv_chunk_scan_plain``; on a meta tensor
(the dry-run's) the launch's checks and then ``rwkv_chunk_scan_plain``.
There is no fallback from the card to the plain version. Unlike the Pallas
kernel, which always starts from a zero state, both take an optional
initial state (``tmix_seq``'s ``state_in``).

``rwkv_chunk_scan_bf16`` is the bf16 chunk form (the reference's
``rwkv_chunk_dtype="bfloat16"``, which only its dry-run sets): the decay
tensor and the intra-chunk scores rounded to bf16 as the reference's
``_chunk_core`` rounds them. On the card it runs the same state pass and
carry and ``rwkv_out_bf16_kernel``, which takes each (t, j, n)'s
exponential literally (a block a pair of 16-row sub-blocks, r·k and D
formed two at a time in bf16 and summed over n on the tensor core); it has
its own launch counter. ``bf16_product_check`` runs that kernel's packed
bf16 product over every pair of bf16 values against the fp32 product
rounded to bf16, as the plain form rounds r ⊗ k.

The kernels have no backward (nor has the reference's Pallas kernel). On a
CUDA or meta tensor, an input that requires grad with grad mode on raises
ValueError: the launch's output would be cut off from autograd. Training
takes the plain chunked form in ``models/rwkv6.tmix_seq``, as the
reference's ``tmix_seq`` differentiates its jnp chunk scan.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

HEAD_SIZES = (16, 32, 64)      # head dims N the kernel takes
MAX_CHUNK = 1024               # csrc/rwkv_chunk.cu CMAX

launches = _build.LaunchCounter()
bf16_launches = _build.LaunchCounter()


def _chunk_core(r, k, v, logw, u, S0, chunk_dtype=torch.float32):
    """One chunk (``repro/models/rwkv6.py::_chunk_core``): r,k,v
    (B,c,H,N), logw (B,c,H,N) fp32, u (H,N) fp32, S0 (B,H,N,N) fp32.
    Returns (y (B,c,H,N) fp32, S1). Every exponent is <= 0. With
    ``chunk_dtype`` bf16 the intra-chunk scores are the reference's bf16
    einsum: D rounded to bf16, r ⊗ k rounded to bf16 (jnp.einsum's
    pairwise path, [(0, 1), (0, 1)] at every zoo size), the sum over n of
    its products with D in fp32, rounded to bf16, then fp32."""
    rf, kf, vf = r.float(), k.float(), v.float()
    L_inc = torch.cumsum(logw, dim=1)                     # inclusive
    L_exc = L_inc - logw                                  # exclusive
    L_tot = L_inc[:, -1:]                                 # (B,1,H,N)

    # inter-chunk: y_t += (r_t * exp(L_exc_t)) @ S0
    y = torch.einsum("bchn,bhnm->bchm", rf * torch.exp(L_exc), S0)

    # intra-chunk strict-lower part: D[t,j,n] = exp(L_exc[t] - L_inc[j]) <= 1
    c = r.shape[1]
    Dlog = L_exc[:, :, None] - L_inc[:, None, :]          # (B,c,c,H,N)
    tri = torch.arange(c, device=r.device)[:, None] > torch.arange(c, device=r.device)[None, :]
    D = torch.where(tri[None, :, :, None, None], torch.exp(Dlog),
                    torch.zeros((), device=r.device))
    if chunk_dtype == torch.float32:
        scores = torch.einsum("bthn,bjhn,btjhn->bthj", rf, kf, D)
    else:
        cd = chunk_dtype
        rk = (rf.to(cd).float()[:, :, None] * kf.to(cd).float()[:, None]).to(cd)
        scores = torch.einsum("btjhn,btjhn->bthj", rk.float(),
                              D.to(cd).float()).to(cd).float()
    y = y + torch.einsum("bthj,bjhm->bthm", scores, vf)

    # diagonal bonus term
    diag = torch.einsum("bthn,bthn->bth", rf, u[None, None] * kf)
    y = y + diag[..., None] * vf

    # state update: S1 = exp(L_tot) ⊙ S0 + sum_j exp(L_tot - L_inc_j) k_j v_j^T
    k_hat = kf * torch.exp(L_tot - L_inc)
    S1 = torch.exp(L_tot)[:, 0, :, :, None] * S0 + torch.einsum(
        "bjhn,bjhm->bhnm", k_hat, vf)
    return y, S1


def rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=64, state=None,
                          chunk_dtype=torch.float32):
    """Plain version: ``_chunk_core`` over the chunks in order, from
    ``state`` (B,H,N,N) fp32, or from zero. Returns (y (B,S,H,N) fp32,
    final state (B,H,N,N) fp32). ``chunk_dtype`` bf16: the bf16 chunk
    form's scores."""
    B, S, H, N = r.shape
    c = min(chunk, S)
    S0 = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
          if state is None else state.float())
    uf, lw = u.float(), logw.float()
    ys = []
    for i in range(0, S, c):
        y, S0 = _chunk_core(r[:, i:i + c], k[:, i:i + c], v[:, i:i + c],
                            lw[:, i:i + c], uf, S0, chunk_dtype)
        ys.append(y)
    return torch.cat(ys, dim=1), S0


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rwkv_chunk_launch.argtypes = [p] * 10 + [i] * 7 + [p]
    lib.rwkv_chunk_launch.restype = i
    lib.rwkv_bf16_product_check.argtypes = [p] * 3
    lib.rwkv_bf16_product_check.restype = i


_build.register_binding("rwkv_chunk", _bind)


def _check(r, k, v, logw, u, chunk, state):
    """The launch's refusals (a ValueError)."""
    N, dtype, dev = r.shape[3], r.dtype, r.device
    if dtype not in _build.DTYPE_CODE:
        raise ValueError(f"rwkv_chunk_scan kernel takes {list(_build.DTYPE_CODE)}, got {dtype}")
    if N not in HEAD_SIZES:
        raise ValueError(f"rwkv_chunk_scan kernel takes head size N in {HEAD_SIZES}, got {N}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"rwkv_chunk_scan kernel takes chunk <= {MAX_CHUNK}, got {chunk}")
    for name, t in (("r", r), ("k", k), ("v", v)):
        _build.check_operand(name, t, dtype, dev)
    _build.check_operand("logw", logw, torch.float32, dev)
    _build.check_operand("u", u, torch.float32, dev)
    if state is not None:
        _build.check_operand("state", state, torch.float32, dev)


def bf16_items(B, S, H, chunk):
    """Blocks of the bf16 form's output kernel, one an item: a (b·h, chunk)
    and a pair of its 16-row sub-blocks."""
    return B * H * (S // chunk) * ((-(-chunk // 16) + 1) // 2)


def _launch(r, k, v, logw, u, chunk, state, bf16_scores):
    B, S, H, N = r.shape
    dtype, dev = r.dtype, r.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    y = torch.empty((B, S, H, N), dtype=torch.float32, device=dev)
    s_out = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    # each chunk's local state term and total log decay, for the output pass
    nc = S // chunk
    ds = torch.empty((B * H * nc * N * N,), dtype=torch.float32, device=dev)
    ltot = torch.empty((B * H * nc * N,), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.load("rwkv_chunk").rwkv_chunk_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        ptr(state), ds.data_ptr(), ltot.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        B, S, H, N, chunk, _build.DTYPE_CODE[dtype], int(bf16_scores), stream)
    if err != 0:
        raise RuntimeError(f"rwkv_chunk_scan kernel launch failed: CUDA error {err}")
    (bf16_launches if bf16_scores else launches).n += 1
    return y, s_out


def _validate(r, k, v, logw, u, chunk, state):
    """The shape errors of either form; returns the chunk, min(chunk, S)."""
    if r.ndim != 4 or k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape:
        raise ValueError(f"r, k, v, logw must share one (B, S, H, N) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, S, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"u must be (H={H}, N={N}), got {tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (B, H, N, N):
        raise ValueError(f"state must be (B={B}, H={H}, N={N}, N={N}), got "
                         f"{tuple(state.shape)}")
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"sequence length {S} must be a multiple of chunk {chunk}")
    return chunk


def _scan(r, k, v, logw, u, chunk, state, bf16_scores):
    chunk = _validate(r, k, v, logw, u, chunk, state)
    cd = torch.bfloat16 if bf16_scores else torch.float32
    if _build.checked_as_card(r):
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in (r, k, v, logw, u, state)):
            # the kernel launches through raw pointers: its output would be
            # cut off from autograd, and no gradient would reach the params
            raise ValueError("rwkv_chunk_scan's kernel (B12) has no backward (nor has the "
                             "reference's); an input requires grad: run it under "
                             "torch.no_grad(), or differentiate rwkv_chunk_scan_plain")
        _check(r, k, v, logw, u, chunk, state)
    if _build.runs_plain(r):
        return rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=chunk, state=state,
                                     chunk_dtype=cd)
    return _launch(r, k, v, logw, u, chunk, state, bf16_scores)


def rwkv_chunk_scan(r, k, v, logw, u, chunk=64, state=None):
    """r,k,v: (B,S,H,N); logw: (B,S,H,N) fp32 log decay (< 0); u: (H,N);
    state: optional (B,H,N,N) fp32 initial state (zero when None).
    chunk = min(chunk, S) must divide S. Returns (y (B,S,H,N) fp32, final
    state (B,H,N,N) fp32). CUDA tensors launch the kernel, CPU tensors run
    the plain version, meta tensors the launch's checks and then the plain
    version. The kernel is forward-only: on a CUDA or meta tensor an input
    that requires grad, with grad mode on, raises ValueError."""
    return _scan(r, k, v, logw, u, chunk, state, bf16_scores=False)


def rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=64, state=None):
    """The bf16 chunk form of ``rwkv_chunk_scan`` (same arguments and
    results): the intra-chunk scores as the reference's ``_chunk_core``
    computes them at ``chunk_dtype=bfloat16``; the inter term, the bonus
    and the state in fp32. On the card ``rwkv_out_bf16_kernel`` takes the
    output pass; launches are counted in ``bf16_launches``."""
    return _scan(r, k, v, logw, u, chunk, state, bf16_scores=True)


def bf16_product_check(device="cuda"):
    """``rwkv_out_bf16_kernel``'s r·k (``mul.rn.bf16x2``: the exact product
    rounded once) against the product in fp32 rounded to bf16, over every
    pair of bf16 bit patterns but NaNs (2^32 pairs), on the card. Returns
    {"pairs_differing", "normal_pairs_differing" (fp32 product >= 2^-126),
    "first" (a, b bit patterns of one differing pair, or None)}. Not a
    launch of the scan: no counter moves."""
    dev = torch.device(device)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    first = torch.full((1,), -1, dtype=torch.int32, device=dev)
    err = _build.load("rwkv_chunk").rwkv_bf16_product_check(
        counts.data_ptr(), first.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv_bf16_product_check launch failed: CUDA error {err}")
    f = int(first.item()) & 0xFFFFFFFF
    return {"pairs_differing": int(counts[0]), "normal_pairs_differing": int(counts[1]),
            "first": None if f == 0xFFFFFFFF else (f >> 16, f & 0xFFFF)}
