"""Per-row-masked FFN (port of ``repro/kernels/masked_ffn.py``).

    y = (act(x @ W_in) [* act(x @ W_gate)] ⊙ row_mask) @ W_out

Two forms, each dispatching on where its tensors lie — a CUDA tensor
launches the hand-written kernel and counts the launch, a CPU tensor runs
the kernel's plain PyTorch version, a meta tensor (the dry-run's) the
launch's checks and then the plain version; there is no fallback from the
card to the plain version:

* ``masked_ffn_batch`` — the serving form: x (M, d), one weight set,
  forward only. Kernel ``csrc/masked_ffn.cu`` (replaces the Pallas
  ``_fwd_kernel``): bf16 on the tensor cores in two cluster launches
  shaped by ``ffn_geometry``, fp32 on FFMA in three; a call is counted as
  one launch.
* ``masked_ffn_train`` — the fleet's training form: a client axis C in
  front of everything (x (C, M, d), weights (C, ...), row_mask (C, M, F)),
  differentiable through ``MaskedFFNTrain`` (a ``torch.autograd.Function``
  whose forward launches the forward kernel and whose backward launches
  the dx and dW kernels of ``csrc/masked_ffn_train.cu``, which replace the
  Pallas ``_fwd_kernel``, ``_dx_kernel`` and ``_dw_kernel`` under
  ``jax.vmap``). The backward recomputes the pre-activations from the
  saved (x, weights, mask) — the reference's recompute policy — and the
  mask gets no gradient. The forward, dx and dW of bf16 clients of at
  least TC_ROWS rows (``tc_route``) run instead on the tensor cores
  (``csrc/masked_ffn_train_tc.cu``), in two launches each.
* ``masked_ffn`` — the reference's block-masked entry: x (M, d), one
  (F/128,) 0/1 mask for every row, differentiable. It is the training
  form at C = 1 with the block mask expanded to a row mask, so it runs the
  same three kernels (the Pallas ones it replaces are the same three
  functions, with the mask prefetched per block).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

BLOCK_NEURONS = 128
# the bf16 serving kernel's launch shape (ffn_geometry)
CLUSTERS = (1, 2, 4, 8)        # blocks a cluster may have (portable sizes)
COVER = 1                      # blocks wanted per SM in each pass
# the dW kernel's launch shape (dw_launch_geometry)
DW_GROUPS = 16                 # most blocks one (client, f-block)'s m-tiles split over
DW_ROWS = 64                   # rows of d a dW block covers (DW_DK)
# the forward and dx kernels' launch shape (fwd_dx_launch_geometry)
FD_WARPS = 8                   # warps a block has (FD_WARPS)
FD_WT = 4                      # warps an m-tile takes, 32 of its 128 neurons each (FD_WT)
FD_COVER = 1                   # blocks wanted per SM
# the tensor-core route of the forward, dx and dW (tc_route, csrc/masked_ffn_train_tc.cu)
TC_ROWS = 128                  # rows of a row tile; a client needs at least this many
TC_DEPTH = 64                  # d must be a multiple of it (a ring stage's depth)
TC_PLANES = 3                  # bf16 terms dx and dW split each fp32 hm / dzh / dzg into

_ACTS = {"relu": torch.relu,
         "relu2": lambda h: torch.square(torch.relu(h)),
         "gelu": lambda h: F.gelu(h, approximate="tanh"),
         "silu": F.silu}
_ACT_CODE = {"relu": 0, "relu2": 1, "gelu": 2, "silu": 3}   # csrc/common.cuh


def _dgelu(z):
    # derivative of the tanh-form gelu (repro _dgelu)
    c = 0.7978845608028654            # sqrt(2/pi)
    t = torch.tanh(c * (z + 0.044715 * z * z * z))
    du = c * (1.0 + 3 * 0.044715 * z * z)
    return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du


def _dsilu(z):
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


_DACTS = {"relu": lambda z: (z > 0).to(z.dtype),
          "relu2": lambda z: 2.0 * torch.relu(z),
          "gelu": _dgelu,
          "silu": _dsilu}

launches = _build.LaunchCounter()          # masked_ffn_batch (serving)
train_fwd_launches = _build.LaunchCounter()     # every call, either route
dx_launches = _build.LaunchCounter()
train_fwd_tc_launches = _build.LaunchCounter()  # the calls that took the tensor-core route
dx_tc_launches = _build.LaunchCounter()
dw_launches = _build.LaunchCounter()
dw_tc_launches = _build.LaunchCounter()


def _validate(x, w_in, w_out, w_gate, mask, per_row=True):
    """The reference's ValueErrors, word for word."""
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
    if per_row and tuple(mask.shape) != (M, Fh):
        raise ValueError(
            f"row_mask must be (M={M}, F={Fh}) — one 0/1 neuron mask per "
            f"row of x — got {tuple(mask.shape)}")
    if not per_row and tuple(mask.shape) != (Fh // BLOCK_NEURONS,):
        raise ValueError(
            f"block_mask must be (F//{BLOCK_NEURONS},) = "
            f"({Fh // BLOCK_NEURONS},) — one 0/1 entry per 128-neuron "
            f"block — got {tuple(mask.shape)}. For neuron-granular masks use "
            f"masked_ffn_batch (per-row masks) instead")


def _ct(t):
    """The type the kernels compute in: fp32 (fp64 stays fp64, so that the
    plain versions can be gradient-checked)."""
    return t.to(torch.float64 if t.dtype == torch.float64 else torch.float32)


def _block_keep(keep):
    """(..., M, F) bool -> (..., M, F/128, 1) bool: whether a row keeps any
    neuron of each 128-neuron block."""
    return keep.unflatten(-1, (-1, BLOCK_NEURONS)).any(-1)[..., None]


def masked_ffn_batch_plain(x, w_in, w_out, row_mask, w_gate=None, act="silu"):
    """Plain version of the forward kernels' arithmetic, for either form
    (leading client axis or none): fp32 products, each row's hidden
    activations selected by its own mask, rounded to x.dtype before the
    down product as the Pallas ``_fwd_kernel`` rounds them, and the down
    product summed over 128-neuron blocks in block order, as the kernels
    add their f-block partials.

    It selects and never multiplies by the mask: a dropped hidden unit is
    exactly 0 and a block a row keeps no neuron of stays out of that row's
    down product, so a non-finite weight in a dropped block never reaches
    the output. On finite inputs this is
    ``repro/kernels/ref.py::masked_ffn_batch_ref``'s arithmetic summed in
    block order. The reference's per-row kernel multiplies by the mask
    inside a tile that some row of its 8-row m-tile keeps, so for a
    non-finite weight in such a partly kept tile it gives NaN where this
    gives 0."""
    xf = _ct(x)
    keep = row_mask > 0
    h = xf @ _ct(w_in)
    if w_gate is not None:
        h = _ACTS[act](xf @ _ct(w_gate)) * h
    else:
        h = _ACTS[act](h)
    h = _ct(torch.where(keep, h, 0).to(x.dtype))
    keep_b = _block_keep(keep)
    y = torch.zeros(h.shape[:-1] + (w_out.shape[-1],), dtype=h.dtype, device=x.device)
    for b, f0 in enumerate(range(0, h.shape[-1], BLOCK_NEURONS)):
        f = slice(f0, f0 + BLOCK_NEURONS)
        y = torch.where(keep_b[..., b, :], y + h[..., f] @ _ct(w_out[..., f, :]), y)
    return y.to(x.dtype)


def ffn_geometry(M, d, F, n_sm):
    """The bf16 kernel's launch shape (ks, fs): ks blocks split d in the up
    pass's cluster per (f-block, m-tile), fs blocks split the kept
    f-blocks in the down pass's cluster per (128 columns, m-tile); each the
    smallest of ``CLUSTERS`` whose grid covers the ``n_sm`` SMs ``COVER``
    times (ks at most d's 64-row stages)."""
    nmt, nfb = -(-M // 8), F // BLOCK_NEURONS
    ks = next((c for c in CLUSTERS if nfb * nmt * c >= COVER * n_sm), CLUSTERS[-1])
    fs = next((c for c in CLUSTERS if -(-d // BLOCK_NEURONS) * nmt * c >= COVER * n_sm),
              CLUSTERS[-1])
    return min(ks, -(-d // 64)), fs


def _check_batch(x, w_in, w_out, row_mask, w_gate):
    """The serving kernel's refusals (a ValueError), on what it is given."""
    dtype, dev = x.dtype, x.device
    if dtype not in _build.DTYPE_CODE:
        raise ValueError(f"masked_ffn_batch kernel takes {list(_build.DTYPE_CODE)}, "
                         f"got {dtype}")
    d = x.shape[1]
    if d % (16 // x.element_size()):
        raise ValueError(f"d={d} must be a multiple of {16 // x.element_size()}"
                         f" for 16-byte loads of {dtype}")
    for name, t in (("x", x), ("w_in", w_in), ("w_out", w_out),
                    ("w_gate", w_gate)):
        if t is not None:
            _build.check_operand(name, t, dtype, dev)
    _build.check_operand("row_mask", row_mask, torch.float32, dev)


def _launch(x, w_in, w_out, row_mask, w_gate, act):
    dtype, dev = x.dtype, x.device
    M, d = x.shape
    Fh = w_in.shape[1]
    lib = _build.load("masked_ffn")
    code = _build.DTYPE_CODE[dtype]
    ks, fs = ffn_geometry(M, d, Fh, _build.sm_count(dev))
    keep = torch.empty((-(-M // 8), Fh // BLOCK_NEURONS), dtype=torch.int32,
                       device=dev)
    scratch = torch.empty((lib.masked_ffn_scratch_floats(M, d, Fh, code),),
                          dtype=torch.float32, device=dev)
    y = torch.empty((M, d), dtype=dtype, device=dev)
    err = lib.masked_ffn_batch_launch(
        x.data_ptr(), w_in.data_ptr(),
        None if w_gate is None else w_gate.data_ptr(), w_out.data_ptr(),
        row_mask.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
        y.data_ptr(), M, d, Fh, _ACT_CODE[act], code, ks, fs,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_ffn_batch kernel launch failed: CUDA error {err}")
    launches.n += 1
    return y


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_ffn_scratch_floats.argtypes = [i] * 4
    lib.masked_ffn_scratch_floats.restype = ctypes.c_longlong
    lib.masked_ffn_batch_launch.argtypes = [p] * 8 + [i] * 7 + [p]
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
    if _build.checked_as_card(x):
        row_mask = row_mask.to(torch.float32).contiguous()
        _check_batch(x, w_in, w_out, row_mask, w_gate)
    if _build.runs_plain(x):
        return masked_ffn_batch_plain(x, w_in, w_out, row_mask, w_gate, act)
    return _launch(x, w_in, w_out, row_mask, w_gate, act)


# ---------------------------------------------------------------------------
# training form: client-batched, differentiable

def _validate_train(x, w_in, w_out, w_gate, mask):
    """The reference's ValueErrors, with the client axis C in front."""
    if x.ndim != 3:
        raise ValueError(f"x must be (C, M, d), got shape {tuple(x.shape)}")
    C, M, d = x.shape
    if w_in.ndim != 3 or tuple(w_in.shape[:2]) != (C, d):
        raise ValueError(f"w_in must be (C={C}, d={d}, F), got {tuple(w_in.shape)}")
    Fh = w_in.shape[2]
    if Fh % BLOCK_NEURONS != 0:
        raise ValueError(
            f"masked FFN hidden dim F={Fh} must be a multiple of "
            f"BLOCK_NEURONS={BLOCK_NEURONS}; pad w_in/w_out (and the mask) "
            f"to 128 alignment — anything else would mis-tile the block "
            f"skip (DESIGN.md §10)")
    if tuple(w_out.shape) != (C, Fh, d):
        raise ValueError(f"w_out must be (C={C}, F={Fh}, d={d}), "
                         f"got {tuple(w_out.shape)}")
    if w_gate is not None and tuple(w_gate.shape) != (C, d, Fh):
        raise ValueError(f"w_gate must be (C={C}, d={d}, F={Fh}), "
                         f"got {tuple(w_gate.shape)}")
    if tuple(mask.shape) != (C, M, Fh):
        raise ValueError(
            f"row_mask must be (C={C}, M={M}, F={Fh}) — one 0/1 neuron mask "
            f"per row of x — got {tuple(mask.shape)}")


def _bwd_core_plain(gy, x, w_in, w_out, row_mask, w_gate, act):
    """(hm, dzh, dzg) of repro ``_bwd_core``, recomputed from the inputs;
    each selected by the row mask (a dropped entry exactly 0, whatever the
    weights hold there)."""
    xf, keep = _ct(x), row_mask > 0
    sel = lambda t: torch.where(keep, t, 0)
    zh = xf @ _ct(w_in)
    ghm = sel(_ct(gy) @ _ct(w_out).transpose(-1, -2))
    if w_gate is not None:
        zg = xf @ _ct(w_gate)
        a = _ACTS[act](zg)
        return sel(a * zh), sel(ghm * a), sel(ghm * zh * _DACTS[act](zg))
    return sel(_ACTS[act](zh)), sel(ghm * _DACTS[act](zh)), None


def masked_ffn_dx_plain(gy, x, w_in, w_out, row_mask, w_gate=None,
                        act="silu"):
    """Plain version of the dx kernel: the sum over 128-neuron blocks, in
    block order as the kernel and ``_dx_kernel`` add them, of
    dzh·W_inᵀ (+ dzg·W_gateᵀ), in fp32; returned in x.dtype. A block a row
    keeps no neuron of stays out of that row's sum (selected, never
    multiplied by the mask), as in the forward's down product."""
    _, dzh, dzg = _bwd_core_plain(gy, x, w_in, w_out, row_mask, w_gate, act)
    keep_b = _block_keep(row_mask > 0)
    dx = torch.zeros(dzh.shape[:-1] + (x.shape[-1],), dtype=dzh.dtype, device=x.device)
    for b, f0 in enumerate(range(0, dzh.shape[-1], BLOCK_NEURONS)):
        f = slice(f0, f0 + BLOCK_NEURONS)
        nxt = dx + dzh[..., f] @ _ct(w_in[..., f]).transpose(-1, -2)
        if w_gate is not None:
            nxt = nxt + dzg[..., f] @ _ct(w_gate[..., f]).transpose(-1, -2)
        dx = torch.where(keep_b[..., b, :], nxt, dx)
    return dx.to(x.dtype)


def _sum_mtiles(a, b):
    """Σ over 8-row m-tiles, in order, of a_tᵀ·b_t — the dW kernel's and
    ``_dw_kernel``'s accumulation over the rows."""
    acc = 0
    for m0 in range(0, a.shape[-2], 8):
        acc = acc + a[..., m0:m0 + 8, :].transpose(-1, -2) @ b[..., m0:m0 + 8, :]
    return acc


def masked_ffn_dw_plain(gy, x, w_in, w_out, row_mask, w_gate=None,
                        act="silu"):
    """Plain version of the dW kernel: (dW_in, dW_out, dW_gate) = (xᵀ·dzh,
    hmᵀ·gy, xᵀ·dzg) in fp32, each in its weight's dtype (dW_gate None when
    ungated). hm, dzh and dzg are selected by the mask (never multiplied by
    it), so a dropped block's dW is exactly 0 whatever its weights hold."""
    hm, dzh, dzg = _bwd_core_plain(gy, x, w_in, w_out, row_mask, w_gate, act)
    xf = _ct(x)
    dw_in = _sum_mtiles(xf, dzh).to(w_in.dtype)
    dw_out = _sum_mtiles(hm, _ct(gy)).to(w_out.dtype)
    dw_gate = None if w_gate is None else _sum_mtiles(xf, dzg).to(w_gate.dtype)
    return dw_in, dw_out, dw_gate


def _check_train(name, x, w_in, w_out, row_mask, w_gate, gy=None):
    """The training kernels' refusals (a ValueError)."""
    dtype, dev = x.dtype, x.device
    if dtype not in _build.DTYPE_CODE:
        raise ValueError(f"{name} kernel takes {list(_build.DTYPE_CODE)}, "
                         f"got {dtype}")
    for arg, t in (("x", x), ("gy", gy), ("w_in", w_in), ("w_out", w_out),
                   ("w_gate", w_gate)):
        if t is not None:
            _build.check_operand(arg, t, dtype, dev)
    _build.check_operand("row_mask", row_mask, torch.float32, dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def fwd_dx_launch_geometry(C, M, d, F, n_sm=132):
    """How the forward and dx kernels launch for C clients of M rows, width
    d and F hidden neurons on a card of ``n_sm`` SMs: each (client, f-block)
    pair's ``m_tiles`` 8-row m-tiles are split over ``groups`` blocks of
    ``m_tiles_per_block`` contiguous m-tiles (as many as give the SMs
    FD_COVER blocks each, one a pair where the pairs fill them already), a
    block's ``warps`` warps taking them ``warps_per_m_tile`` warps to an
    m-tile at a time; ``blocks`` in all, ``grid`` (groups, F/128, C). Each
    block writes an fp32 partial a f-block, and a second kernel adds them in
    f order."""
    nmt, nfb = -(-M // 8), F // BLOCK_NEURONS
    pairs = C * nfb
    per = -(-nmt // max(1, min(nmt, -(-FD_COVER * n_sm // max(pairs, 1)))))
    groups = -(-nmt // per)
    return {"groups": groups, "m_tiles": nmt, "m_tiles_per_block": per, "warps": FD_WARPS,
            "warps_per_m_tile": FD_WT, "blocks": groups * pairs, "grid": (groups, nfb, C)}


def fd_slab_resident(M, d, F, gated, bwd, groups):
    """Whether the forward (``bwd`` False) or dx kernel keeps each
    f-block's weight slab resident in shared memory for the block's m-tiles
    at this shape and split, or restages it 32 rows of d at a time (the
    kernel's own reckoning; builds the kernels)."""
    lib = _build.load("masked_ffn_train")
    return bool(lib.masked_ffn_fd_resident(M, d, F, int(gated), int(bwd), groups))


def _aligned(t):
    """t, or a copy of it at a 16-byte boundary (the kernels read the mask
    and the weights 16 bytes at a time)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def tc_route(x):
    """Whether the training forward, dx and dW of x (C, M, d) run on the tensor
    cores (``csrc/masked_ffn_train_tc.cu``): bf16, at least TC_ROWS rows a
    client and d a multiple of TC_DEPTH, where the products are bound by
    operations. Every other call (fp32, small M: bound by latency and fp32
    FMA) runs ``csrc/masked_ffn_train.cu``. fp32 never goes to the tensor
    cores: TF32 would lose precision."""
    return (x.dtype == torch.bfloat16 and x.shape[-2] >= TC_ROWS
            and x.shape[-1] % TC_DEPTH == 0)


def _launch_fd_tc(name, gy, x, w_in, w_out, row_mask, w_gate, act):
    """Two launches: the up kernel (each kept (row tile, f-block)'s
    pre-activations, masked, into bf16 scratch: the hidden activation, or
    dzh and dzg split into TC_PLANES bf16 terms each) and the down kernel
    (the sum over the kept f-blocks, in f order, in one fp32 accumulator)."""
    dev, (C, M, d), Fh = x.device, x.shape, w_in.shape[2]
    lib = _build.load("masked_ffn_train_tc")
    keep = torch.empty((C, -(-M // TC_ROWS), Fh // BLOCK_NEURONS), dtype=torch.int32,
                       device=dev)
    planes = 1 if gy is None else TC_PLANES * (1 if w_gate is None else 2)
    scratch = torch.empty((C, planes, M, Fh), dtype=torch.bfloat16, device=dev)
    out = torch.empty((C, M, d), dtype=x.dtype, device=dev)
    err = lib.masked_ffn_train_tc_launch(
        _ptr(gy), x.data_ptr(), w_in.data_ptr(), _ptr(w_gate), w_out.data_ptr(),
        row_mask.data_ptr(), keep.data_ptr(), scratch.data_ptr(), out.data_ptr(), C, M, d, Fh,
        _ACT_CODE[act], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    (train_fwd_tc_launches if gy is None else dx_tc_launches).n += 1
    return out


def _launch_fd(name, gy, x, w_in, w_out, row_mask, w_gate, act):
    dtype, dev, (C, M, d), Fh = x.dtype, x.device, x.shape, w_in.shape[2]
    w_in, w_out, row_mask, w_gate = (_aligned(t) for t in (w_in, w_out, row_mask, w_gate))
    if tc_route(x):
        return _launch_fd_tc(name, gy, x, w_in, w_out, row_mask, w_gate, act)
    lib = _build.load("masked_ffn_train")
    geo = fwd_dx_launch_geometry(C, M, d, Fh, _build.sm_count(dev))
    nfb = Fh // BLOCK_NEURONS           # the f-blocks' fp32 partials, for the reduce
    keep = torch.empty((C, -(-M // 8), nfb), dtype=torch.int32, device=dev)
    part = torch.empty((nfb, C, M, d), dtype=torch.float32, device=dev)
    out = torch.empty((C, M, d), dtype=dtype, device=dev)
    args = (x.data_ptr(), w_in.data_ptr(), _ptr(w_gate), w_out.data_ptr(),
            row_mask.data_ptr(), keep.data_ptr(), part.data_ptr(), out.data_ptr(), C, M, d, Fh,
            _ACT_CODE[act], _build.DTYPE_CODE[dtype], geo["groups"],
            torch.cuda.current_stream(dev).cuda_stream)
    if gy is None:
        err = lib.masked_ffn_train_fwd_launch(*args)
    else:
        err = lib.masked_ffn_dx_launch(gy.data_ptr(), *args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _launch_train_fwd(x, w_in, w_out, row_mask, w_gate, act):
    y = _launch_fd("masked_ffn_train_fwd", None, x, w_in, w_out, row_mask, w_gate, act)
    train_fwd_launches.n += 1
    return y


def _launch_dx(gy, x, w_in, w_out, row_mask, w_gate, act):
    dx = _launch_fd("masked_ffn_dx", gy, x, w_in, w_out, row_mask, w_gate, act)
    dx_launches.n += 1
    return dx


def dw_launch_geometry(C, M, d, F, n_sm=132):
    """How the dW kernel launches for C clients of M rows, width d and F
    hidden neurons on a card of ``n_sm`` SMs: each (client, f-block) pair's
    ``m_tiles`` 8-row m-tiles are split over ``groups`` blocks of
    ``m_tiles_per_block`` contiguous m-tiles (as many as fill the SMs, at
    most DW_GROUPS), a block for each DW_ROWS rows of d; ``blocks`` in all,
    ``grid`` (groups, F/128·ceil(d/64), C). ``route`` says how the partials
    are added in m-tile order: "direct" (one block a pair writes dW) or
    "scratch" (an fp32 scratch and a second kernel). ``core_pass``: d > 64,
    so the blocks split d, and a first kernel computes each kept tile's
    (hm, dzh, dzg) once for all of them, into an fp32 scratch."""
    nmt, nfb, ndk = -(-M // 8), F // BLOCK_NEURONS, -(-d // DW_ROWS)
    pairs = C * nfb * ndk
    per = -(-nmt // max(1, min(nmt, DW_GROUPS, n_sm // max(pairs, 1))))
    groups = -(-nmt // per)
    return {"route": "direct" if groups == 1 else "scratch", "groups": groups, "m_tiles": nmt,
            "m_tiles_per_block": per, "blocks": groups * pairs,
            "grid": (groups, nfb * ndk, C), "core_pass": ndk > 1}


def _launch_dw_tc(gy, x, w_in, w_out, row_mask, w_gate, act):
    """Two launches: the up kernel (each kept (row tile, f-block)'s hm, dzh
    and dzg, masked, each split into TC_PLANES bf16 terms into scratch) and
    the product kernel (a 256 x 128 tile of one dW a block, the sum over the
    f-block's kept row tiles, in row order, in one fp32 accumulator)."""
    dev, (C, M, d), Fh = x.device, x.shape, w_in.shape[2]
    lib = _build.load("masked_ffn_train_tc")
    keep = torch.empty((C, -(-M // TC_ROWS), Fh // BLOCK_NEURONS), dtype=torch.int32,
                       device=dev)
    planes = torch.empty((C, TC_PLANES * (2 if w_gate is None else 3), M, Fh),
                         dtype=torch.bfloat16, device=dev)
    dw_in, dw_out = torch.empty_like(w_in), torch.empty_like(w_out)
    dw_gate = None if w_gate is None else torch.empty_like(w_gate)
    err = lib.masked_ffn_dw_tc_launch(
        gy.data_ptr(), x.data_ptr(), w_in.data_ptr(), _ptr(w_gate), w_out.data_ptr(),
        row_mask.data_ptr(), keep.data_ptr(), planes.data_ptr(), dw_in.data_ptr(),
        _ptr(dw_gate), dw_out.data_ptr(), C, M, d, Fh, _ACT_CODE[act],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_ffn_dw kernel launch failed: CUDA error {err}")
    dw_tc_launches.n += 1
    return dw_in, dw_out, dw_gate


def _launch_dw_ffma(gy, x, w_in, w_out, row_mask, w_gate, act):
    dtype, dev, (C, M, d), Fh = x.dtype, x.device, x.shape, w_in.shape[2]
    lib = _build.load("masked_ffn_train")
    geo = dw_launch_geometry(C, M, d, Fh, _build.sm_count(dev))
    # every element is written by the kernel, dropped tiles as exact zeros
    dw_in = torch.empty_like(w_in)
    dw_out = torch.empty_like(w_out)
    dw_gate = None if w_gate is None else torch.empty_like(w_gate)
    scratch = core = None
    if geo["groups"] > 1:              # each block's fp32 partial of its pair's dW
        blocks = geo["groups"] * (Fh // BLOCK_NEURONS) * -(-d // DW_ROWS) * C
        per_block = 32 * (2 if w_gate is None else 3) * 256   # partials a thread, threads
        scratch = torch.empty((blocks * per_block,), dtype=torch.float32, device=dev)
    if d > DW_ROWS:                    # the core pass: (hm, dzh, dzg) of every tile
        core = torch.empty((C * Fh * -(-M // 8) * 3 * 8,), dtype=torch.float32, device=dev)
    err = lib.masked_ffn_dw_launch(
        gy.data_ptr(), x.data_ptr(), w_in.data_ptr(), _ptr(w_gate),
        w_out.data_ptr(), row_mask.data_ptr(), dw_in.data_ptr(),
        _ptr(dw_gate), dw_out.data_ptr(), _ptr(scratch), _ptr(core), C, M, d, Fh,
        _ACT_CODE[act], _build.DTYPE_CODE[dtype], geo["groups"],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_ffn_dw kernel launch failed: CUDA error {err}")
    return dw_in, dw_out, dw_gate


def _launch_dw(gy, x, w_in, w_out, row_mask, w_gate, act):
    if tc_route(x):
        dws = _launch_dw_tc(gy, x, w_in, w_out, row_mask, w_gate, act)
    else:
        dws = _launch_dw_ffma(gy, x, w_in, w_out, row_mask, w_gate, act)
    dw_launches.n += 1
    return dws


def _bind_train(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_ffn_train_fwd_launch.argtypes = [p] * 8 + [i] * 7 + [p]
    lib.masked_ffn_train_fwd_launch.restype = i
    lib.masked_ffn_dx_launch.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.masked_ffn_dx_launch.restype = i
    lib.masked_ffn_dw_launch.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.masked_ffn_dw_launch.restype = i
    lib.masked_ffn_fd_resident.argtypes = [i] * 6
    lib.masked_ffn_fd_resident.restype = i


_build.register_binding("masked_ffn_train", _bind_train)


def _bind_train_tc(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.masked_ffn_train_tc_launch.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.masked_ffn_train_tc_launch.restype = i
    lib.masked_ffn_dw_tc_launch.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.masked_ffn_dw_tc_launch.restype = i


_build.register_binding("masked_ffn_train_tc", _bind_train_tc)


def masked_ffn_train_fwd(x, w_in, w_out, row_mask, w_gate=None, *,
                         act="silu"):
    """Forward of the training form (no autograd): CUDA tensors launch the
    kernel, CPU tensors run ``masked_ffn_batch_plain``."""
    if _build.checked_as_card(x):
        _check_train("masked_ffn_train_fwd", x, w_in, w_out, row_mask, w_gate)
    if _build.runs_plain(x):
        return masked_ffn_batch_plain(x, w_in, w_out, row_mask, w_gate, act)
    return _launch_train_fwd(x, w_in, w_out, row_mask, w_gate, act)


def masked_ffn_dx(gy, x, w_in, w_out, row_mask, w_gate=None, *, act="silu"):
    """dL/dx of the training form: CUDA tensors launch the dx kernel, CPU
    tensors run ``masked_ffn_dx_plain``."""
    if _build.checked_as_card(x):
        _check_train("masked_ffn_dx", x, w_in, w_out, row_mask, w_gate, gy)
    if _build.runs_plain(x):
        return masked_ffn_dx_plain(gy, x, w_in, w_out, row_mask, w_gate, act)
    return _launch_dx(gy, x, w_in, w_out, row_mask, w_gate, act)


def masked_ffn_dw(gy, x, w_in, w_out, row_mask, w_gate=None, *, act="silu"):
    """(dW_in, dW_out, dW_gate) of the training form: CUDA tensors launch
    the dW kernel, CPU tensors run ``masked_ffn_dw_plain``."""
    if _build.checked_as_card(x):
        _check_train("masked_ffn_dw", x, w_in, w_out, row_mask, w_gate, gy)
    if _build.runs_plain(x):
        return masked_ffn_dw_plain(gy, x, w_in, w_out, row_mask, w_gate, act)
    return _launch_dw(gy, x, w_in, w_out, row_mask, w_gate, act)


class MaskedFFNTrain(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``_differentiable`` :443): saves only
    (x, weights, mask), and its backward recomputes. The mask's gradient is
    None — it is sub-model structure, not a trained weight."""

    @staticmethod
    def forward(ctx, x, w_in, w_out, row_mask, w_gate, act):
        ctx.act = act
        ctx.save_for_backward(x, w_in, w_out, row_mask, w_gate)
        return masked_ffn_train_fwd(x, w_in, w_out, row_mask, w_gate, act=act)

    @staticmethod
    def backward(ctx, gy):
        x, w_in, w_out, row_mask, w_gate = ctx.saved_tensors
        gy = gy.contiguous()
        dx = masked_ffn_dx(gy, x, w_in, w_out, row_mask, w_gate, act=ctx.act)
        dw_in, dw_out, dw_gate = masked_ffn_dw(gy, x, w_in, w_out, row_mask,
                                               w_gate, act=ctx.act)
        return dx, dw_in, dw_out, None, dw_gate, None


def masked_ffn_train(x, w_in, w_out, row_mask, w_gate=None, *,
                     act: str = "silu"):
    """Client-batched, differentiable per-row-masked FFN: client c's rows
    ``x[c]`` (M, d) go through its own weights ``w_in[c]`` [, ``w_gate[c]``]
    (d, F) and ``w_out[c]`` (F, d) under its own ``row_mask[c]`` (M, F).
    Returns (C, M, d) in ``x.dtype``. F must be a multiple of 128.
    One forward launch, and one dx and one dW launch in the backward, cover
    all C clients (each two on the tensor-core route, ``tc_route``). Tiles that no row of an 8-row m-tile (a 128-row tile on
    that route) keeps are skipped; their dW is exactly 0."""
    _validate_train(x, w_in, w_out, w_gate, row_mask)
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    return MaskedFFNTrain.apply(x, w_in, w_out,
                                row_mask.to(torch.float32).contiguous(),
                                w_gate, act)


def masked_ffn(x, w_in, w_out, block_mask, w_gate=None, *, act: str = "silu"):
    """Block-masked FFN, differentiable: y = (act(x·W_in) [⊙ act(x·W_gate)]
    ⊙ expand(block_mask))·W_out.

    Shapes: ``x`` (M, d); ``w_in`` [, ``w_gate``] (d, F); ``w_out`` (F, d);
    ``block_mask`` (F // 128,), one entry per 128-neuron block, kept where
    > 0. Returns (M, d) in ``x.dtype``. F must be a multiple of 128
    (ValueError otherwise, as the reference). It runs ``MaskedFFNTrain`` at
    C = 1 with every row carrying the expanded block mask: CUDA tensors
    launch the forward, dx and dW kernels once each, CPU tensors run their
    plain versions. Dropped blocks are skipped, and their dW is exactly 0."""
    _validate(x, w_in, w_out, w_gate, block_mask, per_row=False)
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    keep = (torch.as_tensor(block_mask, device=x.device) > 0).to(torch.float32)
    row_mask = keep.repeat_interleave(BLOCK_NEURONS).expand(x.shape[0], -1)
    one = lambda t: None if t is None else t.contiguous()[None]
    y = MaskedFFNTrain.apply(one(x), one(w_in), one(w_out),
                             row_mask.contiguous()[None], one(w_gate), act)
    return y[0]
