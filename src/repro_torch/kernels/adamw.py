"""AdamW's update of one params leaf in place (the port's
``optim.adamw().update`` hands each leaf here).

``adamw_update`` dispatches on where its tensors lie: on CUDA tensors it
launches the hand-written kernel in ``csrc/adamw.cu`` (one pass that reads
p, g, m and v and writes p, m and v once, with no temporaries; it replaces
no Pallas kernel, the reference's AdamW being plain ``jnp`` that XLA fuses)
and counts the launch; on CPU tensors it runs ``adamw_plain``; on meta
tensors (the dry-run's) it applies the launch's checks, then runs
``adamw_plain``. There is no fallback from the card to the plain version.
The kernel takes the plain version's operations in its order, each rounded
as PyTorch rounds it, so both give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = _build.LaunchCounter()


@torch.no_grad()
def adamw_plain(p, g, m, v, bc1, bc2, b1, b2, eps, weight_decay, lr):
    """Plain version, in place: m, v (fp32) and p take one AdamW step from
    g; bc1, bc2 are the bias corrections 1 - b1**t, 1 - b2**t as fp32
    tensors (the reference's ``repro/optim/optim.py::adamw``)."""
    gf = g.float()
    m.mul_(b1).add_(gf.mul(1 - b1))
    v.mul_(b2).add_(gf.square().mul_(1 - b2))
    step = m.div(bc1).div_(v.div(bc2).sqrt_().add_(eps))
    if weight_decay:
        step.add_(p.float().mul(weight_decay))
    p.sub_(step.mul_(lr).to(p.dtype))


def _bind(lib):
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.adamw_launch.argtypes = [p] * 6 + [ll, i, i] + [f] * 6 + [i, f, i, p]
    lib.adamw_launch.restype = i


_build.register_binding("adamw", _bind)


def _check(p, g, m, v, bc1, bc2):
    """The launch's refusals (a ValueError)."""
    dev = p.device
    for name, t in (("p", p), ("g", g)):
        if t.dtype not in _build.DTYPE_CODE:
            raise ValueError(f"adamw kernel takes {name} of {list(_build.DTYPE_CODE)}, "
                             f"got {t.dtype}")
        _build.check_operand(name, t, t.dtype, dev)
    for name, t in (("m", m), ("v", v)):
        _build.check_operand(name, t, torch.float32, dev)
    for name, t in (("bc1", bc1), ("bc2", bc2)):
        if t.numel() != 1:
            raise ValueError(f"{name} must hold one value, got shape {tuple(t.shape)}")
        _build.check_operand(name, t, torch.float32, dev)
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p {tuple(p.shape)}")


def _launch(p, g, m, v, bc1, bc2, b1, b2, eps, weight_decay, lr):
    n = p.numel()
    if n == 0:
        return
    dev = p.device
    err = _build.load("adamw").adamw_launch(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
        n, _build.DTYPE_CODE[p.dtype], _build.DTYPE_CODE[g.dtype],
        b1, b2, 1 - b1, 1 - b2, eps, weight_decay, int(bool(weight_decay)), lr,
        _build.sm_count(dev), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adamw kernel launch failed: CUDA error {err}")
    launches.n += 1


def adamw_update(p, g, m, v, bc1, bc2, *, b1, b2, eps, weight_decay, lr):
    """One AdamW step of a leaf, in place: p (fp32 or bf16), g (fp32 or
    bf16), m and v (fp32) of one shape, bc1 and bc2 one-value fp32 tensors
    on p's device; the hyperparameters Python numbers. CUDA tensors launch
    the kernel (every operand contiguous and 16-byte aligned), CPU tensors
    run the plain version, meta tensors take the launch's checks and then
    the plain version."""
    if _build.checked_as_card(p):
        _check(p, g, m, v, bc1, bc2)
    if _build.runs_plain(p):
        adamw_plain(p, g, m, v, bc1, bc2, b1, b2, eps, weight_decay, lr)
        return
    _launch(p, g, m, v, bc1, bc2, b1, b2, eps, weight_decay, lr)
