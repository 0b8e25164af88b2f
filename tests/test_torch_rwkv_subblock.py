"""The arithmetic of the chunked RWKV-6 scan kernel (B12), on the CPU.

``csrc/rwkv_chunk.cu`` runs two passes. The state pass gives each chunk
its total log decay l_tot and its local state term ΔS = Σ_j (k_j ⊙
e^{l_tot - l_inc,j}) v_jᵀ. The output pass takes 16-row sub-blocks of a
chunk: the diagonal sub-block's scores (and the bonus) one exponential per
(t, j, n); the keys before the sub-block's start t0 in tiles of 64 as a
product of r rescaled by e^{l_exc,t - l_exc,t0} and k rescaled by
e^{l_exc,t0 - l_inc,j}; and the inter term from the chunk's entry state,
which a carry pass gives in chunk order from state_in and the earlier
chunks' (l_tot, ΔS).
The cumsum is taken as the kernel takes it: serial runs within sub-blocks
from boundaries that a prefix over the sub-blocks' sums gives.

A torch emulation of that, in fp32, is held here to the Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and to the per-token
recurrence of ``ref.rwkv_chunk_scan_ref``, at the reference's 2e-4, for
chunks that are and are not multiples of 16 (1, 8, 12, 100, 128, 256),
from a zero state and from an initial state (the Pallas kernel's own state
after a first segment), and at logw = -8, where y and the state must stay
finite. Every exponent the emulation takes is checked to be <= 0: the
factored form never overflows.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv_chunk as rwkv  # noqa: E402

SB, KT = 16, 64                 # csrc/rwkv_chunk.cu: sub-block rows, key tile rows
TOL = dict(rtol=2e-4, atol=2e-4)


def _exp(x):
    """e^x for an exponent the kernel takes as <= 0."""
    assert bool((x <= 0).all()), float(x.max())
    return torch.exp(x)


def _boundaries(w, nb):
    """l_exc at rows 0, SB, ..., SB·nb of a chunk (w (B, c, H, N)): each
    sub-block's serial sum, then the serial prefix over sub-blocks."""
    c = w.shape[1]
    acc = torch.zeros_like(w[:, 0])
    out = [acc]
    for J in range(nb):
        run = torch.zeros_like(acc)
        for t in range(SB * J, min(SB * J + SB, c)):
            run = run + w[:, t]
        acc = acc + run
        out.append(acc)
    return out


def _l_inc(w, lb, J, c):
    """l_inc of sub-block J's rows: its boundary plus the serial run."""
    run, out = torch.zeros_like(lb[J]), []
    for t in range(SB * J, min(SB * J + SB, c)):
        run = run + w[:, t]
        out.append(lb[J] + run)
    return torch.stack(out, 1)


def _state_pass(k, v, w):
    """(l_tot (B, H, N), ΔS (B, H, N, N)) of one chunk."""
    c = k.shape[1]
    nb = -(-c // SB)
    lb = _boundaries(w, nb)
    l_tot = lb[nb]
    l_inc = torch.cat([_l_inc(w, lb, J, c) for J in range(nb)], 1)
    kh = k * _exp(l_tot[:, None] - l_inc)
    return l_tot, torch.einsum("bjhn,bjhm->bhnm", kh, v)


def _out_pass(r, k, v, w, u, S0):
    """y (B, c, H, N) of one chunk from its entry state S0 (B, H, N, N)."""
    c = r.shape[1]
    nb = -(-c // SB)
    y = torch.zeros_like(r)
    for T in range(nb):
        t0, nt = SB * T, min(SB, c - SB * T)
        lb = _boundaries(w, T)
        li = _l_inc(w, lb, T, c)                                  # (B, nt, H, N)
        le = torch.cat([lb[T][:, None], li[:, :-1]], 1)           # l_exc
        rT, kT, vT = r[:, t0:t0 + nt], k[:, t0:t0 + nt], v[:, t0:t0 + nt]
        rtl = rT * _exp(le - lb[T][:, None])
        rh = rT * _exp(le)
        # diagonal sub-block: one exponential per (t, j, n), the bonus at j == t
        tri = torch.arange(nt)[:, None] > torch.arange(nt)[None, :]
        dlog = le[:, :, None] - li[:, None, :]                    # (B, t, j, H, N)
        D = torch.where(tri[None, :, :, None, None], dlog, torch.zeros(()))
        P = torch.einsum("bthn,bjhn,btjhn->bthj", rT, kT, _exp(D))
        P = P * tri[None, :, None, :]
        bonus = torch.einsum("bthn,bthn->bth", rT, u[None, None] * kT)
        P = P + bonus[..., None] * torch.eye(nt)[None, :, None, :]
        yT = torch.einsum("bthj,bjhm->bthm", P, vT)
        # keys before t0, a tile at a time
        for j0 in range(0, t0, KT):
            kn = min(KT, t0 - j0)
            lj = torch.cat([_l_inc(w, lb, J, c) for J in range(j0 // SB, (j0 + kn) // SB)], 1)
            kt = k[:, j0:j0 + kn] * _exp(lb[T][:, None] - lj)
            scores = torch.einsum("bthn,bjhn->bthj", rtl, kt)
            yT = yT + torch.einsum("bthj,bjhm->bthm", scores, v[:, j0:j0 + kn])
        y[:, t0:t0 + nt] = yT + torch.einsum("bthn,bhnm->bthm", rh, S0)
    return y


def emulate(r, k, v, logw, u, chunk, state=None):
    """The kernel's two passes over the sequence: (y, final state)."""
    B, S, H, N = r.shape
    r, k, v, w, u = (t.float() for t in (r, k, v, logw, u))
    parts = [_state_pass(k[:, i:i + chunk], v[:, i:i + chunk], w[:, i:i + chunk])
             for i in range(0, S, chunk)]
    S0 = torch.zeros(B, H, N, N) if state is None else state.float()
    ys = []
    for ch, i in enumerate(range(0, S, chunk)):
        entry = S0                      # the carry, in chunk order
        for l_tot, ds in parts[:ch]:
            entry = _exp(l_tot)[..., None] * entry + ds
        ys.append(_out_pass(r[:, i:i + chunk], k[:, i:i + chunk], v[:, i:i + chunk],
                            w[:, i:i + chunk], u, entry))
    l_tot, ds = parts[-1]
    final = _exp(l_tot)[..., None] * entry + ds
    return torch.cat(ys, 1), final


def _inputs(B, S, H, N, seed, logw=None):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, S, H, N).astype(np.float32) for _ in range(3))
    if logw is None:
        logw = -np.exp(rng.randn(B, S, H, N).astype(np.float32) - 1.0)
    else:
        logw = np.full((B, S, H, N), logw, np.float32)
    u = (0.3 * rng.randn(H, N)).astype(np.float32)
    return r, k, v, logw, u


CHUNKS = [1, 8, 12, 100, 128, 256]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_subblock_scan_matches_pallas_and_naive(chunk, with_state):
    """Two chunks (chunk 1: eight) after, with_state, a first segment of one
    chunk whose final state the Pallas kernel gives: y of the second part
    and the final state against the Pallas kernel and the per-token
    recurrence over the whole sequence."""
    H, N = 2, 16
    n = 8 if chunk == 1 else 2 * chunk
    pre = chunk if with_state else 0
    args = _inputs(1, pre + n, H, N, seed=chunk + 7 * with_state)
    yj, sj = jax_ops.rwkv_chunk_scan(*map(jnp.asarray, args), chunk=chunk)
    yr, sr = ref.rwkv_chunk_scan_ref(*map(jnp.asarray, args))
    state = None
    if with_state:
        head = [jnp.asarray(a[:, :pre]) for a in args[:4]] + [jnp.asarray(args[4])]
        state = torch.from_numpy(np.array(jax_ops.rwkv_chunk_scan(*head, chunk=chunk)[1]))
    tail = [torch.from_numpy(a[:, pre:]) for a in args[:4]] + [torch.from_numpy(args[4])]
    y, st = emulate(*tail, chunk, state)
    for want_y, want_s in ((yj, sj), (yr, sr)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y)[:, pre:], **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("chunk", [128, 256])
def test_subblock_scan_strong_decay_finite(chunk):
    """logw = -8: exponents down to -8·chunk, factors that underflow to 0;
    y and the state finite and equal to the Pallas kernel's."""
    args = _inputs(1, 2 * chunk, 1, 64, seed=8, logw=-8.0)
    y, st = emulate(*map(torch.from_numpy, args), chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    yj, sj = jax_ops.rwkv_chunk_scan(*map(jnp.asarray, args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)


@pytest.mark.parametrize("chunk", [12, 100])
def test_subblock_scan_matches_port_plain_with_state(chunk):
    """From a random initial state: the port's plain version, which the
    kernel is held to on the card."""
    args = [torch.from_numpy(a) for a in _inputs(2, 2 * chunk, 3, 32, seed=chunk)]
    state = 0.5 * torch.from_numpy(np.random.RandomState(1).randn(2, 3, 32, 32)
                                   .astype(np.float32))
    y, st = emulate(*args, chunk, state)
    yp, sp = rwkv.rwkv_chunk_scan_plain(*args, chunk=chunk, state=state)
    torch.testing.assert_close(y, yp, **TOL)
    torch.testing.assert_close(st, sp, **TOL)
