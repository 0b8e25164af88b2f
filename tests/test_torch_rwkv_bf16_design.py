"""The arithmetic of B12's bf16 chunk form on the card (``rwkv_out_bf16_kernel``
in ``csrc/rwkv_chunk.cu``), on the CPU.

The kernel takes the score of query t and key j < t literally,

    s_tj = bf16( Σ_n bf16(bf16(r_tn) · bf16(k_jn)) · bf16(e^{l_exc,tn - l_inc,jn}) ),

in its own order: l_inc and l_exc from the sub-block boundaries and serial
runs of the state pass; each exponent formed as (l_exc - l_inc) · log2(e)
and never clamped (it is <= 0 for every j < t, which is checked here); r·k
rounded once from the exact product (``mul.rn.bf16x2``, which the card
shows equal to the fp32 product rounded to bf16 for every pair of bf16
values); the products summed sixteen n at a time, as the kernel's
``mma.sync`` m16n8k16 steps group them, the sixteen-sums in order of n; the
score rounded to bf16; scores · V in sixteen-key fragments; the bonus as eight
partial sums of N/8 products added in a butterfly; the inter term
(r ⊙ e^{l_exc}) S0 last, n in order.

A torch emulation of that order is held here to the reference's
``_chunk_core`` at ``chunk_dtype=bfloat16`` (through JAX on the CPU) and
to the port's plain bf16 form, within chip_smoke's ``RWKV_BF16_TOL``
(relative 2-norm 5e-4, ∞-norm 1e-2: a score whose bf16 rounding flips
between two orders of an fp32 sum is a sparse error), for chunks 40, 48,
128 and 256 (not all multiples of 16; 256 is two key tiles of the
kernel), N 16, 32 and 64, from a zero and a non-zero state, and at logw =
-8. The emulation's exponentials are exact exp2 where the kernel's are
``ex2.approx`` (relative error about 2^-22), and each sixteen-sum is torch's
fp32 sum, rounded to nearest: a model of the tensor core's order, not of
its arithmetic, which aligns and truncates its products' sum in its own
way. Only the card tests (``tests/test_torch_cuda.py``) check the kernel's
own rounding.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import rwkv6 as jax_rwkv  # noqa: E402
from repro_torch.kernels import rwkv_chunk as rwkv  # noqa: E402

SB = 16                         # csrc/rwkv_chunk.cu: sub-block rows, mma depth
LOG2E = np.float32(1.4426950408889634)
TOL = dict(rel2=5e-4, inf=1e-2)  # chip_smoke.py RWKV_BF16_TOL (y)

bf = lambda x: x.to(torch.bfloat16).float()


def _l_inc_exc(w):
    """(l_inc, l_exc) of one chunk (w (B, c, H, N)) as the kernel forms
    them: each sub-block's serial sum, a serial prefix over sub-blocks for
    the boundaries, then each row's serial run from its boundary; l_exc of
    a row is the run before it (its boundary for the sub-block's first)."""
    B, c, H, N = w.shape
    nb = -(-c // SB)
    lb = [torch.zeros(B, H, N)]
    for J in range(nb):
        run = torch.zeros(B, H, N)
        for i in range(SB * J, min(SB * J + SB, c)):
            run = run + w[:, i]
        lb.append(lb[-1] + run)
    li, le = [], []
    for J in range(nb):
        run = torch.zeros(B, H, N)
        for i in range(SB * J, min(SB * J + SB, c)):
            le.append(lb[J] + run)
            run = run + w[:, i]
            li.append(lb[J] + run)
    return torch.stack(li, 1), torch.stack(le, 1)


def _bonus(r, k, u):
    """r_t · (u ⊙ k_t): eight partial sums of N/8 products each (n in
    order), added in the kernel's xor butterfly (lane 0's order)."""
    N = r.shape[-1]
    p = (r * (u * k)).reshape(*r.shape[:-1], 8, N // 8)
    parts = [torch.zeros(r.shape[:-1])] * 8
    for x in range(8):
        for i in range(N // 8):
            parts[x] = parts[x] + p[..., x, i]
    for step in (1, 2, 4):
        parts = [parts[x] + parts[x ^ step] for x in range(8)]
    return parts[0]


def emulate_chunk(r, k, v, w, u, S0):
    """One chunk of the bf16 form in the kernel's order: y (B, c, H, N)."""
    B, c, H, N = r.shape
    li, le = _l_inc_exc(w)
    tri = (torch.arange(c)[:, None] > torch.arange(c)[None, :])[None, :, :, None, None]
    x = (le[:, :, None] - li[:, None, :]) * LOG2E            # (B, t, j, H, N)
    assert bool((x[tri.expand_as(x)] <= 0).all()), "an exponent of j < t is positive"
    D = torch.where(tri, bf(torch.exp2(x)), torch.zeros(()))
    rk = bf(bf(r)[:, :, None] * bf(k)[:, None])
    prod = (rk * D).reshape(B, c, c, H, N // SB, SB)
    acc = torch.zeros(B, c, c, H)
    for s in range(N // SB):                                  # a fragment a step
        acc = acc + prod[..., s, :].sum(-1)
    scores = bf(acc)                                          # (B, t, j, H)
    y = torch.zeros(B, c, H, N)
    for j0 in range(0, c, SB):
        y = y + torch.einsum("btjh,bjhm->bthm", scores[:, :, j0:j0 + SB], v[:, j0:j0 + SB])
    y = y + _bonus(r, k, u)[..., None] * v
    rh = r * torch.exp(le)
    for n in range(N):
        y = y + rh[..., n, None] * S0[:, None, :, n, :]
    return y


def emulate(r, k, v, logw, u, chunk, state=None):
    """The form over the sequence: y, with each chunk's entry state from
    the plain form's state update (shared with the fp32 form)."""
    B, S, H, N = r.shape
    S0 = torch.zeros(B, H, N, N) if state is None else state
    ys = []
    for i in range(0, S, chunk):
        sl = slice(i, i + chunk)
        ys.append(emulate_chunk(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u, S0))
        _, S0 = rwkv._chunk_core(r[:, sl], k[:, sl], v[:, sl], logw[:, sl], u, S0)
    return torch.cat(ys, 1)


def reference(r, k, v, logw, u, chunk, state=None):
    """The reference's _chunk_core at chunk_dtype=bfloat16 over the chunks."""
    B, S, H, N = r.shape
    S0 = jnp.zeros((B, H, N, N), jnp.float32) if state is None else jnp.asarray(state)
    ys = []
    for i in range(0, S, chunk):
        y, S0 = jax_rwkv._chunk_core(*(jnp.asarray(a[:, i:i + chunk]) for a in (r, k, v, logw)),
                                     jnp.asarray(u), S0, chunk_dtype=jnp.bfloat16)
        ys.append(np.asarray(y))
    return np.concatenate(ys, 1)


def _inputs(B, S, H, N, seed, logw=None, with_state=False):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, S, H, N).astype(np.float32) for _ in range(3))
    if logw is None:            # RWKV-6's decay range, as chip_smoke draws it
        w = rng.rand(H, N).astype(np.float32) * 5 - 6 + 0.1 * rng.randn(B, S, H, N)
        logw = -np.exp(w).astype(np.float32)
    else:
        logw = np.full((B, S, H, N), logw, np.float32)
    u = (0.1 * rng.randn(H, N)).astype(np.float32)
    state = (0.5 * rng.randn(B, H, N, N)).astype(np.float32) if with_state else None
    return r, k, v, logw, u, state


def _errs(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return {"rel2": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            "inf": float(np.abs(got - want).max() / np.abs(want).max())}


CASES = [  # (S, H, N, chunk, logw, with_state)
    (80, 2, 16, 40, None, False), (96, 2, 32, 48, None, True), (128, 1, 64, 128, None, False),
    (128, 1, 16, 128, None, True), (256, 1, 32, 256, None, False), (128, 1, 64, 128, -8.0, True),
    (48, 3, 64, 48, -8.0, False)]


@pytest.mark.parametrize("S,H,N,chunk,logw,with_state", CASES)
def test_bf16_design_matches_reference_and_plain(S, H, N, chunk, logw, with_state):
    """The emulation against the reference's bf16 _chunk_core (JAX, CPU)
    and the port's plain bf16 form, within RWKV_BF16_TOL; finite."""
    r, k, v, lw, u, state = _inputs(1, S, H, N, seed=S + N + chunk, logw=logw,
                                    with_state=with_state)
    t = lambda a: None if a is None else torch.from_numpy(a)
    y = emulate(t(r), t(k), t(v), t(lw), t(u), chunk, t(state))
    assert bool(torch.isfinite(y).all())
    want = reference(r, k, v, lw, u, chunk, state)
    yp, _ = rwkv.rwkv_chunk_scan_plain(t(r), t(k), t(v), t(lw), t(u), chunk=chunk,
                                       state=t(state), chunk_dtype=torch.bfloat16)
    for ref_y in (want, yp.numpy()):
        errs = _errs(y.numpy(), ref_y)
        assert all(errs[key] <= tol for key, tol in TOL.items()), errs


def test_bf16_design_is_the_bf16_form_not_the_fp32_form():
    """The emulation's roundings are real: it lies far nearer the bf16
    form than the fp32 form does."""
    r, k, v, lw, u, _ = _inputs(1, 128, 1, 64, seed=11)
    t = torch.from_numpy
    y = emulate(t(r), t(k), t(v), t(lw), t(u), 128)
    y32, _ = rwkv.rwkv_chunk_scan_plain(t(r), t(k), t(v), t(lw), t(u), chunk=128)
    ybf, _ = rwkv.rwkv_chunk_scan_plain(t(r), t(k), t(v), t(lw), t(u), chunk=128,
                                        chunk_dtype=torch.bfloat16)
    assert _errs(y.numpy(), ybf.numpy())["rel2"] * 10 < _errs(y32.numpy(), ybf.numpy())["rel2"]


@pytest.mark.parametrize("chunk", [40, 48, 128, 256])
def test_bf16_items_balance_the_pairs(chunk):
    """A block of the output kernel takes an item, a pair of sub-blocks T
    and nb-1-T: bf16_items counts them, and where the chunk is whole
    sub-blocks every pair scores as many (t, j) pairs below the diagonal."""
    nb = -(-chunk // SB)
    assert rwkv.bf16_items(2, 4 * chunk, 3, chunk) == 2 * 3 * 4 * ((nb + 1) // 2)
    rows = lambda T: sum(range(SB * T, min(SB * T + SB, chunk)))
    pairs = [rows(T) + rows(nb - 1 - T) for T in range(nb // 2)]
    if chunk % SB == 0:
        assert len(set(pairs)) == 1
    assert sum(pairs) + (rows(nb // 2) if nb % 2 else 0) == chunk * (chunk - 1) // 2
