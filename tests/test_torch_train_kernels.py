"""Parity of the port's training-form masked FFN with the JAX reference, on
the CPU.

The reference's gradients come from ``jax.grad`` through
``repro.kernels.masked_ffn.masked_ffn_batch`` in interpret mode, i.e.
through its Pallas ``_dx_kernel`` and ``_dw_kernel``. The port's plain dx
and dW versions — what its wrappers run on CPU tensors and what the CUDA
kernels are held to on the card (tests/test_torch_cuda.py) — get the same
numpy inputs, one client at a time in the reference and all clients in one
call in the port. Tolerance: fp32 rtol 1e-5, atol 1e-6 (the sums run in
another order).

x is drawn at half the unit scale. XLA's fp32 tanh on the CPU is off by up
to 2.6e-7 from float64 (torch's by 3e-8), and the gelu derivative's
1 - tanh² amplifies that to 3.8e-6 where |z| is 2 to 4; at unit-scale
pre-activations a few dW elements then differ by 1.5e-6 for that reason
alone.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.masked_ffn import masked_ffn_batch as jax_masked_ffn_batch  # noqa: E402
from repro_torch.core.dropout import get_policy  # noqa: E402
from repro_torch.kernels import masked_ffn as tq_ffn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
C, D = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: the suite runs in
    several worker processes, and per-op thread pools would oversubscribe
    the cores (gradcheck ran 75x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_grads(act, gated):
    """jit(grad) of <masked_ffn_batch(...), gy> w.r.t. x and the weights."""
    def loss(x, wi, wo, wg, m, gy):
        y = jax_masked_ffn_batch(x, wi, wo, m, w_gate=wg, act=act,
                                 interpret=True)
        return jnp.sum(y * gy)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3) if gated else (0, 1, 2)))


def _masks(kind, M, F, rng):
    """(C, M, F) row masks of one kind for every client."""
    spec = [{"name": "ffn", "size": F, "out": [], "in": []}]
    if kind == "all_kept":
        rows = np.ones((C, M, F), np.float32)
    elif kind == "ordered":              # rate 0.5: whole blocks dropped
        keep = get_policy("ordered", spec).keep_map(0.5)["ffn"]
        rows = np.zeros((C, M, F), np.float32)
        rows[:, :, keep] = 1.0
    elif kind == "scattered":            # rate 0.75 of random neurons
        pol = get_policy("random", spec, seed=M)
        rows = np.zeros((C, M, F), np.float32)
        for c in range(C):
            rows[c, :, pol.keep_map(0.75)["ffn"]] = 1.0
    else:                                # per-row masks, one row all zero
        rows = (rng.rand(C, M, F) < 0.6).astype(np.float32)
        rows[:, 3] = 0.0
    return rows


def _inputs(M, F, gated, kind, seed):
    rng = np.random.RandomState(seed)
    x = (0.5 * rng.randn(C, M, D)).astype(np.float32)
    gy = rng.randn(C, M, D).astype(np.float32)
    w_in = (rng.randn(C, D, F) / np.sqrt(D)).astype(np.float32)
    w_out = (rng.randn(C, F, D) / np.sqrt(F)).astype(np.float32)
    w_gate = (rng.randn(C, D, F) / np.sqrt(D)).astype(np.float32) if gated else None
    return x, gy, w_in, w_out, w_gate, _masks(kind, M, F, rng)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["all_kept", "ordered", "scattered",
                                  "zero_row"])
@pytest.mark.parametrize("M", [10, 13])
@pytest.mark.parametrize("F", [256, 1024])
@pytest.mark.parametrize("act", ["relu", "relu2", "gelu", "silu"])
@pytest.mark.parametrize("gated", [False, True])
def test_plain_dx_dw_match_jax_grad(gated, act, F, M, kind):
    x, gy, w_in, w_out, w_gate, mask = _inputs(M, F, gated, kind, seed=F + M)
    grad = _jax_grads(act, gated)
    want = []
    for c in range(C):
        args = [jnp.asarray(a[c]) for a in (x, w_in, w_out)]
        args.append(None if w_gate is None else jnp.asarray(w_gate[c]))
        want.append([np.asarray(g) for g in
                     grad(*args, jnp.asarray(mask[c]), jnp.asarray(gy[c]))])
    t = [_t(a) for a in (gy, x, w_in, w_out, mask, w_gate)]
    dx = tq_ffn.masked_ffn_dx_plain(*t, act=act).numpy()
    dw_in, dw_out, dw_gate = tq_ffn.masked_ffn_dw_plain(*t, act=act)
    for c in range(C):
        np.testing.assert_allclose(dx[c], want[c][0], **TOL)
        np.testing.assert_allclose(dw_in[c].numpy(), want[c][1], **TOL)
        np.testing.assert_allclose(dw_out[c].numpy(), want[c][2], **TOL)
        if gated:
            np.testing.assert_allclose(dw_gate[c].numpy(), want[c][3], **TOL)
    assert dw_gate is None or gated


@pytest.mark.parametrize("gated", [False, True])
def test_dropped_block_dw_is_exactly_zero(gated):
    x, gy, w_in, w_out, w_gate, mask = _inputs(13, 512, gated, "ordered", 1)
    mask[1, :, 256:384] = 0.0            # client 1 also drops block 2
    t = [_t(a) for a in (gy, x, w_in, w_out, mask, w_gate)]
    dws = tq_ffn.masked_ffn_dw_plain(*t, act="gelu")
    for c, dropped in ((0, slice(256, 512)), (1, slice(256, 512))):
        assert (dws[0][c][:, dropped] == 0).all()
        assert (dws[1][c][dropped] == 0).all()
        if gated:
            assert (dws[2][c][:, dropped] == 0).all()
    assert (dws[0][0][:, :256] != 0).any()


@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True),
                                       ("relu2", False)])
def test_autograd_function_gradcheck_float64(act, gated):
    rng = np.random.RandomState(7)
    c, M, d, F = 2, 5, 6, 128
    mk = lambda *s, scale=1.0: torch.tensor(rng.randn(*s) * scale,
                                            dtype=torch.float64,
                                            requires_grad=True)
    x, w_in, w_out = mk(c, M, d), mk(c, d, F, scale=0.5), mk(c, F, d, scale=0.1)
    w_gate = mk(c, d, F, scale=0.5) if gated else None
    mask = torch.tensor((rng.rand(c, M, F) < 0.7), dtype=torch.float32)
    mask[1, :, :] = 0.0
    mask[0, 2] = 0.0

    def f(x, w_in, w_out, *wg):
        return ops.masked_ffn_train(x, w_in, w_out, mask,
                                    w_gate=wg[0] if wg else None, act=act)
    args = (x, w_in, w_out) + ((w_gate,) if gated else ())
    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-7)


def test_autograd_on_cpu_runs_the_plain_versions():
    x, gy, w_in, w_out, _, mask = _inputs(10, 256, False, "zero_row", 3)
    xt, wi, wo = (torch.from_numpy(a).requires_grad_() for a in (x, w_in, w_out))
    ops.reset_launch_counts()
    y = ops.masked_ffn_train(xt, wi, wo, torch.from_numpy(mask), act="silu")
    (y * torch.from_numpy(gy)).sum().backward()
    t = [_t(a) for a in (gy, x, w_in, w_out, mask)]
    assert torch.equal(y.detach(), tq_ffn.masked_ffn_batch_plain(
        *t[1:], act="silu"))
    assert torch.equal(xt.grad, tq_ffn.masked_ffn_dx_plain(*t, act="silu"))
    dws = tq_ffn.masked_ffn_dw_plain(*t, act="silu")
    assert torch.equal(wi.grad, dws[0]) and torch.equal(wo.grad, dws[1])
    assert set(ops.launch_counts().values()) == {0}     # no kernel on the CPU


def test_batched_validation_errors():
    x = torch.zeros(2, 4, 64)
    wi, wo, m = torch.zeros(2, 64, 256), torch.zeros(2, 256, 64), torch.ones(2, 4, 256)
    f = ops.masked_ffn_train
    with pytest.raises(ValueError, match=r"x must be \(C, M, d\), got shape \(4, 64\)"):
        f(x[0], wi, wo, m)
    with pytest.raises(ValueError, match=r"w_in must be \(C=2, d=64, F\), got \(2, 32, 256\)"):
        f(x, wi[:, :32], wo, m)
    with pytest.raises(ValueError, match="F=200 must be a multiple of BLOCK_NEURONS=128"):
        f(x, wi[..., :200], wo[:, :200], m[..., :200])
    with pytest.raises(ValueError, match=r"w_out must be \(C=2, F=256, d=64\), got \(2, 64, 256\)"):
        f(x, wi, wi, m)
    with pytest.raises(ValueError, match=r"w_gate must be \(C=2, d=64, F=256\), got \(2, 256, 64\)"):
        f(x, wi, wo, m, w_gate=wo)
    with pytest.raises(ValueError, match=r"row_mask must be \(C=2, M=4, F=256\) — one 0/1 "
                                         r"neuron mask per row of x — got \(2, 256\)"):
        f(x, wi, wo, m[:, 0])
    with pytest.raises(ValueError, match="act must be one of"):
        f(x, wi, wo, m, act="tanh")
