"""Parity of the port's head-masked attention projections with the JAX
reference, on the CPU.

The reference runs ``repro.kernels.masked_attn`` in interpret mode under
``jax.vmap`` over the client axis, as the fleet does; its gradients come
from ``jax.grad`` through its custom VJPs, i.e. through the Pallas
``_proj_dx_kernel``, ``_proj_dw_kernel``, ``_merge_da_kernel`` and
``_proj_dw_kernel`` again. The port gets the same numpy inputs, all
clients in one call; on CPU tensors its wrappers run the kernels' plain
versions, which the CUDA kernels are held to on the card
(tests/test_torch_cuda.py). Tolerance: fp32 rtol 1e-5, atol 1e-6 for the
projections (the sums run in another order); 1e-5 for the whole attention
block, whose softmax adds its own rounding. A dropped head's output slab
and its dW slab must be exactly 0.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import masked_attn as j_attn  # noqa: E402
from repro_torch.kernels import masked_attn as t_attn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
C = 2
MASKS = {"all_kept": [[1, 1, 1, 1], [1, 1, 1, 1]],
         "partial": [[1, 0, 1, 1], [0, 1, 0, 0]],
         "all_dropped": [[0, 0, 0, 0], [0, 0, 0, 0]]}
# (M, din or d, H, hd): the femnist_attn block at one image, at 130 rows
# (two 128-row m-tiles, the second ragged) and at 1100 rows (9 m-tiles, the
# last ragged: more than the 8 blocks of one dW cluster on the card), and a
# narrower odd shape
SHAPES = [(49, 64, 4, 16), (130, 64, 4, 16), (37, 24, 4, 6), (1100, 64, 4, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: the suite runs in
    several worker processes, and per-op thread pools would oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_fn(kind):
    """jit of (forward, grad of <f(a, w, m), gy> w.r.t. a and w), vmapped
    over the client axis."""
    f = {"proj": j_attn.masked_head_proj, "merge": j_attn.masked_head_merge}[kind]
    one = lambda a, w, m: f(a, w, m, interpret=True)
    grad = jax.grad(lambda a, w, m, gy: jnp.sum(one(a, w, m) * gy), argnums=(0, 1))
    return jax.jit(jax.vmap(one)), jax.jit(jax.vmap(grad))


def _inputs(kind, shape, mask_name, seed):
    M, width, H, hd = shape
    N = H * hd
    rng = np.random.RandomState(seed)
    if kind == "proj":                  # x (C, M, din), w (C, din, N), gy (C, M, N)
        a = rng.randn(C, M, width).astype(np.float32)
        w = (rng.randn(C, width, N) / np.sqrt(width)).astype(np.float32)
        gy = rng.randn(C, M, N).astype(np.float32)
    else:                               # a (C, M, N), w (C, N, d), gy (C, M, d)
        a = rng.randn(C, M, N).astype(np.float32)
        w = (rng.randn(C, N, width) / np.sqrt(N)).astype(np.float32)
        gy = rng.randn(C, M, width).astype(np.float32)
    mask = np.asarray(MASKS[mask_name], np.float32)[:, :H]
    return a, w, gy, mask


def _dropped_cols(mask, hd):
    """(C, N) bool: the columns of each client's dropped heads."""
    return np.repeat(mask == 0, hd, axis=1)


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["proj", "merge"])
def test_forward_and_grads_match_jax(kind, shape, mask_name):
    a, w, gy, mask = _inputs(kind, shape, mask_name, seed=shape[0] + len(mask_name))
    fwd, grad = _jax_fn(kind)
    want_y = np.asarray(fwd(a, w, mask))
    want_da, want_dw = (np.asarray(g) for g in grad(a, w, mask, gy))

    at = torch.from_numpy(a).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    f = ops.masked_head_proj if kind == "proj" else ops.masked_head_merge
    y = f(at, wt, torch.from_numpy(mask))
    (y * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    np.testing.assert_allclose(at.grad.numpy(), want_da, **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, **TOL)

    hd = shape[3]
    cols = _dropped_cols(mask, hd)
    if kind == "proj":      # y and dW columns of dropped heads
        assert (y.detach().numpy().transpose(0, 2, 1)[cols] == 0).all()
        assert (wt.grad.numpy().transpose(0, 2, 1)[cols] == 0).all()
    else:                   # da columns and dW_o rows of dropped heads
        assert (at.grad.numpy().transpose(0, 2, 1)[cols] == 0).all()
        assert (wt.grad.numpy()[cols] == 0).all()
    if mask_name == "all_dropped":
        assert not y.detach().any() and not at.grad.any() and not wt.grad.any()


@functools.lru_cache(maxsize=None)
def _jax_attention():
    one = lambda x, wq, wk, wv, wo, m: j_attn.masked_attention(
        x, wq, wk, wv, wo, m, n_heads=4, interpret=True)
    loss = lambda *a: jnp.sum(one(*a[:-1]) * a[-1])
    return (jax.jit(jax.vmap(one)),
            jax.jit(jax.vmap(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))))


@pytest.mark.parametrize("mask_name", ["all_kept", "partial"])
def test_masked_attention_matches_jax(mask_name):
    B, S, d = 2, 49, 64
    rng = np.random.RandomState(11)
    x = rng.randn(C, B, S, d).astype(np.float32)
    ws = [(rng.randn(C, d, d) / np.sqrt(d)).astype(np.float32) for _ in range(4)]
    gy = rng.randn(C, B, S, d).astype(np.float32)
    mask = np.asarray(MASKS[mask_name], np.float32)
    fwd, grad = _jax_attention()
    want_y = np.asarray(fwd(x, *ws, mask))
    want_g = [np.asarray(g) for g in grad(x, *ws, mask, gy)]

    ts = [torch.from_numpy(a).requires_grad_() for a in (x, *ws)]
    y = ops.masked_attention(*ts, torch.from_numpy(mask), 4)
    (y * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5, atol=1e-5)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5, atol=1e-5)
    if mask_name == "partial":          # client 1 keeps head 1 only
        for t in ts[1:4]:
            assert (t.grad[1][:, :16] == 0).all() and (t.grad[1][:, 32:] == 0).all()
        assert (ts[4].grad[1][:16] == 0).all() and (ts[4].grad[1][32:] == 0).all()


@pytest.mark.parametrize("kind", ["proj", "merge", "attention"])
def test_autograd_gradcheck_float64(kind):
    rng = np.random.RandomState(3)
    mk = lambda *s: torch.tensor(rng.randn(*s) * 0.5, dtype=torch.float64,
                                 requires_grad=True)
    mask = torch.tensor([[1.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    if kind == "attention":
        args = (mk(2, 2, 5, 6), mk(2, 6, 6), mk(2, 6, 6), mk(2, 6, 6), mk(2, 6, 6))
        f = lambda *a: ops.masked_attention(*a, mask, 3)
    elif kind == "proj":
        args = (mk(2, 130, 5), mk(2, 5, 6))
        f = lambda x, w: ops.masked_head_proj(x, w, mask)
    else:
        args = (mk(2, 130, 6), mk(2, 6, 5))
        f = lambda a, w: ops.masked_head_merge(a, w, mask)
    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-7)


def test_autograd_on_cpu_runs_the_plain_versions():
    a, w, gy, mask = _inputs("proj", SHAPES[1], "partial", 5)
    at, wt = (torch.from_numpy(v).requires_grad_() for v in (a, w))
    t = [torch.from_numpy(v) for v in (a, w, gy, mask)]
    ops.reset_launch_counts()
    y = ops.masked_head_proj(at, wt, t[3])
    (y * t[2]).sum().backward()
    assert torch.equal(y.detach(), t_attn.masked_head_proj_plain(t[0], t[1], t[3]))
    assert torch.equal(at.grad, t_attn.masked_head_proj_dx_plain(t[2], t[1], t[3]))
    assert torch.equal(wt.grad, t_attn.masked_head_proj_dw_plain(t[2], t[0], t[3]))

    a, w, gy, mask = _inputs("merge", SHAPES[1], "partial", 6)
    at, wt = (torch.from_numpy(v).requires_grad_() for v in (a, w))
    t = [torch.from_numpy(v) for v in (a, w, gy, mask)]
    y = ops.masked_head_merge(at, wt, t[3])
    (y * t[2]).sum().backward()
    assert torch.equal(y.detach(), t_attn.masked_head_merge_plain(t[0], t[1], t[3]))
    assert torch.equal(at.grad, t_attn.masked_head_merge_da_plain(t[2], t[1], t[3]))
    assert torch.equal(wt.grad, t_attn.masked_head_merge_dw_plain(t[2], t[0], t[3]))
    assert set(ops.launch_counts().values()) == {0}     # no kernel on the CPU


def test_validation_errors_match_reference():
    x, w = np.zeros((49, 64), np.float32), np.zeros((64, 64), np.float32)
    with pytest.raises(ValueError, match="must divide evenly into H=3 heads"):
        j_attn.masked_head_proj(x, w, np.ones(3))
    xt, wt, mt = torch.zeros(2, 49, 64), torch.zeros(2, 64, 64), torch.ones(2, 4)
    for f in (ops.masked_head_proj, ops.masked_head_merge):
        with pytest.raises(ValueError, match=r"x must be \(C, M, din\), got \(49, 64\)"):
            f(xt[0], wt, mt)
        with pytest.raises(ValueError, match=r"w must be \(C=2, 64, dout\), got \(2, 32, 64\)"):
            f(xt, wt[:, :32], mt)
        with pytest.raises(ValueError, match=r"head_mask must be \(C=2, H\) 0/1, got \(4,\)"):
            f(xt, wt, mt[0])
        with pytest.raises(ValueError, match="must divide evenly into H=3 heads"):
            f(xt, wt, torch.ones(2, 3))
    with pytest.raises(ValueError, match=r"w axis 2 \(62\) must divide evenly into H=4"):
        ops.masked_head_proj(xt, wt[..., :62], mt)
    with pytest.raises(ValueError, match=r"w axis 1 \(64\) must divide evenly into H=5"):
        ops.masked_head_merge(xt, wt, torch.ones(2, 5))
    with pytest.raises(ValueError, match=r"head_mask must be \(C=2, n_heads=4\)"):
        ops.masked_attention(xt.reshape(2, 1, 49, 64), wt, wt, wt, wt, mt[:, :3], 4)
