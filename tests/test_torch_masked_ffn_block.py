"""The block-masked ``masked_ffn`` entry of the port against the JAX
reference, on the CPU.

The reference's ``repro.kernels.ops.masked_ffn`` runs its Pallas forward,
dx and dW kernels in interpret mode with one (F/128,) mask for every row.
The port runs the client-batched training kernels' plain versions at
C = 1 with the block mask expanded to a row mask. Both get the same numpy
inputs; the forward and ``jax.grad`` / autograd gradients of <y, gy> must
agree for all four activations, gated and not, under ordered, scattered
and all-dropped block masks. Tolerance: fp32 rtol 1e-5, atol 1e-6 (sums in
another order); x at half scale, as tests/test_torch_train_kernels.py
explains. A dropped block's dW is exactly 0.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
M, D, F = 13, 64, 512
BLOCK_MASKS = {"ordered": [1, 1, 0, 0], "scattered": [0, 1, 0, 1],
               "all_dropped": [0, 0, 0, 0]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_fwd_grad(act, gated):
    """jit of the forward and of grad <masked_ffn(...), gy> w.r.t. x and
    the weights."""
    def fwd(x, wi, wo, wg, bm):
        return jax_ops.masked_ffn(x, wi, wo, bm, w_gate=wg, act=act)

    def loss(x, wi, wo, wg, bm, gy):
        return jnp.sum(fwd(x, wi, wo, wg, bm) * gy)
    return jax.jit(fwd), jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3) if gated else (0, 1, 2)))


def _inputs(gated, seed):
    rng = np.random.RandomState(seed)
    x = (0.5 * rng.randn(M, D)).astype(np.float32)
    gy = rng.randn(M, D).astype(np.float32)
    w_in = (rng.randn(D, F) / np.sqrt(D)).astype(np.float32)
    w_out = (rng.randn(F, D) / np.sqrt(F)).astype(np.float32)
    w_gate = (rng.randn(D, F) / np.sqrt(D)).astype(np.float32) if gated else None
    return x, gy, w_in, w_out, w_gate


@pytest.mark.parametrize("mask_name", list(BLOCK_MASKS))
@pytest.mark.parametrize("act", ["relu", "relu2", "gelu", "silu"])
@pytest.mark.parametrize("gated", [False, True])
def test_forward_and_grads_match_jax(gated, act, mask_name):
    x, gy, w_in, w_out, w_gate = _inputs(gated, seed=len(act) + 10 * gated)
    bm = np.asarray(BLOCK_MASKS[mask_name], np.int32)
    fwd, grad = _jax_fwd_grad(act, gated)
    jargs = [jnp.asarray(a) if a is not None else None for a in (x, w_in, w_out, w_gate)]
    want_y = np.asarray(fwd(*jargs, jnp.asarray(bm)))
    want_g = [np.asarray(g) for g in grad(*jargs, jnp.asarray(bm), jnp.asarray(gy))]

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w_in, w_out)]
    wg = torch.from_numpy(w_gate).requires_grad_() if gated else None
    y = ops.masked_ffn(*leaves, torch.from_numpy(bm), w_gate=wg, act=act)
    (y * torch.from_numpy(gy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL)
    got_g = [t.grad.numpy() for t in leaves] + ([wg.grad.numpy()] if gated else [])
    assert len(got_g) == len(want_g)
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got, want, **TOL)
    dropped = np.repeat(bm == 0, 128)
    assert (leaves[1].grad.numpy()[:, dropped] == 0).all()
    assert (leaves[2].grad.numpy()[dropped] == 0).all()
    if gated:
        assert (wg.grad.numpy()[:, dropped] == 0).all()
    if mask_name == "all_dropped":
        assert (y.detach() == 0).all()


def test_block_mask_validation_matches_reference():
    x = torch.zeros(4, D)
    w_in, w_out = torch.zeros(D, F), torch.zeros(F, D)
    jx, jwi, jwo = (jnp.zeros(t.shape) for t in (x, w_in, w_out))
    bad = [(torch.ones(3), jnp.ones(3)),                 # wrong block count
           (torch.ones(F), jnp.ones(F))]                 # a neuron mask
    for tmask, jmask in bad:
        with pytest.raises(ValueError) as port:
            ops.masked_ffn(x, w_in, w_out, tmask)
        with pytest.raises(ValueError) as ref:
            jax_ops.masked_ffn(jx, jwi, jwo, jmask)
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="multiple of"):
        ops.masked_ffn(x, torch.zeros(D, 200), torch.zeros(200, D), torch.ones(1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_neuron_mask_to_block_mask_matches_reference(seed):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(F) < 0.01 * (seed + 1)).astype(np.float32)
    mask[:128] = 0.0
    got = ops.neuron_mask_to_block_mask(mask)
    want = jax_ops.neuron_mask_to_block_mask(mask)
    assert got.dtype == want.dtype and np.array_equal(got, want)
