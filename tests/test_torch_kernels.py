"""Kernel parity of the PyTorch port against the JAX reference, on the CPU.

The same numpy inputs go through the reference's Pallas kernels (interpret
mode, as tests/test_kernels.py runs them) and through the port's plain
versions, which are what the port's wrappers run on CPU tensors and what
the CUDA kernels are held to on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerance 1e-5 in fp32: the sums run in another order.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_gqa import decode_gqa as jax_decode_gqa  # noqa: E402
from repro.kernels.masked_ffn import masked_ffn_batch as jax_masked_ffn_batch  # noqa: E402
from repro_torch.kernels import decode_gqa as tq_gqa  # noqa: E402
from repro_torch.kernels import masked_ffn as tq_ffn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _ffn_inputs(M, d, F, gated, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, d).astype(np.float32)
    w_in = (rng.randn(d, F) / np.sqrt(d)).astype(np.float32)
    w_out = (rng.randn(F, d) / np.sqrt(F)).astype(np.float32)
    w_gate = (rng.randn(d, F) / np.sqrt(d)).astype(np.float32) if gated else None
    # mixed rates per row: full, ~half, ~quarter, random neurons, all dropped
    rates = [1.0, 0.5, 0.25, 0.6, 0.0]
    mask = np.stack([(rng.rand(F) < r).astype(np.float32) for r in rates[:M]])
    mask[2, :128] = 0.0          # one whole f-block dropped by row 2
    return x, w_in, w_out, w_gate, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("F", [256, 384])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("act", ["relu", "relu2", "gelu", "silu"])
def test_masked_ffn_batch_plain_matches_pallas(act, gated, F):
    ops.reset_launch_counts()
    x, w_in, w_out, w_gate, mask = _ffn_inputs(5, 64, F, gated, seed=F)
    want = np.asarray(jax_masked_ffn_batch(
        jnp.asarray(x), jnp.asarray(w_in), jnp.asarray(w_out),
        jnp.asarray(mask), w_gate=None if w_gate is None else jnp.asarray(w_gate),
        act=act, interpret=True))
    plain = tq_ffn.masked_ffn_batch_plain(_t(x), _t(w_in), _t(w_out), _t(mask),
                                          _t(w_gate), act).numpy()
    got = ops.masked_ffn_batch(_t(x), _t(w_in), _t(w_out), _t(mask),
                               w_gate=_t(w_gate), act=act).numpy()
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_array_equal(got, plain)       # CPU dispatch = plain
    assert (plain[4] == 0.0).all()                  # all-dropped row: exact 0
    assert ops.launch_counts() == {name: 0 for name in ops.LAUNCHES}


@pytest.mark.parametrize("case", ["unaligned_F", "row_mask_shape"])
def test_masked_ffn_batch_errors_match_reference(case):
    F = 200 if case == "unaligned_F" else 256
    x, w_in, w_out, w_gate, _ = _ffn_inputs(5, 64, F, True, seed=1)
    mask = np.ones((5, 128) if case == "row_mask_shape" else (5, F), np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_masked_ffn_batch(jnp.asarray(x), jnp.asarray(w_in),
                             jnp.asarray(w_out), jnp.asarray(mask),
                             w_gate=jnp.asarray(w_gate), interpret=True)
    with pytest.raises(ValueError) as port_err:
        ops.masked_ffn_batch(_t(x), _t(w_in), _t(w_out), _t(mask),
                             w_gate=_t(w_gate))
    assert str(port_err.value) == str(jax_err.value)
    if case == "unaligned_F":
        assert "multiple of BLOCK_NEURONS=128" in str(port_err.value)


@pytest.mark.parametrize("lengths", ["one", "ragged", "full"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_gqa_plain_matches_pallas(G, lengths):
    ops.reset_launch_counts()
    B, KV, hd, C = 3, 2, 16, 40
    rng = np.random.RandomState(10 * G + len(lengths))
    q = rng.randn(B, KV * G, hd).astype(np.float32)
    k = rng.randn(B, C, KV, hd).astype(np.float32)
    v = rng.randn(B, C, KV, hd).astype(np.float32)
    lens = {"one": np.ones(B), "full": np.full(B, C),
            "ragged": np.array([1, 17, 33])}[lengths].astype(np.int32)
    pallas = np.asarray(jax_decode_gqa(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens),
                                       block_c=16, interpret=True))
    oracle = np.asarray(ref.decode_gqa_ref(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(lens)))
    plain = tq_gqa.decode_gqa_plain(_t(q), _t(k), _t(v), _t(lens)).numpy()
    got = ops.decode_gqa(_t(q), _t(k), _t(v), _t(lens)).numpy()
    np.testing.assert_allclose(plain, pallas, **TOL)
    np.testing.assert_allclose(plain, oracle, **TOL)
    np.testing.assert_array_equal(got, plain)
    assert ops.launch_counts() == {name: 0 for name in ops.LAUNCHES}


def test_decode_gqa_rejects_bad_shapes():
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.decode_gqa(q, k, k, torch.ones(2, dtype=torch.int32))
    k = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="lengths"):
        ops.decode_gqa(q, k, k, torch.ones(3, dtype=torch.int32))
