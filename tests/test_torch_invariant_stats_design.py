"""The arithmetic of B10 on the card (``csrc/invariant_stats.cu``), on the CPU.

The kernel cuts a (d_in, n) pair as ``invariant_stats.launch_geometry``
says: a thread-block cluster of ``cs`` blocks a strip of columns, block q
of it the rows [q·rows, (q+1)·rows); in a block, row group g walks rows
g, g + groups, ... of its slab, each lane summing (w1 - w0)² and w0² of its
columns in fp32 with one FMA a row; the block adds its row groups' sums
in group order, and block 0 adds the blocks' sums in rank order, then
takes sqrt(num) / (sqrt(den) + 1e-8).

A numpy emulation of that order (FMAs in float64, rounded to fp32 after
each) is held here to the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it, at its 1e-5 (fp32) and 5e-2 (bf16), for
ragged shapes, rows whose stride is not a multiple of 16 bytes (narrower
loads), and d_in from one row to more than 8 slabs.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.kernels.ops import invariant_stats as pallas_stats  # noqa: E402
from repro_torch.kernels import invariant_stats as stats  # noqa: E402

EPS = np.float32(1e-8)


def _fma(a, b, c):
    """fp32 fma: the exact product plus c, rounded once (via float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate(w0, w1, geo):
    """The kernel's slabs, row groups and sums, for fp32 arrays w0, w1."""
    d_in, n = w0.shape
    rows, groups, cs = geo["rows"], geo["groups"], geo["cs"]
    num, den = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for q in range(cs):                              # the blocks, in rank order
        r0, r1 = q * rows, min(d_in, (q + 1) * rows)
        bn, bd = np.zeros(n, np.float32), np.zeros(n, np.float32)
        for g in range(groups):                      # the row groups, in order
            gn, gd = np.zeros(n, np.float32), np.zeros(n, np.float32)
            for r in range(r0 + g, r1, groups):      # a thread's rows, in order
                d = (w1[r] - w0[r]).astype(np.float32)
                gn = _fma(d, d, gn)
                gd = _fma(w0[r], w0[r], gd)
            bn, bd = (bn + gn).astype(np.float32), (bd + gd).astype(np.float32)
        num, den = (num + bn).astype(np.float32), (den + bd).astype(np.float32)
    return (np.sqrt(num) / (np.sqrt(den) + EPS)).astype(np.float32)


SHAPES = [(64, 128), (300, 200), (17, 384), (1, 1), (33, 129), (1024, 96), (1024, 1023),
          (513, 258)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stats_design_matches_pallas(shape, dtype):
    key = jax.random.PRNGKey(shape[0] + shape[1])
    w0 = jax.random.normal(key, shape).astype(dtype)
    w1 = (w0.astype(jnp.float32)
          + 0.02 * jax.random.normal(jax.random.fold_in(key, 1), shape)).astype(dtype)
    elem = 4 if dtype == "float32" else 2
    geo = stats.launch_geometry(*shape, elem)
    got = emulate(np.asarray(w0.astype(jnp.float32)), np.asarray(w1.astype(jnp.float32)), geo)
    want = np.asarray(pallas_stats(w0, w1))
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,elem,vb", [((1024, 1024), 4, 16), ((1024, 1024), 2, 16),
                                           ((2560, 8960), 2, 16), ((1024, 1023), 2, 2),
                                           ((1024, 1023), 4, 4), ((2560, 8961), 2, 2),
                                           ((33, 129), 2, 2), ((7, 6), 2, 4)])
def test_stats_geometry(shape, elem, vb):
    """The widest load that divides a row's bytes; a strip of lpr·vb bytes;
    every row and column covered once; at most 8 blocks a cluster; the
    wide rows (lpr 32, 512-byte runs) where they still give every SM a
    block."""
    d_in, n = shape
    geo = stats.launch_geometry(d_in, n, elem, n_sm=132)
    assert geo["vb"] == vb and geo["vec"] * elem == vb
    assert geo["cols"] == geo["lpr"] * geo["vec"] and geo["groups"] * geo["lpr"] == 256
    assert geo["strips"] * geo["cols"] >= n > (geo["strips"] - 1) * geo["cols"]
    assert 1 <= geo["cs"] <= 8 and geo["cs"] * geo["rows"] >= d_in
    if geo["lpr"] < 32:
        wide = stats.launch_geometry(d_in, n, elem, n_sm=1)
        assert wide["lpr"] == 32 and wide["strips"] * wide["cs"] < 132 * 2


def test_stats_design_bf16_inputs_are_exact_in_fp32():
    """bf16 weights convert to fp32 exactly, so the emulation's inputs are
    the kernel's: the bf16 case differs from fp32 only by the weights'
    own rounding."""
    w = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    b = w.astype(ml_dtypes.bfloat16)
    assert np.array_equal(b.astype(np.float32).astype(ml_dtypes.bfloat16), b)
