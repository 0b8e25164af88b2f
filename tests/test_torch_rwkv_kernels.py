"""The port's chunked RWKV-6 scan (B12), invariant_stats (B10) and RWKV-6
time/channel mix against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them.
Tolerances are the reference's own: 2e-4 for the chunked scan
(test_kernels.py), 1e-5 / 5e-2 for invariant_stats in fp32 / bf16, 1e-4
for the time and channel mix in fp32 (test_rwkv_rglru.py).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.models import rwkv6 as jax_rwkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import invariant_stats as stats  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv_chunk as rwkv  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _scan_inputs(B, S, H, N, seed, logw=None):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, S, H, N).astype(np.float32) for _ in range(3))
    if logw is None:
        logw = -np.exp(rng.randn(B, S, H, N).astype(np.float32) - 1.0)
    else:
        logw = np.full((B, S, H, N), logw, np.float32)
    u = (0.3 * rng.randn(H, N)).astype(np.float32)
    return r, k, v, logw, u


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,N,chunk", [(2, 32, 3, 16, 8),
                                           (1, 24, 2, 32, 12),
                                           (3, 16, 1, 64, 16)])
def test_rwkv_chunk_scan_matches_pallas_and_naive(B, S, H, N, chunk):
    args = _scan_inputs(B, S, H, N, seed=B * S + N)
    y, st = ops.rwkv_chunk_scan(*_t(*args), chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    yj, sj = jax_ops.rwkv_chunk_scan(*map(jnp.asarray, args), chunk=chunk)
    yr, sr = ref.rwkv_chunk_scan_ref(*map(jnp.asarray, args))
    for want_y, want_s in ((yj, sj), (yr, sr)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s), rtol=2e-4, atol=2e-4)


def test_rwkv_chunk_scan_strong_decay_no_overflow():
    r, k, v, logw, u = _t(*_scan_inputs(1, 256, 1, 64, seed=8, logw=-8.0))
    y, st = ops.rwkv_chunk_scan(r, k, v, logw, u, chunk=128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())


def _naive(r, k, v, logw, u, S0):
    """Per-token recurrence in float64 from the initial state S0."""
    r, k, v, w, u = (a.astype(np.float64) for a in (r, k, v, np.exp(logw), u))
    S = S0.astype(np.float64).copy()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        ys.append(np.einsum("bhn,bhnm->bhm", rt, S)
                  + np.einsum("bhn,bhn->bh", rt, u[None] * kt)[..., None] * vt)
        S = w[:, t, ..., None] * S + kt[..., None] * vt[..., None, :]
    return np.stack(ys, 1), S


def test_rwkv_chunk_scan_from_a_nonzero_state_matches_naive_recurrence():
    B, S, H, N = 2, 24, 2, 16
    args = _scan_inputs(B, S, H, N, seed=5)
    S0 = np.random.RandomState(6).randn(B, H, N, N).astype(np.float32)
    y, st = ops.rwkv_chunk_scan(*_t(*args), chunk=8, state=torch.from_numpy(S0))
    yn, sn = _naive(*args, S0)
    np.testing.assert_allclose(y.numpy(), yn, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.numpy(), sn, rtol=2e-4, atol=2e-4)
    # two halves, the second from the first's state, equal the whole
    t = _t(*args)
    y1, s1 = ops.rwkv_chunk_scan(*(a[:, :16] for a in t[:4]), t[4], chunk=8,
                                 state=torch.from_numpy(S0))
    y2, s2 = ops.rwkv_chunk_scan(*(a[:, 16:] for a in t[:4]), t[4], chunk=8, state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), st.numpy(), rtol=1e-5, atol=1e-5)


def test_rwkv_chunk_scan_cpu_runs_the_plain_version_and_validates():
    r, k, v, logw, u = _t(*_scan_inputs(1, 16, 2, 16, seed=1))
    before = rwkv.launches.n
    y, st = ops.rwkv_chunk_scan(r, k, v, logw, u, chunk=8)
    yp, sp = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=8)
    assert rwkv.launches.n == before
    assert torch.equal(y, yp) and torch.equal(st, sp)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.rwkv_chunk_scan(r[:, :12], k[:, :12], v[:, :12], logw[:, :12], u, chunk=8)
    with pytest.raises(ValueError, match="u must be"):
        ops.rwkv_chunk_scan(r, k, v, logw, u[:1], chunk=8)
    with pytest.raises(ValueError, match="state must be"):
        ops.rwkv_chunk_scan(r, k, v, logw, u, chunk=8, state=torch.zeros(1, 2, 16, 8))
    with pytest.raises(ValueError, match="one \\(B, S, H, N\\) shape"):
        ops.rwkv_chunk_scan(r, k[:, :8], v, logw, u, chunk=8)


@pytest.mark.parametrize("shape", [(64, 128), (300, 200), (1024, 96), (17, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_invariant_stats_matches_pallas(shape, dtype):
    """The reference's sweep (test_kernels.py): the same fp32 draws, cast
    to the same dtype in both packages (both round to nearest even)."""
    rng = np.random.RandomState(shape[0])
    w0 = rng.randn(*shape).astype(np.float32)
    w1 = w0 + 0.02 * rng.randn(*shape).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jax_ops.invariant_stats(jnp.asarray(w0).astype(jd), jnp.asarray(w1).astype(jd))
    got = ops.invariant_stats(torch.from_numpy(w0).to(td), torch.from_numpy(w1).to(td))
    assert got.dtype == torch.float32 and got.shape == (shape[1],)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.invariant_stats_ref(jnp.asarray(w0).astype(jd),
                                                        jnp.asarray(w1).astype(jd))),
        rtol=tol, atol=tol)


def test_invariant_stats_validates_and_counts_no_cpu_launch():
    w = torch.zeros(8, 4)
    before = stats.launches.n
    assert torch.equal(ops.invariant_stats(w, w + 1.0),
                       torch.full((4,), 8 ** 0.5 / 1e-8))
    assert stats.launches.n == before
    with pytest.raises(ValueError, match="one non-empty"):
        ops.invariant_stats(w, w[:4])
    with pytest.raises(ValueError, match="share a dtype"):
        ops.invariant_stats(w, w.bfloat16())


# ---------------------------------------------------------------------------
# time mix and channel mix at rwkv6-3b.smoke() in fp32


def _cfgs(**over):
    jcfg = jax_get_config("rwkv6-3b").smoke().with_overrides(
        dtype="float32", param_dtype="float32", **over)
    tcfg = get_config("rwkv6-3b").smoke().with_overrides(
        dtype="float32", param_dtype="float32", **over)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tmix():
    jcfg, tcfg = _cfgs()
    jp = jax_rwkv.init_tmix(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(1).randn(2, 24, jcfg.d_model).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def test_tmix_seq_matches_reference(tmix):
    jcfg, tcfg, jp, tp, x = tmix
    ops.reset_launch_counts()
    y, last, st = rwkv6.tmix_seq(tp, torch.from_numpy(x), tcfg)
    yj, lastj, stj = jax_rwkv.tmix_seq(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(last.numpy(), np.asarray(lastj))
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), **TOL)
    # the naive oracle of both packages
    yr, _, sr = rwkv6.tmix_ref(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(yr.numpy(), np.asarray(jax_rwkv.tmix_ref(jp, jnp.asarray(x), jcfg)[0]),
                               **TOL)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), sr.numpy(), **TOL)
    assert ops.launch_counts()["rwkv_chunk_scan"] == 0       # CPU: plain version


def test_tmix_seq_chunk_and_state_in(tmix):
    """S = 24 with rwkv_chunk 16 runs chunks of 12 (the reference's
    divisor walk); a prefix's state and shift continue the sequence."""
    jcfg, tcfg, jp, tp, x = tmix
    xt = torch.from_numpy(x)
    y_full, _, s_full = rwkv6.tmix_ref(tp, xt, tcfg)
    y_pre, last, st = rwkv6.tmix_seq(tp, xt[:, :16], tcfg)
    y_rest, _, s_rest = rwkv6.tmix_seq(tp, xt[:, 16:], tcfg, shift_in=last, state_in=st)
    np.testing.assert_allclose(torch.cat([y_pre, y_rest], 1).numpy(), y_full.numpy(), **TOL)
    np.testing.assert_allclose(s_rest.numpy(), s_full.numpy(), **TOL)
    # the two chunk forms the port has (float32, bfloat16); any other refused
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rwkv6.tmix_seq(tp, xt, dataclasses.replace(tcfg, rwkv_chunk_dtype="float16"))


def test_tmix_decode_matches_reference(tmix):
    jcfg, tcfg, jp, tp, x = tmix
    _, last, st = rwkv6.tmix_seq(tp, torch.from_numpy(x[:, :16]), tcfg)
    _, lastj, stj = jax_rwkv.tmix_seq(jp, jnp.asarray(x[:, :16]), jcfg)
    y, l1, s1 = rwkv6.tmix_decode(tp, torch.from_numpy(x[:, 16:17]), tcfg, last, st)
    yj, _, sj = jax_rwkv.tmix_decode(jp, jnp.asarray(x[:, 16:17]), jcfg, lastj, stj)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(s1.numpy(), np.asarray(sj), **TOL)
    y_full = rwkv6.tmix_ref(tp, torch.from_numpy(x[:, :17]), tcfg)[0]
    np.testing.assert_allclose(y[:, 0].numpy(), y_full[:, 16].numpy(), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_cmix_seq_and_decode_match_reference(masked):
    jcfg, tcfg = _cfgs()
    jp = jax_rwkv.init_cmix(jax.random.PRNGKey(2), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, jcfg.d_model).astype(np.float32)
    shift = rng.randn(2, jcfg.d_model).astype(np.float32)
    mask = (rng.rand(jcfg.d_ff) < 0.5).astype(np.float32) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    jmk = None if mask is None else jnp.asarray(mask)
    y, last = rwkv6.cmix_seq(tp, torch.from_numpy(x), tcfg, neuron_mask=tm)
    yj, lastj = jax_rwkv.cmix_seq(jp, jnp.asarray(x), jcfg, neuron_mask=jmk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_array_equal(last.numpy(), np.asarray(lastj))
    y1, _ = rwkv6.cmix_decode(tp, torch.from_numpy(x[:, :1]), tcfg,
                              torch.from_numpy(shift), neuron_mask=tm)
    y1j, _ = jax_rwkv.cmix_decode(jp, jnp.asarray(x[:, :1]), jcfg, jnp.asarray(shift),
                                  neuron_mask=jmk)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y1j), **TOL)
