"""RWKV-6's bf16 chunk form (``rwkv_chunk_dtype="bfloat16"``, which the
reference's dry-run sets for ``rwkv_c128_bf16``) against the JAX reference
on the CPU: the time mix within 1e-2 of max|y| in the bf16 form and 1e-5 in
the fp32 form from the same params and input; one chunk's core, whose
bf16 scores the port computes as the reference's einsum rounds them, within
1e-5 of max|y| and its state exactly as the fp32 form's.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import rwkv6 as jax_rwkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv_chunk  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402


def _cfgs(chunk_dtype):
    over = dict(dtype="float32", param_dtype="float32", rwkv_chunk_dtype=chunk_dtype)
    return (jax_get_config("rwkv6-3b").smoke().with_overrides(**over),
            get_config("rwkv6-3b").smoke().with_overrides(**over))


@pytest.fixture(scope="module")
def case():
    jcfg, _ = _cfgs("float32")
    jp = jax_rwkv.init_tmix(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(1).randn(2, 48, jcfg.d_model).astype(np.float32)
    return jp, tp, x


@pytest.mark.parametrize("chunk_dtype,tol", [("bfloat16", 1e-2), ("float32", 1e-5)])
def test_tmix_seq_chunk_forms_match_reference(case, chunk_dtype, tol):
    jp, tp, x = case
    jcfg, tcfg = _cfgs(chunk_dtype)
    ops.reset_launch_counts()
    y, _, st = rwkv6.tmix_seq(tp, torch.from_numpy(x), tcfg)
    yj, _, stj = jax_rwkv.tmix_seq(jp, jnp.asarray(x), jcfg)
    yj, stj = np.asarray(yj), np.asarray(stj)
    assert np.abs(y.numpy() - yj).max() <= tol * np.abs(yj).max()
    np.testing.assert_allclose(st.numpy(), stj, rtol=1e-5, atol=1e-5)
    assert ops.launch_counts()["rwkv_chunk_scan"] == ops.launch_counts()["rwkv_chunk_scan_bf16"] == 0


def test_bf16_form_differs_from_fp32_form(case):
    """The two forms are not the same numbers: the bf16 scores move y by
    far more than fp32 rounding, so the 1e-2 test above holds a real
    rounding and not a copy of the fp32 form."""
    jp, tp, x = case
    ys = [rwkv6.tmix_seq(tp, torch.from_numpy(x), _cfgs(cd)[1])[0]
          for cd in ("float32", "bfloat16")]
    assert float((ys[0] - ys[1]).abs().max()) > 1e-4 * float(ys[0].abs().max())


def test_chunk_core_bf16_matches_reference():
    rng = np.random.RandomState(2)
    B, c, H, N = 2, 32, 3, 64
    r, k, v = (rng.randn(B, c, H, N).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.rand(B, c, H, N).astype(np.float32) * 5 - 6)
    u = 0.1 * rng.randn(H, N).astype(np.float32)
    S0 = rng.randn(B, H, N, N).astype(np.float32)
    args = (r, k, v, logw, u, S0)
    yj, sj = jax_rwkv._chunk_core(*map(jnp.asarray, args), chunk_dtype=jnp.bfloat16)
    yt, st = rwkv_chunk._chunk_core(*map(torch.from_numpy, args), torch.bfloat16)
    yj = np.asarray(yj)
    assert np.abs(yt.numpy() - yj).max() <= 1e-5 * np.abs(yj).max()
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)
    # the plain scan over chunks takes the same form
    y2, _ = rwkv_chunk.rwkv_chunk_scan_plain(*map(torch.from_numpy, args[:5]), chunk=c,
                                             state=torch.from_numpy(S0),
                                             chunk_dtype=torch.bfloat16)
    assert torch.equal(y2, yt)
