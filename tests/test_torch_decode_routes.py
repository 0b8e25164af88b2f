"""The decode routes that the dry-run's variants select, against the JAX
reference at fp32 (1e-5): ``attention._sdpa_grouped`` (GQA without
expanding K/V), ``attn_decode(grouped=True)`` (plain, and windowed over a
ring that has wrapped), and the reference's uniform-position mode (one
slot written for every row of a synchronized batch) against the port's
per-row write. The reference returns a new cache, the port updates its
cache in place: the caches are compared too.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import sharding as jax_sharding  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B, C = 3, 24


def _cfgs(arch, **over):
    over = dict(dtype="float32", param_dtype="float32", **over)
    return jax_get_config(arch).smoke().with_overrides(**over), \
        get_config(arch).smoke().with_overrides(**over)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_sdpa_grouped_matches_reference(G, window):
    rng = np.random.RandomState(G)
    KV, hd, Sq, T = 2, 16, 5, 12
    q = rng.randn(B, Sq, KV * G, hd).astype(np.float32)
    k, v = (rng.randn(B, T, KV, hd).astype(np.float32) for _ in range(2))
    q_pos = np.arange(T - Sq, T, dtype=np.int32)
    kv_pos = np.where(rng.rand(B, T) < 0.2, -1, np.arange(T)).astype(np.int32)
    scale = 1 / np.sqrt(hd)
    want = jax_attention._sdpa_grouped(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                                       window, scale)
    got = attention._sdpa_grouped(*map(torch.from_numpy, (q, k, v, q_pos, kv_pos)),
                                  scale, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the expanded route the port takes elsewhere: the same numbers
    kf, vf = (attention._expand_kv(torch.from_numpy(t), KV * G) for t in (k, v))
    ref = attention._sdpa(torch.from_numpy(q), kf, vf, torch.from_numpy(q_pos),
                          torch.from_numpy(kv_pos), scale, window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def _decode_case(arch, pos, window=None, seed=0, **over):
    """Reference and port attention params, an x, a cache whose slots hold
    the positions before each row's pos (a ring of C slots), and the
    reference's slot record."""
    jcfg, tcfg = _cfgs(arch, **over)
    jp = jax_attention.init_attention(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(B, 1, jcfg.d_model).astype(np.float32)
    shape = (B, C, jcfg.n_kv_heads, jcfg.head_dim)
    kc, vc = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    prev = pos[:, None] - 1
    held = prev - np.mod(prev - np.arange(C)[None], C)
    slots = np.where(held >= 0, held, -1).astype(np.int32)
    return jcfg, tcfg, jp, tp, x, kc, vc, slots


def _run(jcfg, tcfg, jp, tp, x, kc, vc, slots, pos, window, mode, upos):
    """The reference under its (mode, upos) contexts, the port with
    grouped = (mode == 'seq') and its per-row write."""
    with jax_sharding.decode_cache_context(mode), jax_sharding.uniform_pos_context(upos):
        yj, cj, _ = jax_attention.attn_decode(
            jp, jnp.asarray(x), jcfg, {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
            jnp.asarray(slots), jnp.asarray(pos), window=window)
    cache = {"k": torch.tensor(kc), "v": torch.tensor(vc)}
    yt = attention.attn_decode(tp, torch.from_numpy(x), tcfg, cache,
                               torch.from_numpy(pos), window=window,
                               grouped=mode == "seq")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(cj[name]), **TOL)
    return yt


@pytest.mark.parametrize("arch,over", [("stablelm-12b", {"n_kv_heads": 2}),
                                       ("granite-20b", {})])
@pytest.mark.parametrize("window", [None, 9])
def test_attn_decode_seq_route_matches_reference(arch, over, window):
    """grouped=True (the reference's 'seq' cache mode): _sdpa_grouped over
    the ring's slot positions; rows at different positions, the windowed
    ring wrapped."""
    pos = np.array([5, 17, 40], np.int32)          # 40 > C: the ring has wrapped
    case = _decode_case(arch, pos, window, **over)
    ops.reset_launch_counts()
    _run(*case, pos, window, "seq", False)
    assert ops.launch_counts()["decode_gqa"] == 0   # no kernel on this route


@pytest.mark.parametrize("arch,over", [("stablelm-12b", {"n_kv_heads": 2}),
                                       ("granite-20b", {})])
@pytest.mark.parametrize("mode", ["auto", "seq"])
def test_attn_decode_uniform_pos_matches_reference(arch, over, mode):
    """Every row at one position: the reference's uniform_pos mode writes
    slot pos[0] % C of every row at once, the port writes each row's own
    slot, the same slot; the outputs and the caches agree. The attention by
    the default route (auto) or the grouped one (seq). Past the ring's end
    the slot wraps."""
    for p in (11, C + 6):
        pos = np.full(B, p, np.int32)
        case = _decode_case(arch, pos, **over)
        y_upos = _run(*case, pos, None, mode, True)
        # and the reference's per-row write gives the same numbers
        y = _run(*case, pos, None, mode, False)
        np.testing.assert_allclose(y.numpy(), y_upos.numpy(), **TOL)
