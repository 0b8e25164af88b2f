"""The port's other decoder mixers against the JAX reference, on the CPU:
MLA (MiniCPM3-4B, with q-LoRA), RG-LRU with local attention
(RecurrentGemma-9B), the parallel block (Command-R-35B), MQA with biases
and LayerNorm (Granite-20B) and plain GQA (Chameleon-34B).

Smoke configs in float32, params from the reference's init through
numpy, the reference run as tests/test_serving.py runs it (plain jnp, no
kernels). Logits agree to 1e-4, the tolerance of
tests/test_torch_serving.py. The RG-LRU and MLA pieces are held to the
reference's functions one by one.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serving as jax_serving  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import masks_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import mla, rglru  # noqa: E402
from repro_torch.models import model as tq_model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["minicpm3-4b", "recurrentgemma-9b", "command-r-35b", "granite-20b",
         "chameleon-34b"]
# (prompt length, cache length, decode steps): RecurrentGemma's smoke
# window is 64, so its prefill and decode run past it and the ring wraps
DECODE = {"recurrentgemma-9b": (56, 72, 12)}
DEFAULT_DECODE = (6, 10, 3)
_SETUPS = {}
# the reference's model functions compiled once per config (cfg is static)
jax_forward = jax.jit(jax_model.forward_seq, static_argnums=(1,),
                      static_argnames=("want_cache", "cache_len"))
jax_decode = jax.jit(jax_model.decode_step, static_argnums=(1,),
                     static_argnames=("mla_absorb",))


def _setup(arch):
    if arch not in _SETUPS:
        jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype="float32")
        tcfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _SETUPS[arch] = (jcfg, tcfg, jparams, tparams)
    return _SETUPS[arch]


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_and_params_layout_match_reference(arch):
    """Same config, same param keys and shapes; init_params stores the
    matrices (conv_w too) in its dtype and every vector (the attention's
    per-head (H, hd) biases too) in fp32, the leaves params_from_numpy
    keeps in fp32."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    assert tcfg.reference_fields() == dataclasses.asdict(jcfg)
    want = {k: np.asarray(v) for k, v in _flat(jparams).items()}
    got = _flat(tq_model.init_params(tcfg, seed=0, device="cpu",
                                     dtype=torch.bfloat16))
    conv = _flat(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                   dtype=torch.bfloat16))
    assert sorted(got) == sorted(want) == sorted(conv)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype == conv[k].dtype, k
        lead = 1 if k.startswith("/stack") else 0
        matrix = w.ndim - lead >= 2 and k.rsplit("/", 1)[1] not in ("bq", "bk", "bv", "bo")
        assert got[k].dtype == (torch.bfloat16 if matrix else torch.float32), k


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_seq_logits_match(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    # past RecurrentGemma's 64-token window, so the prefill mask binds
    S = 80 if arch == "recurrentgemma-9b" else 12
    toks = _tokens(2, S)
    jl, _, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _, _ = tq_model.forward_seq(tparams, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("arch,absorb", [(a, False) for a in ARCHS]
                         + [("minicpm3-4b", True)])
def test_prefill_then_decode_logits_match(arch, absorb):
    """A prefill into a cache with headroom, then decode steps with
    per-row masks (the serving layout) at rate 0.5; each step's logits
    against the reference's."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    S, C, steps = DECODE.get(arch, DEFAULT_DECODE)
    B = 2
    toks = _tokens(B, S, seed=1)
    jl, jc, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                            want_cache=True, cache_len=C)
    tl, tc, _ = tq_model.forward_seq(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                                     want_cache=True, cache_len=C)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jmasks = jax_serving.rate_masks(jcfg, 0.5, policy="random", seed=3)
    row = lambda m: np.broadcast_to(np.asarray(m)[:, None, None, :],
                                    (m.shape[0], B, 1, m.shape[-1])).copy()
    jdm = jax.tree.map(row, jmasks)
    tdm = masks_from_numpy(jdm)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    for _ in range(steps):
        jd, jc = jax_decode(jparams, jcfg, jc, jnp.asarray(nxt),
                            jnp.asarray(pos), masks=jdm, mla_absorb=absorb)
        td, tc = tq_model.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                      torch.from_numpy(pos), masks=tdm,
                                      mla_absorb=absorb)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1
    if arch == "recurrentgemma-9b":
        # the local-attention ring wrapped, and its slot record is the
        # reference's
        assert int(pos[0]) - 1 >= jcfg.window
        jslots = np.asarray(jc[1]["l0"]["attn"]["slots"][0])
        np.testing.assert_array_equal(
            attention.slot_positions(torch.from_numpy(pos - 1).long(),
                                     jslots.shape[1]).numpy(), jslots)


# --------------------------------------------------------------------------
# RG-LRU and MLA, piece by piece

def _layer_params(arch, mixer, seg=0, layer="l0"):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["stack"][f"seg{seg}"][layer][mixer])
    tp = {k: v[0] for k, v in tparams["stack"][f"seg{seg}"][layer][mixer].items()}
    return jcfg, tcfg, jp, tp


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def test_rglru_conv1d_and_gates_match_reference():
    jcfg, tcfg, jp, tp = _layer_params("recurrentgemma-9b", "rglru")
    rng = np.random.RandomState(0)
    w, K = tcfg.lru_dim, tcfg.conv1d_width
    u, hist = _rand(rng, 2, 9, w), _rand(rng, 2, K - 1, w)
    jo, jh = jax_rglru._conv1d_seq(jp, jnp.asarray(u), jnp.asarray(hist), jcfg)
    to, th = rglru._conv1d_seq(tp, torch.from_numpy(u), torch.from_numpy(hist), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    ja, jb = jax_rglru._gates(jp, jnp.asarray(u))
    ta, tb = rglru._gates(tp, torch.from_numpy(u))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S", [1, 7, 33])
def test_rglru_seq_matches_reference_and_stepped_decode(S):
    """rglru_seq from a carried state and conv history against the
    reference's, and against rglru_decode stepped S times from the same
    state: the same outputs and final state."""
    jcfg, tcfg, jp, tp = _layer_params("recurrentgemma-9b", "rglru")
    rng = np.random.RandomState(S)
    d, w, K = tcfg.d_model, tcfg.lru_dim, tcfg.conv1d_width
    x = _rand(rng, 2, S, d)
    h0, c0 = _rand(rng, 2, w, scale=0.5), _rand(rng, 2, K - 1, w)
    jy, jst = jax_rglru.rglru_seq(jp, jnp.asarray(x), jcfg, jnp.asarray(h0),
                                  jnp.asarray(c0))
    ty, tst = rglru.rglru_seq(tp, torch.from_numpy(x), tcfg, torch.from_numpy(h0),
                              torch.from_numpy(c0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]), **TOL)
    np.testing.assert_allclose(tst["conv"].numpy(), np.asarray(jst["conv"]), **TOL)
    state = {"h": torch.from_numpy(h0.copy()), "conv": torch.from_numpy(c0.copy())}
    steps = [rglru.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]), tcfg, state)
             for t in range(S)]
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), ty.numpy(), **TOL)
    np.testing.assert_allclose(state["h"].numpy(), tst["h"].numpy(), **TOL)
    np.testing.assert_allclose(state["conv"].numpy(), tst["conv"].numpy(), **TOL)
    jy1, jst1 = jax_rglru.rglru_decode(jp, jnp.asarray(x[:, :1]), jcfg,
                                       {"h": jnp.asarray(h0), "conv": jnp.asarray(c0)})
    np.testing.assert_allclose(steps[0].numpy(), np.asarray(jy1), **TOL)


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_attend_and_absorbed_decode_match_reference(q_lora):
    """_queries, _latent and the baseline _attend against the reference's;
    then one decode step on a half-filled cache, baseline and absorbed,
    against the reference's and against each other. MiniCPM3's smoke
    config has no q-LoRA (smoke() drops it); q_lora=True restores a rank
    of 48 on both sides."""
    arch = "minicpm3-4b"
    jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    if q_lora:
        jcfg, tcfg = (c.with_overrides(q_lora_rank=48) for c in (jcfg, tcfg))
    jp = jax_mla.init_mla(jax.random.PRNGKey(5), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert ("w_dq" in tp) == q_lora and ("wq" in tp) != q_lora
    rng = np.random.RandomState(1)
    B, S, C = 2, 9, 16
    x = _rand(rng, B, S, tcfg.d_model)
    jpos, tpos = jnp.arange(S, dtype=jnp.int32), torch.arange(S, dtype=torch.int32)
    jq = jax_mla._queries(jp, jnp.asarray(x), jcfg, jpos)
    tq = mla._queries(tp, torch.from_numpy(x), tcfg, tpos)
    jlat = jax_mla._latent(jp, jnp.asarray(x), jcfg, jpos)
    tlat = mla._latent(tp, torch.from_numpy(x), tcfg, tpos)
    for a, b in zip(tq + tlat, jq + jlat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jy = jax_mla._attend(jp, *jq, *jlat, jcfg, jpos, jpos)
    ty = mla._attend(tp, *tq, *tlat, tcfg, tpos, tpos)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    ty_seq, _ = mla.mla_seq(tp, torch.from_numpy(x), tcfg, tpos)
    np.testing.assert_allclose(ty_seq.numpy(), ty.numpy(), **TOL)

    # a cache holding positions 0..S-1, then the token at position S
    x1 = _rand(rng, B, 1, tcfg.d_model)
    pos = np.full((B,), S, np.int32)
    ckv = np.zeros((B, C, tcfg.kv_lora_rank), np.float32)
    kr = np.zeros((B, C, tcfg.qk_rope_dim), np.float32)
    ckv[:, :S], kr[:, :S] = np.asarray(jlat[0]), np.asarray(jlat[1])
    slots = np.full((B, C), -1, np.int32)
    slots[:, :S] = np.arange(S)
    outs = {}
    for absorb in (False, True):
        jy1, _, _ = jax_mla.mla_decode(
            jp, jnp.asarray(x1), jcfg, {"c_kv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr)},
            jnp.asarray(slots), jnp.asarray(pos), absorb=absorb)
        cache = {"c_kv": torch.from_numpy(ckv.copy()), "k_rope": torch.from_numpy(kr.copy())}
        outs[absorb] = mla.mla_decode(tp, torch.from_numpy(x1), tcfg, cache,
                                      torch.from_numpy(pos), absorb=absorb)
        np.testing.assert_allclose(outs[absorb].numpy(), np.asarray(jy1), **TOL)
    np.testing.assert_allclose(outs[True].numpy(), outs[False].numpy(), **TOL)


def test_local_attention_window_mask_matches_reference():
    """attn_seq with RecurrentGemma's window past its length, and the
    windowed plain decode on a ring that wrapped, against the reference."""
    from repro.models import attention as jax_attn
    jcfg, tcfg, jp, tp = _layer_params("recurrentgemma-9b", "attn", seg=1)
    W = tcfg.window
    rng = np.random.RandomState(2)
    B, S = 2, W + 20
    x = _rand(rng, B, S, tcfg.d_model)
    jy, (jk, jv) = jax_attn.attn_seq(jp, jnp.asarray(x), jcfg,
                                     jnp.arange(S, dtype=jnp.int32), window=W)
    ty, (tk, tv) = attention.attn_seq(tp, torch.from_numpy(x), tcfg,
                                      torch.arange(S, dtype=torch.int32), window=W)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    # the ring of W slots after the S tokens: slot p % W holds position p
    pos = np.array([S, S - 7], np.int32)
    tk, tv = tk.numpy(), tv.numpy()
    ring_k = np.zeros((B, W) + tk.shape[2:], np.float32)
    ring_v = np.zeros_like(ring_k)
    slots = np.full((B, W), -1, np.int32)
    for b in range(B):
        for p in range(pos[b]):
            ring_k[b, p % W], ring_v[b, p % W], slots[b, p % W] = tk[b, p], tv[b, p], p
    x1 = _rand(rng, B, 1, tcfg.d_model)
    jy1, jc, js = jax_attn.attn_decode(
        jp, jnp.asarray(x1), jcfg, {"k": jnp.asarray(ring_k), "v": jnp.asarray(ring_v)},
        jnp.asarray(slots), jnp.asarray(pos), window=W)
    cache = {"k": torch.from_numpy(ring_k.copy()), "v": torch.from_numpy(ring_v.copy())}
    ty1 = attention.attn_decode(tp, torch.from_numpy(x1), tcfg, cache,
                                torch.from_numpy(pos).long(), window=W)
    np.testing.assert_allclose(ty1.numpy(), np.asarray(jy1), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_array_equal(
        attention.slot_positions(torch.from_numpy(pos).long(), W).numpy(), np.asarray(js))
