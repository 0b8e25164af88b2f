"""The port's encoder–decoder (models/encdec.py, SeamlessM4T-Large v2 at its
smoke size: 2 + 2 layers, LayerNorm, biases, ReLU FFN) and the
reference's static-batch ``serve`` for the three models that take only
that path (SeamlessM4T, DeepSeek-V2-Lite, Arctic), against the JAX
reference on the CPU in float32, params from the reference's init through
numpy. Logits agree to 1e-4, the tolerance of tests/test_torch_serving.py;
``serve`` token for token.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import masks_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.serving import ServeEngine  # noqa: E402
from repro_torch.models import attention, encdec  # noqa: E402
from repro_torch.models import model as tq_model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "seamless-m4t-large-v2"
_SETUPS = {}
jax_forward = jax.jit(jax_model.forward_seq, static_argnums=(1,),
                      static_argnames=("want_cache", "cache_len"))
jax_decode = jax.jit(jax_model.decode_step, static_argnums=(1,))


def _setup(arch=ARCH):
    if arch not in _SETUPS:
        jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype="float32")
        tcfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _SETUPS[arch] = (jcfg, tcfg, jparams, tparams)
    return _SETUPS[arch]


def _inputs(B, S, M, d, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 256, (B, S)).astype(np.int32)
    frames = (rng.randn(B, M, d) * 0.1).astype(np.float32)
    return toks, frames


def _masks(cfg, seed=0):
    """FFN unit masks of the encoder's and the decoder's layers, about a
    third dropped: both packages' trees."""
    rng = np.random.RandomState(seed)
    m = {side: {"ffn": (rng.rand(n, cfg.d_ff) > 0.33).astype(np.float32)}
         for side, n in (("enc", cfg.enc_layers), ("dec", cfg.n_layers))}
    return jax.tree.map(jnp.asarray, m), masks_from_numpy(m)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def test_params_layout_matches_reference():
    """Same keys and shapes ('enc' and 'dec' stacks, 'enc_norm'); under
    bf16 matrices bf16, vectors and per-head biases fp32."""
    jcfg, tcfg, jparams, _ = _setup()
    want = _flat(jax.tree.map(np.asarray, jparams))
    got = _flat(tq_model.init_params(tcfg, seed=0, device="cpu", dtype=torch.bfloat16))
    assert sorted(got) == sorted(want)
    assert "/stack/dec/cross/wk" in got and "/enc_norm/bias" in got
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        matrix = w.ndim >= 3 or (w.ndim == 2 and not k.startswith("/stack"))
        matrix = matrix and k.rsplit("/", 1)[1] not in ("bq", "bk", "bv", "bo")
        assert got[k].dtype == (torch.bfloat16 if matrix else torch.float32), k


def test_cross_attention_matches_reference():
    """attn_seq with kv_override: q projected with its bias and no rope,
    every memory position visible (kv positions 0, causal); and the
    bidirectional form."""
    jcfg, tcfg, jparams, tparams = _setup()
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["dec"]["cross"])
    tp = {k: v[0] for k, v in tparams["stack"]["dec"]["cross"].items()}
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, tcfg.d_model).astype(np.float32)
    mem = rng.randn(2, 7, tcfg.d_model).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    jk, jv = jax_encdec._cross_kv(jp, jnp.asarray(mem), jcfg)
    tk, tv = encdec._cross_kv(tp, torch.from_numpy(mem), tcfg)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    jy, _ = jax_attention.attn_seq(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                   kv_override=(jk, jv),
                                   kv_positions=jnp.zeros((7,), jnp.int32))
    ty, _ = attention.attn_seq(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                               kv_override=(tk, tv), kv_positions=torch.zeros(7, dtype=torch.int32))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    jy, _ = jax_attention.attn_seq(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), causal=False)
    ty, _ = attention.attn_seq(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                               causal=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_run_encoder_matches_reference():
    jcfg, tcfg, jparams, tparams = _setup()
    jm, tm = _masks(tcfg)
    _, frames = _inputs(2, 1, 9, tcfg.d_model)
    jx = jax_encdec.run_encoder(jparams["stack"], jnp.asarray(frames), jcfg, masks=jm["enc"])
    tx = encdec.run_encoder(tparams["stack"], torch.from_numpy(frames), tcfg, masks=tm["enc"])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_seq_logits_match(masked):
    jcfg, tcfg, jparams, tparams = _setup()
    jm, tm = _masks(tcfg, seed=2) if masked else (None, None)
    toks, frames = _inputs(2, 10, 12, tcfg.d_model, seed=3)
    jl, _, jaux = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                              "frames": jnp.asarray(frames)}, masks=jm)
    tl, _, taux = tq_model.forward_seq(tparams, tcfg, {"tokens": torch.from_numpy(toks),
                                                       "frames": torch.from_numpy(frames)},
                                       masks=tm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(taux) == float(jaux) == 0.0


def test_prefill_then_decode_logits_match():
    """A prefill (frames and tokens) into a cache with headroom, then
    decode steps under the decoder's masks; the cross K/V come from the
    prefill. Each step's logits against the reference's."""
    jcfg, tcfg, jparams, tparams = _setup()
    jm, tm = _masks(tcfg, seed=4)
    B, S, M, C, steps = 2, 6, 8, 10, 3
    toks, frames = _inputs(B, S, M, tcfg.d_model, seed=5)
    batch = lambda f: {"tokens": f(toks), "frames": f(frames)}
    jl, jc, _ = jax_forward(jparams, jcfg, batch(jnp.asarray), masks=jm,
                            want_cache=True, cache_len=C)
    tl, tc, _ = tq_model.forward_seq(tparams, tcfg, batch(torch.from_numpy),
                                     masks=tm, want_cache=True, cache_len=C)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tuple(tc[0]["cross_k"].shape) == (tcfg.n_layers, B, M, tcfg.n_kv_heads,
                                             tcfg.head_dim)
    assert tuple(tc[0]["attn"]["k"].shape[:3]) == (tcfg.n_layers, B, C)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    for _ in range(steps):
        jd, jc = jax_decode(jparams, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos), masks=jm)
        td, tc = tq_model.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                      torch.from_numpy(pos), masks=tm)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1


def test_cache_specs_match_reference():
    """The decode-shape caches: the reference's keys and shapes less its
    slot record, cross K/V over ENC_MEM_LEN memory positions."""
    jcfg, tcfg, _, _ = _setup()
    want = _flat(jax_model.cache_specs(jcfg, 2, 16)[0])
    got = _flat(tq_model.cache_specs(tcfg, 2, 16)[0])
    assert sorted(got) == sorted(k for k in want if not k.endswith("/slots"))
    for k, s in got.items():
        assert s.shape == want[k].shape, k
    caches = tq_model.init_caches(tcfg, 2, 16, "cpu")
    assert caches[0]["cross_k"].shape[2] == tq_model.ENC_MEM_LEN


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v2-lite-16b", "arctic-480b"])
def test_serve_matches_reference(arch):
    """launch.serve.serve, the reference's static batch (its own prompts,
    and frames for SeamlessM4T): the port's, given the reference's params,
    generates the same tokens."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jgen, jstats = jax_serve.serve(jcfg, batch=2, prompt_len=8, gen_len=5)
    tgen, tstats = serve(tcfg, batch=2, prompt_len=8, gen_len=5, device="cpu",
                         params=tparams)
    np.testing.assert_array_equal(tgen, np.asarray(jgen))
    assert tgen.shape == (2, 5) and sorted(tstats) == sorted(jstats)


def test_serve_needs_a_card_unless_told_cpu():
    _, tcfg, _, tparams = _setup()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(tcfg, params=tparams)


def test_engine_refuses_encdec():
    _, tcfg, _, tparams = _setup()
    with pytest.raises(NotImplementedError, match="launch.serve.serve"):
        ServeEngine(tcfg, tparams, device="cpu")
