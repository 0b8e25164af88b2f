"""The port's RWKV-6 serving path against the JAX reference, on the CPU.

rwkv6-3b.smoke() in float32: params come from the reference's init through
numpy (jax.random streams cannot be reproduced in torch), so logits agree
to 1e-4, the prefill-then-decode consistency holds at the reference's
2e-3 / 5e-3 (tests/test_decode_consistency.py), mask construction is
bitwise, and greedy decodes agree token for token.
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
from repro.models import model as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.interop import masks_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serving import ServeEngine, ServeRequest, rate_masks  # noqa: E402
from repro_torch.models import model as tq_model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs():
    jcfg = dataclasses.replace(jax_get_config("rwkv6-3b").smoke(), dtype="float32")
    tcfg = dataclasses.replace(get_config("rwkv6-3b").smoke(), dtype="float32")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _prompt(cfg, L, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, min(cfg.vocab_size, 256), (L,), dtype=np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_config_matches_reference():
    jcfg, tcfg = _cfgs()
    assert tcfg.reference_fields() == dataclasses.asdict(jcfg)
    full = get_config("rwkv6-3b")
    assert full.reference_fields() == dataclasses.asdict(jax_get_config("rwkv6-3b"))
    assert (full.rwkv_heads, tcfg.rwkv_heads) == (40, 4)


def test_init_params_and_interop_keep_the_reference_tree(setup):
    """The port's own init has the reference's keys and shapes; a bf16
    conversion casts matrices (lora_mix_b is 3-D) and keeps the vectors
    (mix_*, w_decay, w_u, norm scales: (R, d) under the stack) in fp32."""
    jcfg, tcfg, jparams, tparams = setup
    want = {k: np.asarray(v) for k, v in _flat(jax.tree.map(np.asarray, jparams)).items()}
    own = _flat(tq_model.init_params(tcfg, seed=0, device="cpu"))
    assert sorted(own) == sorted(want)
    for k in want:
        assert tuple(own[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(_flat(tparams)[k].numpy(), want[k])
    bf = _flat(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                 dtype=torch.bfloat16))
    tm = "/stack/seg0/l0/rwkv/"
    for key in ("lora_mix_b", "lora_mix_a", "lora_w_b", "w_r", "w_o"):
        assert bf[tm + key].dtype == torch.bfloat16, key
    for key in ("mix_x", "mix_w", "w_decay", "w_u", "ln_scale"):
        assert bf[tm + key].dtype == torch.float32, key
    assert bf["/stack/seg0/l0/norm1/scale"].dtype == torch.float32
    assert bf["/stack/seg0/l0/cmix/w_in"].dtype == torch.bfloat16
    assert bf["/tok/embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("rate", [1.0, 0.5])
def test_forward_seq_and_decode_step_logits_match(setup, rate):
    jcfg, tcfg, jparams, tparams = setup
    B, S = 2, 16
    toks = np.stack([_prompt(jcfg, S, seed=s) for s in range(B)])
    jmasks = (None if rate >= 1.0
              else jax_serving.rate_masks(jcfg, rate, policy="random", seed=3))
    tmasks = None if jmasks is None else masks_from_numpy(jax.tree.map(np.asarray, jmasks))
    jl, jc, _ = jax_model.forward_seq(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                                      masks=jmasks, want_cache=True, cache_len=S + 4)
    tl, tc, _ = tq_model.forward_seq(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                                     masks=tmasks, want_cache=True, cache_len=S + 4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for got, want in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    row = lambda m: np.broadcast_to(np.asarray(m)[:, None, None, :],
                                    (m.shape[0], B, 1, m.shape[-1])).copy()
    jdm = None if jmasks is None else jax.tree.map(row, jmasks)
    tdm = None if jdm is None else masks_from_numpy(jdm)
    for _ in range(2):
        jd, jc = jax_model.decode_step(jparams, jcfg, jc, jnp.asarray(nxt),
                                       jnp.asarray(pos), masks=jdm)
        td, tc = tq_model.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                      torch.from_numpy(pos), masks=tdm)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1
    for got, want in zip(tree_leaves(tc), jax.tree.leaves(jc)):   # caches in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_then_decode_matches_full_forward(setup):
    """tests/test_decode_consistency.py's check on the port alone."""
    _, tcfg, _, tparams = setup
    B, S, T = 2, 16, 4
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 100, (B, S + T)))
    full, _, _ = tq_model.forward_seq(tparams, tcfg, {"tokens": toks})
    logits, caches, _ = tq_model.forward_seq(tparams, tcfg, {"tokens": toks[:, :S]},
                                             want_cache=True, cache_len=S + T)
    np.testing.assert_allclose(logits[:, -1].numpy(), full[:, S - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    for t in range(T):
        lg, caches = tq_model.decode_step(tparams, tcfg, caches, toks[:, S + t][:, None],
                                          torch.full((B,), S + t))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, S + t].numpy(),
                                   rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("policy", ["ordered", "random"])
def test_rate_masks_bitwise_equal(policy):
    jcfg, tcfg = _cfgs()
    assert tcfg.d_ff == 448
    for r in (1.0, 0.75, 0.5, 0.25):
        want = jax.tree.leaves(jax_serving.rate_masks(jcfg, r, policy, seed=7))
        got = tree_leaves(rate_masks(tcfg, r, policy, seed=7))
        assert len(got) == len(want) == 1
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == (2, 448)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_engine_matches_reference_engine_token_for_token(setup):
    """A mixed-rate queue of exact-length prompts through both engines; 5
    requests over 2 slots, so slots are reused and the recurrent state is
    spliced over a retired one."""
    jcfg, tcfg, jparams, tparams = setup
    kw = dict(batch_size=2, max_prompt_len=8, max_gen_len=6, chunk=3, bank_size=4)
    jeng = jax_serving.ServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    assert jeng.recurrent and teng.recurrent
    rates, gens = [1.0, 0.5, 0.25, 0.5, 1.0], [6, 2, 5, 1, 4]
    for i, (r, g) in enumerate(zip(rates, gens)):
        jm = None if r >= 1.0 else jax_serving.rate_masks(jcfg, r, seed=0)
        tm = None if r >= 1.0 else rate_masks(tcfg, r, seed=0)
        prompt = _prompt(jcfg, 8, seed=i)
        assert (jeng.submit(jax_serving.ServeRequest(prompt, gen_len=g, masks=jm))
                == teng.submit(ServeRequest(prompt, gen_len=g, masks=tm)))
    ops.reset_launch_counts()
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    summ = teng.summary()
    assert summ["prefills"] == 5 and summ["decode_tokens"] == sum(g - 1 for g in gens)
    assert summ["kernel_launches"] == {"masked_ffn_batch": 0, "decode_gqa": 0,
                                      "rwkv_chunk_scan": 0}     # CPU: plain versions


def test_recurrent_engine_requires_exact_length_prompts(setup):
    _, tcfg, _, tparams = setup
    eng = ServeEngine(tcfg, tparams, batch_size=1, max_prompt_len=6, max_gen_len=4,
                      device="cpu")
    with pytest.raises(ValueError, match="exactly 6"):
        eng.submit(ServeRequest(_prompt(tcfg, 3), gen_len=2))
    with pytest.raises(ValueError, match="prompt length"):
        eng.submit(ServeRequest(_prompt(tcfg, 7), gen_len=2))
    rid = eng.submit(ServeRequest(_prompt(tcfg, 6), gen_len=3))
    assert len(eng.run()[rid]) == 3


def test_serve_engine_draws_exact_lengths_for_a_recurrent_engine():
    _, tcfg = _cfgs()
    results, summ = serve.serve_engine(tcfg, batch=2, prompt_len=8, gen_len=4,
                                       n_requests=3, rates=(1.0, 0.5), device="cpu")
    assert sorted(results) == [0, 1, 2] and summ["prefills"] == 3
    rng = np.random.RandomState(0)                 # serve_engine's draws, replayed
    for rid in range(3):
        rng.randint(0, 256, (8,), dtype=np.int32)
        assert len(results[rid]) == int(rng.randint(2, 5))
