"""The port's MoE FFN (models/moe.py) and FLuID's MoE masks against the JAX
reference, on the CPU: DeepSeek-V2-Lite-16B (MLA, a dense first layer,
shared experts, top-6 of 64 at full width) and Arctic-480B (GQA, a dense
residual FFN beside the experts) at their smoke sizes, in float32, params
from the reference's init through numpy.

Routing is held exactly (the integers, including the tie order under an
expert mask and the capacity scatter's slot cap − 1 overwrite), its
weights and the router loss to 1e-6, layer outputs to 1e-5, logits to
1e-4 (the tolerance of tests/test_torch_serving.py).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import transformer_hooks as jax_hooks  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import transformer_hooks as hooks  # noqa: E402
from repro_torch.interop import masks_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.launch.serving import ServeEngine  # noqa: E402
from repro_torch.models import model as tq_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["deepseek-v2-lite-16b", "arctic-480b"]
_SETUPS = {}
jax_forward = jax.jit(jax_model.forward_seq, static_argnums=(1,),
                      static_argnames=("want_cache", "cache_len"))
jax_decode = jax.jit(jax_model.decode_step, static_argnums=(1,))


def _setup(arch):
    if arch not in _SETUPS:
        jcfg = dataclasses.replace(jax_get_config(arch).smoke(), dtype="float32")
        tcfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        _SETUPS[arch] = (jcfg, tcfg, jparams, tparams)
    return _SETUPS[arch]


def _moe_layer(arch="deepseek-v2-lite-16b", **over):
    """The smoke model's last MoE layer, both packages, under ``over``."""
    jcfg, tcfg, jparams, _ = _setup(arch)
    seg = f"seg{len(jparams['stack']) - 1}"
    jp = jax.tree.map(lambda a: np.asarray(a[-1]), jparams["stack"][seg]["l0"]["moe"])
    return (dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over),
            jp, params_from_numpy(jp, "cpu"))


def _x(T, d, seed=0):
    return (np.random.RandomState(seed).randn(T, d) * 0.5).astype(np.float32)


def _tokens(B, S, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, S)).astype(np.int32)


def _moe_masks(jcfg, jp, seed=0):
    """An (E, f) unit mask with about a third dropped."""
    rng = np.random.RandomState(seed)
    return (rng.rand(jcfg.n_experts, jp["w_in"].shape[-1]) > 0.33).astype(np.float32)


# --------------------------------------------------------------------------
# routing and the expert matmuls, piece by piece

@pytest.mark.parametrize("case", ["plain", "expert_mask_ties", "wide_ties"])
def test_route_matches_reference(case):
    """Order, tokens, picks per expert and sorted experts exact; weights
    and aux to 1e-6. With fewer experts left than top_k, the picks tie at
    probability 0 and the lower expert must come first, as in
    jax.lax.top_k; "wide_ties" leaves 2 of 8 experts to a top-3."""
    over = {"wide_ties": dict(n_experts=8, top_k=3)}.get(case, {})
    jcfg, tcfg, jp, tp = _moe_layer(**over)
    if case == "wide_ties":
        rng = np.random.RandomState(5)
        jp = dict(jp, router=(rng.randn(jcfg.d_model, 8) / 16).astype(np.float32))
        tp = params_from_numpy(jp, "cpu")
    em = {"plain": None, "expert_mask_ties": np.array([0, 0, 1, 0], np.float32),
          "wide_ties": np.array([0, 1, 0, 0, 0, 0, 1, 0], np.float32)}[case]
    x = _x(24, jcfg.d_model, seed=1)
    want = jax_moe._route(jp, jnp.asarray(x), jcfg,
                          None if em is None else jnp.asarray(em))
    got = moe._route(tp, torch.from_numpy(x), tcfg,
                     None if em is None else torch.from_numpy(em))
    for name, g, w in zip(("order", "tok", "gs"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got[5]), float(want[5]), rtol=1e-6, atol=1e-6)
    if em is not None:                         # picks tied at probability 0
        assert bool((got[3] == 0).any())


def _skewed(jp, tp):
    """Router column 0 aligned with the inputs' mean: expert 0 takes most
    tokens and overflows its capacity."""
    r = np.array(jp["router"])
    r[:, 0] += 0.5
    jp = dict(jp, router=r)
    return jp, dict(tp, router=torch.from_numpy(r))


@pytest.mark.parametrize("case", ["no_overflow", "overflow", "overflow_masked",
                                  "ragged", "expert_chunk"])
def test_moe_tokens_matches_reference(case):
    """_moe_tokens: the capacity form with room for every pick, with an
    expert over capacity (the slot cap − 1 overwrite), with neuron and
    expert masks, the ragged form, and expert chunks of 2."""
    over = {"no_overflow": dict(moe_capacity_factor=4.0),
            "ragged": dict(moe_impl="ragged"),
            "expert_chunk": dict(moe_expert_chunk=2)}.get(case, {})
    jcfg, tcfg, jp, tp = _moe_layer(**over)
    x = np.abs(_x(16, jcfg.d_model, seed=2)) if case != "no_overflow" else _x(16, jcfg.d_model)
    if case != "no_overflow":
        jp, tp = _skewed(jp, tp)
    nm = em = None
    if case == "overflow_masked":
        nm = _moe_masks(jcfg, jp)
        em = np.array([1, 1, 0, 1], np.float32)
    jy, jaux = jax_moe._moe_tokens(jp, jnp.asarray(x), jcfg,
                                   None if nm is None else jnp.asarray(nm),
                                   None if em is None else jnp.asarray(em))
    ty, taux = moe._moe_tokens(tp, torch.from_numpy(x), tcfg,
                               None if nm is None else torch.from_numpy(nm),
                               None if em is None else torch.from_numpy(em))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)
    gs = moe._route(tp, torch.from_numpy(x), tcfg,
                    None if em is None else torch.from_numpy(em))[2]
    assert (int(gs.max()) > moe.capacity(16, tcfg)) == (case != "no_overflow")


def test_capacity_overwrite_drops_the_last_kept_row():
    """One expert, cap 2, four rows: the reference's bucket is [[x0], [0]]
    (row 1, kept at rank cap − 1, is overwritten by the dropped rows'
    zeros), so only row 0 gets an output."""
    jcfg, tcfg, jp, tp = _moe_layer(n_experts=1, top_k=1, moe_capacity_factor=0.5)
    jp = dict(jp, **{k: jp[k][:1] for k in ("w_in", "w_gate", "w_out")},
              router=np.array(jp["router"])[:, :1])
    tp = params_from_numpy(jp, "cpu")
    assert moe.capacity(4, tcfg) == 2
    x = _x(4, jcfg.d_model, seed=3)
    jy, _ = jax_moe._moe_tokens(jp, jnp.asarray(x), jcfg, None, None)
    ty, _ = moe._moe_tokens(tp, torch.from_numpy(x), tcfg, None, None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    assert bool((ty[0] != 0).any())
    assert bool((ty[1:] == 0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_token_chunks_match_reference(arch):
    """T = 20 tokens over moe_token_chunk 8, halved to 4: five chunks with
    their own capacity, aux their mean; the shared (DeepSeek) or dense
    residual (Arctic) FFN added after."""
    jcfg, tcfg, jp, tp = _moe_layer(arch, moe_token_chunk=8)
    x = _x(20, jcfg.d_model, seed=4).reshape(2, 10, -1)
    nm = _moe_masks(jcfg, jp, seed=1)
    jy, jaux = jax_moe._moe_local(jp, jnp.asarray(x), jnp.asarray(nm), None, jcfg)
    ty, taux = moe.apply_moe(tp, torch.from_numpy(x), tcfg,
                             neuron_mask=torch.from_numpy(nm))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# FLuID's masks

def _two_inits(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jnew = jax_model.init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, tcfg, jparams, jnew, tparams, params_from_numpy(
        jax.tree.map(np.asarray, jnew), "cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("block128,drop_experts", [(True, False), (False, True)])
def test_unit_stats_and_masks_match_reference(block128, drop_experts):
    """ffn_unit_stats (a dense layer and an MoE layer's (E, f) units and
    expert means) to 1e-6, build_masks exactly, on DeepSeek's smoke
    config."""
    jcfg, tcfg, jold, jnew, told, tnew = _two_inits("deepseek-v2-lite-16b")
    jstats = jax_hooks.ffn_unit_stats(jold, jnew, jcfg)
    tstats = hooks.ffn_unit_stats(told, tnew, tcfg)
    want, got = _flat(jax.tree.map(np.asarray, jstats)), _flat(tstats)
    assert sorted(got) == sorted(want) and any(k.endswith("/experts") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)
    jm = _flat(jax.tree.map(np.asarray, jax_hooks.build_masks(
        jstats, jcfg, 0.5, block128=block128, drop_experts=drop_experts)))
    tm = _flat(hooks.build_masks(tstats, tcfg, 0.5, block128=block128,
                                 drop_experts=drop_experts))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_array_equal(tm[k].numpy(), jm[k], err_msg=k)


_MASKS = {}


def _masks(arch):
    """build_masks at r = 0.5 over expert units (no 128-blocks at smoke
    width) with whole experts dropped: both packages' trees."""
    if arch not in _MASKS:
        jcfg, tcfg, jold, jnew, _, _ = _two_inits(arch)
        jm = jax_hooks.build_masks(jax_hooks.ffn_unit_stats(jold, jnew, jcfg), jcfg,
                                   0.5, block128=False, drop_experts=True)
        jm = jax.tree.map(np.asarray, jm)
        _MASKS[arch] = jax.tree.map(jnp.asarray, jm), masks_from_numpy(jm)
    return _MASKS[arch]


# --------------------------------------------------------------------------
# the models

@pytest.mark.parametrize("arch", ARCHS)
def test_params_layout_matches_reference(arch):
    """Same keys and shapes as the reference; under a bf16 dtype the
    experts' matrices are bf16 and the router fp32, from init_params and
    from params_from_numpy alike."""
    jcfg, tcfg, jparams, _ = _setup(arch)
    want = _flat(jax.tree.map(np.asarray, jparams))
    got = _flat(tq_model.init_params(tcfg, seed=0, device="cpu", dtype=torch.bfloat16))
    conv = _flat(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                   dtype=torch.bfloat16))
    assert sorted(got) == sorted(want) == sorted(conv)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert got[k].dtype == conv[k].dtype, k
    routers = [k for k in got if k.endswith("/router")]
    assert routers and all(got[k].dtype == torch.float32 for k in routers)
    assert got[routers[0].replace("router", "w_in")].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_seq_logits_and_aux_match(arch):
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jm, tm = _masks(arch)
    toks = _tokens(2, 12)
    jl, _, jaux = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, masks=jm)
    tl, _, taux = tq_model.forward_seq(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                                       masks=tm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=1e-6)
    assert float(taux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_logits_match(arch):
    """A prefill into a cache with headroom, then decode steps (capacity 1
    at 2 slots: an expert both slots pick serves neither), under the same
    expert-unit and expert masks; each step's logits against the
    reference's."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jm, tm = _masks(arch)
    B, S, C, steps = 2, 6, 10, 3
    toks = _tokens(B, S, seed=1)
    jl, jc, _ = jax_forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, masks=jm,
                            want_cache=True, cache_len=C)
    tl, tc, _ = tq_model.forward_seq(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                                     masks=tm, want_cache=True, cache_len=C)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    for _ in range(steps):
        jd, jc = jax_decode(jparams, jcfg, jc, jnp.asarray(nxt), jnp.asarray(pos), masks=jm)
        td, tc = tq_model.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt),
                                      torch.from_numpy(pos), masks=tm)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
        nxt = np.asarray(jnp.argmax(jd[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_moe(arch):
    """The reference's engine passes per-slot FFN masks that apply_moe
    cannot take; the port's refuses an MoE model up front."""
    _, tcfg, _, tparams = _setup(arch)
    with pytest.raises(ValueError, match="launch.serve.serve"):
        ServeEngine(tcfg, tparams, device="cpu")
