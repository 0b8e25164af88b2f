"""DeepSeek-V2-Lite's published block in the port, on the CPU: the three
fields the published model sets beyond the JAX package (``norm_topk_prob``,
``seq_aux``, ``rope_scaling``), each against its formula; their defaults
against the arithmetic the port had before them, bit for bit; and the
port's loss and gradients under the benchmark's ``port_overrides`` and
``build_masks`` masks against the benchmark's plain reference
(``port_bench/reference/mla_moe.py``), in float32 at smoke size with the
benchmark's seeded weights."""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PB = Path(__file__).resolve().parents[1] / "port_bench"
if str(PB) not in sys.path:
    sys.path.insert(0, str(PB))

from harness import weights_mla_moe as weights  # noqa: E402
from reference import mla_moe  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import transformer_hooks as hooks  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers, mla, moe  # noqa: E402

CONF = json.loads((PB / "configs" / "deepseek-v2-lite-16b-train6.json").read_text())
YARN = CONF["rope_scaling"]
SMALL = dict(hidden_size=128, intermediate_size=320, num_attention_heads=2,
             num_key_value_heads=2, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, n_routed_experts=8,
             num_experts_per_tok=2, moe_intermediate_size=256, n_shared_experts=2,
             num_hidden_layers=3, vocab_size=256)
SMALL_PORT = dict(d_model=128, d_ff=320, n_heads=2, n_kv_heads=2, kv_lora_rank=32,
                  qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16, n_experts=8, top_k=2,
                  moe_d_ff=256, n_shared_experts=2, n_layers=3, vocab_size=256,
                  vocab_pad_multiple=64, dtype="float32")
SEED = 2 ** 31 + 777


def _published(**over):
    return get_config("deepseek-v2-lite-16b").with_overrides(**CONF["port_overrides"], **over)


# ---------------------------------------------------------------------------
# each field against its formula

def test_yarn_frequencies_and_softmax_scale_at_the_published_sizes():
    cfg = _published(n_layers=6)
    base, s, L0, dim = 10000.0, 40.0, 4096, 64
    corr = lambda r: dim * math.log(L0 / (2 * math.pi * r)) / (2 * math.log(base))
    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    j = np.arange(32, dtype=np.float64)
    extra = base ** (-2 * j / dim)
    ramp = np.clip((j - low) / (high - low), 0, 1)
    want = extra / s * ramp + extra * (1 - ramp)
    got = layers._rope_freqs_on(dim, cfg.rope_theta, torch.device("cpu"), cfg.rope_scaling)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7)
    assert layers.yarn_cos_scale(cfg.yarn) == 1.0
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert mla._scale(cfg) == pytest.approx(192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert mscale ** 2 == pytest.approx(1.5896, abs=1e-4)


def test_yarn_rotation_scales_cos_and_sin_where_the_two_mscales_differ():
    yarn = dict(YARN, mscale=1.0, mscale_all_dim=0.5)
    x = torch.randn(1, 5, 2, 16, generator=torch.Generator().manual_seed(0))
    pos = torch.arange(5)
    k = (0.1 * math.log(40) + 1) / (0.05 * math.log(40) + 1)
    assert layers.yarn_cos_scale(yarn) == pytest.approx(k)
    got = layers.apply_rope(x, pos, 10000.0, scaling=tuple(sorted(yarn.items())))
    freqs = torch.from_numpy(layers.yarn_freqs(16, 10000.0, yarn))
    ang = pos[:, None].float() * freqs
    cos, sin = (torch.cos(ang) * k)[:, None], (torch.sin(ang) * k)[:, None]
    x1, x2 = x.chunk(2, -1)
    torch.testing.assert_close(got, torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1))


def _route_case(T=12, **over):
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").smoke(), dtype="float32",
                              **over)
    g = torch.Generator().manual_seed(1)
    p = {"router": torch.randn(cfg.d_model, cfg.n_experts, generator=g)}
    x = torch.randn(T, cfg.d_model, generator=g)
    return cfg, p, x


def test_unnormalised_weights_are_the_picks_probabilities():
    cfg, p, x = _route_case(norm_topk_prob=False)
    order, tok, gs, w, row_e, _ = moe._route(p, x, cfg, None)
    probs = torch.softmax(x @ p["router"], -1)
    assert torch.equal(w, probs[tok, row_e])
    norm = moe._route(p, x, dataclasses.replace(cfg, norm_topk_prob=True), None)
    topv = torch.sort(probs, dim=-1, descending=True, stable=True).values[:, :cfg.top_k]
    assert torch.equal(norm[3], (topv / topv.sum(-1, keepdim=True)).reshape(-1)[order])
    assert torch.equal(norm[0], order) and torch.equal(norm[4], row_e)


def test_sequence_wise_balance_loss_is_the_mean_over_sequences():
    B, S = 3, 4
    cfg, p, x = _route_case(T=B * S, seq_aux=True)
    E, k = cfg.n_experts, cfg.top_k
    *_, aux = moe._route(p, x, cfg, None, seq_len=S)
    probs = torch.softmax(x @ p["router"], -1)
    picks = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    want = []
    for b in range(B):
        ce = torch.zeros(E)
        for e in picks[b * S:(b + 1) * S].reshape(-1).tolist():
            ce[e] += E / (S * k)
        want.append(float((ce * probs[b * S:(b + 1) * S].mean(0)).sum()))
    assert float(aux) == pytest.approx(sum(want) / B, rel=1e-6)
    # one sequence: the batch-wide loss
    *_, one = moe._route(p, x[:S], cfg, None, seq_len=S)
    *_, batch = moe._route(p, x[:S], dataclasses.replace(cfg, seq_aux=False), None)
    assert float(one) == pytest.approx(float(batch), rel=1e-6)


def test_seq_aux_refuses_a_chunk_that_splits_a_sequence():
    cfg = dataclasses.replace(_published().smoke(), moe_token_chunk=8)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu", torch.float32)
    with pytest.raises(NotImplementedError, match="whole sequences"):
        moe.apply_moe(params, torch.randn(1, 16, cfg.d_model), cfg)


# ---------------------------------------------------------------------------
# the defaults: the arithmetic before the fields, bit for bit

def test_defaults_keep_the_port_s_arithmetic_bitwise():
    cfg, p, x = _route_case()
    assert (cfg.norm_topk_prob, cfg.seq_aux, cfg.rope_scaling) == (True, False, None)
    order, tok, gs, w, row_e, aux = moe._route(p, x, cfg, None)
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    topv = torch.sort(probs, dim=-1, descending=True, stable=True).values[:, :cfg.top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    assert torch.equal(w, topv.reshape(-1)[order])
    frac = gs.float() / max(x.shape[0] * cfg.top_k, 1)
    assert torch.equal(aux, cfg.n_experts * torch.sum(frac * probs.mean(dim=0)))
    q = torch.randn(2, 7, 3, 16, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(7)
    freqs = torch.from_numpy(layers.rope_freqs(16, 10000.0))
    ang = (pos[..., None].float() * freqs)[..., None, :]
    x1, x2 = q.chunk(2, -1)
    want = torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x1 * torch.sin(ang) + x2 * torch.cos(ang)], -1)
    assert torch.equal(layers.apply_rope(q, pos, 10000.0), want)
    assert mla._scale(cfg) == 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def _small():
    c = dict(CONF, **SMALL)
    cfg = _published(**SMALL_PORT)
    params = weights.make_params(c, SEED, torch.device("cpu"))
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, 200, (2, 33), generator=g)
    return c, cfg, params, {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def test_tracing_changes_no_bit_of_the_step():
    _, cfg, params, batch = _small()
    grads_of = steps.make_grads_fn(cfg)
    (loss0, _), g0 = grads_of(params, batch)
    tracing.drain()
    tracing.enable()
    try:
        (loss1, _), g1 = grads_of(params, batch)
    finally:
        tracing.disable()
    spans = tracing.drain()
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(weights.leaves(g0),
                                                          weights.leaves(g1)))
    names = {s.name for s in spans}
    assert {"moe.backward", "mla.backward", "moe.experts", "mla.attend"} <= names
    by_id = {s.id: s for s in spans}
    back = [s for s in spans if s.name == "moe.backward"]
    assert len(back) == 2 and all(by_id[s.parent].name == "train.backward" for s in back)
    # the remat recompute of an MoE layer runs inside its backward span
    assert all(by_id[s.parent].name == "moe.backward" for s in spans
               if s.name == "moe.layer" and by_id[s.parent].name != "train.forward")
    assert tracing._stack == []


# ---------------------------------------------------------------------------
# the port against the plain reference

def _masks(cfg, params):
    """build_masks at r 0.75 from the statistics of a seeded update."""
    g = torch.Generator().manual_seed(4)
    moved = {"stack": {s: {"l0": {k: ({n: w + 0.01 * torch.randn(w.shape, generator=g)
                                       for n, w in v.items() if not isinstance(w, dict)}
                                      if k in ("ffn", "moe") else v)
                                  for k, v in params["stack"][s]["l0"].items()}}
                       for s in params["stack"]}}
    return hooks.build_masks(hooks.ffn_unit_stats(params, moved, cfg), cfg, 0.75)


def test_port_agrees_with_the_reference_under_masks():
    c, cfg, params, batch = _small()
    masks = _masks(cfg, params)
    dense, experts = masks[0]["l0"]["ffn"], masks[1]["l0"]["moe"]
    assert int(dense[0].sum()) == round(320 * 0.75)             # units: 320 is no 128 multiple
    assert (experts.reshape(2, 8, 2, 128).sum(-1) % 128 == 0).all()
    (loss, _), grads = steps.make_grads_fn(cfg, use_kernels=True)(params, batch, masks)
    live = {p: t.detach().requires_grad_() for p, t in weights.leaves(params)}
    tree = {}
    for p, t in live.items():
        weights._put(tree, p, t)
    keeps = [dense[0] > 0] + [m > 0 for m in experts]
    with mla_moe.exact_fp32():
        ref_loss = mla_moe.loss(tree, batch, c, keeps)
        ref = dict(zip(live, torch.autograd.grad(ref_loss, list(live.values()))))
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    for path, g in weights.leaves(grads):
        torch.testing.assert_close(g, ref[path], rtol=1e-4, atol=1e-6, msg=path)
    seg0, seg1 = grads["stack"]["seg0"]["l0"], grads["stack"]["seg1"]["l0"]
    drop = experts == 0                                            # (R, E, f)
    for name in ("w_in", "w_gate"):
        assert (seg1["moe"][name].transpose(-1, -2)[drop] == 0).all()
        assert (seg0["ffn"][name][0][:, dense[0] == 0] == 0).all()
    assert (seg1["moe"]["w_out"][drop] == 0).all()
    assert (seg0["ffn"]["w_out"][0][dense[0] == 0] == 0).all()
