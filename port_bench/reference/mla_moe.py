"""Plain PyTorch DeepSeek-V2 decoder: the reference of the MLA + MoE
configuration.

As the configuration file states it, in float32 with TF32 off, no kernels,
no cache and no batching tricks: token embedding; per layer RMSNorm (eps
``rms_norm_eps``), multi-head latent attention and RMSNorm again, then a
SwiGLU FFN (the first ``first_k_dense_replace`` layers) or the MoE; a final
RMSNorm and an untied head; the loss the mean next-token cross-entropy plus
``aux_loss_alpha`` (the file's ``assumed``) times the balance losses summed
over the MoE layers.

MLA without q-LoRA: q = h Wq split into nope and rope parts; the latent
c = RMSNorm(h W_dkv[:, :lora]) and a rotary key shared by the heads, h
W_dkv[:, lora:]; K and V from c through W_uk and W_uv; scores over nope +
rope times qk^-1/2 · mscale(factor, mscale_all_dim)^2, causal, softmax;
the heads' outputs through Wo. YaRN on the rotary slices: the frequencies
base^(-2j/r) below the correction range and the same over ``factor`` above
it, a linear ramp between, the range from ``beta_fast`` and ``beta_slow``
rotations at ``original_max_position_embeddings``; cos and sin times
mscale(factor, mscale) / mscale(factor, mscale_all_dim).

The MoE: a float32 softmax router over all experts; each token's top k,
the lower index first among equal probabilities; each pick weighted by
its probability as it is (``norm_topk_prob`` false); an expert's SwiGLU
with its units masked; the shared experts' SwiGLU unmasked, added. The
balance loss per sequence (``seq_aux``): for sequence b,
sum_i ce_b[i] P_b[i], ce_b[i] its picks of expert i times E / (S k), P_b[i]
its mean probability of expert i; the mean over sequences.

Departures from the published model, both the program's: the rotary
slices rotate split halves where the checkpoint rotates interleaved pairs
(with seeded weights a fixed permutation of the rope columns of Wq and
W_dkv); and the capacity the program trains with (``assumed``): each
expert takes the first cap = ceil(T k / E · capacity factor) of its picks
in (token, rank) order, T the batch's tokens, and an expert with more
picks than that loses its pick at place cap - 1 too.

To fit on the card each layer is recomputed in the backward
(``torch.utils.checkpoint``), taking the routing its forward decided, and
attention runs over blocks of queries; neither changes the arithmetic. ``precision`` is that of
``reference/decoder.py`` (``"fp8"`` every matmul operand rounded).

Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from reference.decoder import NEG, exact_fp32, mm, operand  # noqa: F401

Q_BLOCK = 1024


def rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def yarn_mscale(s, m):
    return 1.0 if s <= 1 else 0.1 * m * math.log(s) + 1.0


def rope_freqs(c, dim, device):
    """The rotary frequencies of a ``dim``-wide slice, with YaRN where the
    configuration has ``rope_scaling``; and the factor on cos and sin."""
    base = float(c["rope_theta"])
    j = torch.arange(dim // 2, dtype=torch.float64, device=device)
    extra = base ** (-2 * j / dim)
    y = c.get("rope_scaling")
    if not y:
        return extra.float(), 1.0
    s, L0 = y["factor"], y["original_max_position_embeddings"]
    corr = lambda rot: dim * math.log(L0 / (rot * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    ramp = ((j - low) / max(high - low, 1e-3)).clamp(0, 1)
    freqs = extra / s * ramp + extra * (1 - ramp)
    return freqs.float(), yarn_mscale(s, y["mscale"]) / yarn_mscale(s, y["mscale_all_dim"])


def rope(x, c):
    """Split-halves rotation of x (B, S, [heads,] r) at positions 0..S-1."""
    S, r = x.shape[1], x.shape[-1]
    freqs, k = rope_freqs(c, r, x.device)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    if x.ndim == 4:
        ang = ang[:, None, :]
    cos, sin = torch.cos(ang) * k, torch.sin(ang) * k
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def softmax_scale(c):
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    y = c.get("rope_scaling")
    m = yarn_mscale(y["factor"], y["mscale_all_dim"]) ** 2 if y else 1.0
    return qk ** -0.5 * m


def mla(p, h, c, precision="fp32"):
    B, S, d = h.shape
    H, nope, rdim = c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    vd, lora = c["v_head_dim"], c["kv_lora_rank"]
    q = mm(h, p["wq"].float().reshape(d, -1), precision).reshape(B, S, H, nope + rdim)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], c)
    ckv = mm(h, p["w_dkv"].float(), precision)
    lat = rms(ckv[..., :lora], p["kv_norm"], c["rms_norm_eps"])
    k_rope = rope(ckv[..., lora:], c)
    k_nope = mm(lat, p["w_uk"].float().reshape(lora, -1), precision).reshape(B, S, H, nope)
    v = mm(lat, p["w_uv"].float().reshape(lora, -1), precision).reshape(B, S, H, vd)
    scale = softmax_scale(c)
    outs = []
    for i in range(0, S, Q_BLOCK):
        qn, qr = q_nope[:, i:i + Q_BLOCK], q_rope[:, i:i + Q_BLOCK]
        n = qn.shape[1]
        s = (torch.einsum("bqhk,bthk->bhqt", operand(qn, precision), operand(k_nope, precision))
             + torch.einsum("bqhk,btk->bhqt", operand(qr, precision), operand(k_rope, precision)))
        causal = (torch.arange(S, device=h.device)[None, :]
                  <= torch.arange(i, i + n, device=h.device)[:, None])
        s = torch.where(causal, s * scale, torch.full_like(s, NEG))
        probs = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqt,bthk->bqhk", operand(probs, precision),
                                 operand(v, precision)))
    o = torch.cat(outs, dim=1).reshape(B, S, H * vd)
    return mm(o, p["wo"].float().reshape(H * vd, d), precision)


def swiglu(x, w_in, w_gate, w_out, keep=None, precision="fp32"):
    """keep: a bool mask of the units, or None."""
    u = torch.nn.functional.silu(mm(x, w_gate.float(), precision)) * mm(x, w_in.float(), precision)
    if keep is not None:
        u = torch.where(keep, u, torch.zeros_like(u))
    return mm(u, w_out.float(), precision)


def router_probs(p, x2d):
    return torch.softmax(x2d @ p["router"].float(), dim=-1)


def top_k(probs, c):
    """(T, k) experts: descending, the lower expert first among equal
    probabilities."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[
        :, :c["num_experts_per_tok"]]


def pick_weights(probs, picks):
    """Each pick's probability as it is (``norm_topk_prob`` false)."""
    return probs.gather(1, picks)


def capacity(c, T):
    return max(math.ceil(T * c["num_experts_per_tok"] / c["n_routed_experts"]
                         * c["assumed"]["moe_capacity_factor"]), 1)


def kept_picks(picks, c):
    """(T, k) bool: the picks an expert's capacity takes, in (token, rank)
    order, less the pick at place cap - 1 of an expert over capacity."""
    T, k = picks.shape
    E = c["n_routed_experts"]
    cap = capacity(c, T)
    flat = picks.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, E)                  # (T k, E)
    place = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]   # rank within expert
    count = onehot.sum(0)
    keep = (place < cap) & ~((place == cap - 1) & (count[flat] > cap))
    return keep.reshape(T, k)


def seq_balance_loss(picks, probs, c, B, S):
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    ce = torch.nn.functional.one_hot(picks.reshape(B, S * k), E).sum(1).float() * (E / (S * k))
    return (ce * probs.reshape(B, S, E).mean(1)).sum(1).mean()


def moe(p, h, c, keep_units, precision="fp32", routes=None):
    """keep_units: (E, f) bool, or None. Returns (y, balance loss).
    ``routes`` keeps the picks (and the capacity's cut of them) of the
    first call, which a recompute of the layer takes again: a near-tie
    decided otherwise the second time would change what the backward
    finds saved."""
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    probs = router_probs(p, x)
    if routes is None or "picks" not in routes:
        picks = top_k(probs.detach(), c)
        fresh = {"picks": picks, "kept": kept_picks(picks, c)}
        if routes is not None:
            routes.update(fresh)
        routes = fresh
    picks, kept = routes["picks"], routes["kept"]
    weights = pick_weights(probs, picks)
    y = torch.zeros_like(x)
    for e in range(c["n_routed_experts"]):
        tok, slot = torch.nonzero((picks == e) & kept, as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], p["w_in"][e], p["w_gate"][e], p["w_out"][e],
                         None if keep_units is None else keep_units[e], precision)
            y = y.index_add(0, tok, out * weights[tok, slot][:, None])
    y = y.reshape(B, S, d)
    s = p["shared"]
    y = y + swiglu(h, s["w_in"], s["w_gate"], s["w_out"], None, precision)
    return y, seq_balance_loss(picks, probs, c, B, S)


def block(p, x, c, keep, moe_layer, precision="fp32", routes=None):
    eps = c["rms_norm_eps"]
    x = x + mla(p["mla"], rms(x, p["norm1"]["scale"], eps), c, precision)
    h = rms(x, p["norm2"]["scale"], eps)
    if moe_layer:
        y, aux = moe(p["moe"], h, c, keep, precision, routes)
        return x + y, aux
    f = p["ffn"]
    return x + swiglu(h, f["w_in"], f["w_gate"], f["w_out"], keep, precision), x.new_zeros(())


def layers(params, c):
    """[(params of model layer i, is an MoE layer)] from the stacked tree
    (a stacked leaf a tensor, or a list of its layers)."""
    out = []
    for seg, moe_layer in (("seg0", False), ("seg1", True)):
        unit = params["stack"][seg]["l0"]
        R = len(unit["norm1"]["scale"])
        out += [(_at(unit, r), moe_layer) for r in range(R)]
    return out


def _at(t, r):
    return {k: _at(v, r) for k, v in t.items()} if isinstance(t, dict) else t[r]


def loss(params, batch, c, keeps=None, precision="fp32", record=None):
    """The loss; ``keeps`` per model layer a bool unit mask ((f,) dense,
    (E, f) MoE) or None; ``record`` a list that takes each MoE layer's
    (T, E) bool picks."""
    x = params["tok"]["embed"].float()[batch["tokens"].long()]
    aux_total = x.new_zeros(())
    for i, (p, moe_layer) in enumerate(layers(params, c)):
        keep = None if keeps is None else keeps[i]
        routes = {}

        def body(x, p=p, keep=keep, moe_layer=moe_layer, routes=routes):
            return block(p, x, c, keep, moe_layer, precision, routes)
        x, aux = checkpoint(body, x, use_reentrant=False)
        if record is not None and moe_layer:
            picks = routes["picks"]
            record.append(torch.zeros(picks.shape[0], c["n_routed_experts"], dtype=torch.bool,
                                      device=picks.device).scatter_(1, picks, True))
        aux_total = aux_total + aux
    x = rms(x, params["final_norm"]["scale"], c["rms_norm_eps"])
    lg = mm(x, params["tok"]["lm_head"].float(), precision)
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, batch["targets"].long()[..., None])[..., 0]
    return nll.mean() + c["assumed"]["aux_loss_alpha"] * aux_total
