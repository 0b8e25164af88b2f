"""Multi-head Latent Attention, DeepSeek-V2 / MiniCPM3 (port of
``repro/models/mla.py``).

KV is compressed to a latent c_kv of rank ``kv_lora_rank`` plus a shared
rope-carrying key slice. The decode cache stores only (c_kv, k_rope).

Two decode paths:
  * baseline  -- expand K/V from the latent for every cached slot (the
                 reference formulation)
  * absorbed  -- absorb W_uk / W_uv into the query/output projections and
                 attend directly in latent space
The reference has no Pallas kernel here: every op is plain torch, as it
is plain jnp there. Decode updates the cache in place.

A config's ``rope_scaling`` (DeepSeek-V2's YaRN, beyond the reference)
sets the rotary slice's frequencies and multiplies the softmax scale by
mscale(factor, mscale_all_dim)^2.

Spans (``tracing``): ``mla.layer`` around a prefill or training call,
holding ``mla.project`` (the query and latent projections) and
``mla.attend`` (its attributes the queries and keys); ``mla.backward``
from the backward's arrival at the call's output to its departure from
the input.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import NEG, Q_CHUNK, slot_positions, write_slot
from repro_torch.models.layers import (TensorSpec, apply_rope, cdtype,
                                       dense_init, pdtype, yarn_mscale)


def init_mla(gen, cfg: ModelConfig, device, dtype, repeats=None):
    d, H = cfg.d_model, cfg.n_heads
    nope, rope, vd, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                            cfg.v_head_dim, cfg.kv_lora_rank)
    kw = dict(dtype=dtype, device=device, repeats=repeats)
    lead = (repeats,) if repeats else ()
    ones = lambda n: torch.ones(*lead, n, dtype=pdtype(cfg), device=device)
    p = {}
    if cfg.q_lora_rank:
        p["w_dq"] = dense_init(gen, d, d, cfg.q_lora_rank, **kw)
        p["w_uq"] = dense_init(gen, cfg.q_lora_rank, cfg.q_lora_rank, H,
                               nope + rope, **kw)
        p["q_norm"] = ones(cfg.q_lora_rank)
    else:
        p["wq"] = dense_init(gen, d, d, H, nope + rope, **kw)
    p["w_dkv"] = dense_init(gen, d, d, lora + rope, **kw)
    p["kv_norm"] = ones(lora)
    p["w_uk"] = dense_init(gen, lora, lora, H, nope, **kw)
    p["w_uv"] = dense_init(gen, lora, lora, H, vd, **kw)
    p["wo"] = dense_init(gen, H * vd, H, vd, d, **kw)
    return p


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _queries(p, x, cfg: ModelConfig, positions):
    dt = cdtype(cfg)
    nope = cfg.qk_nope_dim
    if cfg.q_lora_rank:
        cq = _rms(x @ p["w_dq"].to(dt), p["q_norm"])
        q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"].to(dt))
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta,
                              scaling=cfg.rope_scaling)


def _latent(p, x, cfg: ModelConfig, positions):
    dt = cdtype(cfg)
    lora = cfg.kv_lora_rank
    ckv_full = x @ p["w_dkv"].to(dt)
    c_kv = _rms(ckv_full[..., :lora], p["kv_norm"])
    k_rope = apply_rope(ckv_full[..., lora:], positions, cfg.rope_theta,
                        has_heads=False, scaling=cfg.rope_scaling)
    return c_kv, k_rope


def _mask(s, q_pos, kv_pos):
    """Keep keys with 0 <= kv <= q. s: (B,H,Sq,T); q_pos (Sq,) or (B,Sq);
    kv_pos (T,) or (B,T), -1 an empty slot."""
    qb = q_pos[:, None, :, None] if q_pos.ndim == 2 else q_pos[None, None, :, None]
    kb = kv_pos[:, None, None, :] if kv_pos.ndim == 2 else kv_pos[None, None, None, :]
    return torch.where((kb >= 0) & (kb <= qb), s, torch.full_like(s, NEG))


def _scale(cfg: ModelConfig):
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    yarn = cfg.yarn
    if yarn and yarn.get("mscale_all_dim"):
        scale = scale * yarn_mscale(yarn["factor"], yarn["mscale_all_dim"]) ** 2
    return scale


def _attend(p, q_nope, q_rope, c_kv, k_rope, cfg, q_pos, kv_pos):
    """Baseline attention: expand k, v from the latent. Shapes:
    q_*: (B,Sq,H,·)  c_kv: (B,T,lora)  k_rope: (B,T,rope)."""
    dt = cdtype(cfg)
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, p["w_uk"].to(dt))
    v = torch.einsum("btr,rhk->bthk", c_kv, p["w_uv"].to(dt))
    s = (torch.einsum("bqhk,bthk->bhqt", q_nope, k_nope)
         + torch.einsum("bqhk,btk->bhqt", q_rope, k_rope))
    s = _mask(s.float() * _scale(cfg), q_pos, kv_pos)
    w = torch.softmax(s, dim=-1).to(dt)
    out = torch.einsum("bhqt,bthk->bqhk", w, v)
    return torch.einsum("bqhk,hkd->bqd", out, p["wo"].to(dt))


def mla_seq(p, x, cfg: ModelConfig, positions):
    """Prefill. Returns (y, (c_kv, k_rope)) for the cache; queries go in
    chunks of Q_CHUNK (1024) above that length, as in the reference."""
    S = x.shape[1]
    if S > Q_CHUNK and S % Q_CHUNK:
        raise ValueError(f"sequence length {S} must be a multiple of "
                         f"{Q_CHUNK} above {Q_CHUNK}")
    mark_input, mark_output = tracing.backward_marks("mla.backward")
    with tracing.span("mla.layer"):
        x = mark_input(x)
        with tracing.span("mla.project"):
            q_nope, q_rope = _queries(p, x, cfg, positions)
            c_kv, k_rope = _latent(p, x, cfg, positions)
        with tracing.span("mla.attend", queries=x.shape[0] * S, keys=x.shape[0] * S):
            if S <= Q_CHUNK:
                y = _attend(p, q_nope, q_rope, c_kv, k_rope, cfg, positions, positions)
            else:
                y = torch.cat([
                    _attend(p, q_nope[:, i:i + Q_CHUNK], q_rope[:, i:i + Q_CHUNK],
                            c_kv, k_rope, cfg, positions[i:i + Q_CHUNK], positions)
                    for i in range(0, S, Q_CHUNK)], dim=1)
        return mark_output(y), (c_kv, k_rope)


def mla_decode(p, x, cfg: ModelConfig, cache, pos, absorb=False):
    """One-token decode. x: (B,1,d); cache: {'c_kv': (B,C,lora), 'k_rope':
    (B,C,rope)}, updated IN PLACE; pos: (B,) int. Returns y (B,1,d).
    absorb=True attends in latent space with W_uk folded into the query
    and W_uv applied to the attended latent."""
    dt = cdtype(cfg)
    C = cache["c_kv"].shape[1]
    q_nope, q_rope = _queries(p, x, cfg, pos[:, None])
    c_new, kr_new = _latent(p, x, cfg, pos[:, None])
    write_slot(cache, pos, {"c_kv": c_new[:, 0], "k_rope": kr_new[:, 0]})
    ckv, krope = cache["c_kv"], cache["k_rope"]
    slots = slot_positions(pos, C)
    if not absorb:
        return _attend(p, q_nope, q_rope, ckv, krope, cfg, pos[:, None], slots)
    q_eff = torch.einsum("bqhk,rhk->bqhr", q_nope, p["w_uk"].to(dt))
    s = (torch.einsum("bqhr,btr->bhqt", q_eff, ckv)
         + torch.einsum("bqhk,btk->bhqt", q_rope, krope))
    s = _mask(s.float() * _scale(cfg), pos[:, None], slots)
    w = torch.softmax(s, dim=-1).to(dt)
    lat = torch.einsum("bhqt,btr->bqhr", w, ckv)
    out = torch.einsum("bqhr,rhk->bqhk", lat, p["w_uv"].to(dt))
    return torch.einsum("bqhk,hkd->bqd", out, p["wo"].to(dt))


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int):
    dt = cdtype(cfg)
    return {"c_kv": TensorSpec((batch, cache_len, cfg.kv_lora_rank), dt),
            "k_rope": TensorSpec((batch, cache_len, cfg.qk_rope_dim), dt)}
