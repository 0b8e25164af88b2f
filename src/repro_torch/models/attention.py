"""GQA/MQA attention with a KV cache (port of ``repro/models/attention.py``).

  attn_seq(...)     -- full sequence (prefill), plain torch ops as in the
                       reference (which computes it in plain jnp)
  attn_decode(...)  -- one new token per row against the cache, through
                       the flash-decode kernel (kernels/decode_gqa.py)
Cache layout per layer: k, v (B, C, KV, hd). The reference also carries
per-slot positions; the port does not need them (see ``attn_decode``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (TensorSpec, apply_rope, cdtype,
                                       dense_init, pdtype)

Q_CHUNK = 1024
NEG = -1e30


def init_attention(gen, cfg: ModelConfig, device, dtype, repeats=None):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device, repeats=repeats)
    p = {"wq": dense_init(gen, d, d, H, hd, **kw),
         "wk": dense_init(gen, d, d, KV, hd, **kw),
         "wv": dense_init(gen, d, d, KV, hd, **kw),
         "wo": dense_init(gen, H * hd, H, hd, d, **kw)}
    if cfg.use_bias:
        lead = (repeats,) if repeats else ()
        z = lambda *s: torch.zeros(*lead, *s, dtype=pdtype(cfg), device=device)
        p["bq"], p["bk"], p["bv"], p["bo"] = z(H, hd), z(KV, hd), z(KV, hd), z(d)
    return p


def _proj(x, w, dt):
    """x (B,S,d) @ w (d, heads, hd) -> (B, S, heads, hd)."""
    d, nh, hd = w.shape
    return (x @ w.reshape(d, nh * hd).to(dt)).reshape(*x.shape[:2], nh, hd)


def _qkv(p, x, cfg: ModelConfig, positions):
    dt = cdtype(cfg)
    q, k, v = _proj(x, p["wq"], dt), _proj(x, p["wk"], dt), _proj(x, p["wv"], dt)
    if "bq" in p:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p, o, cfg: ModelConfig):
    """o (B,S,H,hd) @ wo (H,hd,d) -> (B,S,d)."""
    dt = cdtype(cfg)
    H, hd, d = p["wo"].shape
    y = o.reshape(*o.shape[:2], H * hd) @ p["wo"].reshape(H * hd, d).to(dt)
    if "bo" in p:
        y = y + p["bo"].to(dt)
    return y


def _expand_kv(k, n_heads):
    """(B,T,KV,hd) -> (B,T,H,hd) by group repeat."""
    KV = k.shape[2]
    if KV == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // KV, dim=2)


def _sdpa(q, k, v, q_pos, kv_pos, scale):
    """q:(B,Sq,H,hd) k,v:(B,T,H,hd); causal mask from absolute positions
    kv_pos (T,) and q_pos (Sq,)."""
    scores = torch.einsum("bqhk,bthk->bhqt", q, k).float() * scale
    mask = kv_pos[None, None, None, :] <= q_pos[None, None, :, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqt,bthk->bqhk", w.to(v.dtype), v)


def attn_seq(p, x, cfg: ModelConfig, positions):
    """Full-sequence self-attention. Returns (out, (k, v)) for the cache."""
    B, S, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    q, k, v = _qkv(p, x, cfg, positions)
    kf = _expand_kv(k, cfg.n_heads)
    vf = _expand_kv(v, cfg.n_heads)
    if S <= Q_CHUNK:
        out = _sdpa(q, kf, vf, positions, positions, scale)
    else:
        if S % Q_CHUNK:
            raise ValueError(f"sequence length {S} must be a multiple of "
                             f"{Q_CHUNK} above {Q_CHUNK}")
        out = torch.cat([
            _sdpa(q[:, i:i + Q_CHUNK], kf, vf, positions[i:i + Q_CHUNK],
                  positions, scale)
            for i in range(0, S, Q_CHUNK)], dim=1)
    return _out(p, out, cfg), (k, v)


def attn_decode(p, x, cfg: ModelConfig, cache, pos):
    """One-token decode. x: (B,1,d); cache: {'k','v'} (B,C,KV,hd), updated
    IN PLACE (the reference returns a rewritten cache); pos: (B,) int.
    Returns y (B,1,d).

    The new K/V go to slot pos % C. The cache always holds the last
    min(pos+1, C) positions in its first min(pos+1, C) slots: contiguously
    from slot 0 until the ring wraps, and in every slot after. Attention is
    order-free over the keys, so lengths = min(pos+1, C) selects exactly the
    slots the reference's per-slot position mask keeps."""
    B = x.shape[0]
    C = cache["k"].shape[1]
    q, k_new, v_new = _qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(B, device=x.device)
    idx = (pos % C).long()
    cache["k"].index_put_((rows, idx), k_new[:, 0])
    cache["v"].index_put_((rows, idx), v_new[:, 0])
    lengths = torch.clamp(pos + 1, max=C).to(torch.int32)
    out = ops.decode_gqa(q[:, 0], cache["k"], cache["v"], lengths)
    return _out(p, out[:, None], cfg)


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int):
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, cdtype(cfg)),
            "v": TensorSpec(shape, cdtype(cfg))}
