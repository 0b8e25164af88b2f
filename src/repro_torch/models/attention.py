"""GQA/MQA attention with sliding-window support and a ring-buffer KV
cache (port of ``repro/models/attention.py``).

  attn_seq(...)     -- full sequence (prefill), causal or bidirectional, or
                       cross-attention over given K/V; plain torch ops as
                       in the reference (which computes it in plain jnp)
  attn_decode(...)  -- one new token per row against the cache: through
                       the flash-decode kernel (kernels/decode_gqa.py), or,
                       for a windowed layer, the plain windowed attention;
                       with grouped=True the grouped attention
                       ``_sdpa_grouped`` (no K/V expansion)
Cache layout per layer: k, v (B, C, KV, hd). The reference also carries
per-slot positions; the port derives them from the decode position (see
``slot_positions``).
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


def _sdpa(q, k, v, q_pos, kv_pos, scale, window=None, causal=True):
    """q:(B,Sq,H,hd) k,v:(B,T,H,hd); causal (and window) mask from absolute
    positions kv_pos (T,) or (B,T), -1 an empty slot, and q_pos (Sq,) or
    (B,Sq). A key is kept where 0 <= kv, kv <= q if causal, and
    q - kv < window."""
    scores = torch.einsum("bqhk,bthk->bhqt", q, k).float() * scale
    kv_b = kv_pos[None, None, None, :] if kv_pos.ndim == 1 else kv_pos[:, None, None, :]
    q_b = q_pos[None, None, :, None] if q_pos.ndim == 1 else q_pos[:, None, :, None]
    mask = kv_b >= 0
    if causal:
        mask = mask & (kv_b <= q_b)
    if window is not None:
        mask &= (q_b - kv_b) < window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqt,bthk->bqhk", w.to(v.dtype), v)


def _sdpa_grouped(q, k, v, q_pos, kv_pos, scale, window=None, causal=True):
    """GQA attention without expanding K/V to the H query heads (reference
    ``_sdpa_grouped``): q (B,Sq,H,hd); k, v (B,T,KV,hd); positions and
    masks as ``_sdpa``. The query heads of a K/V head form a group G =
    H/KV that reads the cache once, never a repeated copy of it."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float() * scale
    kv_b = (kv_pos[:, None, None, None, :] if kv_pos.ndim == 2
            else kv_pos[None, None, None, None, :])
    q_b = (q_pos[:, None, None, :, None] if q_pos.ndim == 2
           else q_pos[None, None, None, :, None])
    mask = kv_b >= 0
    if causal:
        mask = mask & (kv_b <= q_b)
    if window is not None:
        mask = mask & ((q_b - kv_b) < window)
    s = torch.where(mask, s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def attn_seq(p, x, cfg: ModelConfig, positions, window=None, kv_override=None,
             kv_positions=None, causal=True):
    """Full-sequence attention, windowed when ``window`` is given,
    bidirectional when not ``causal``. kv_override: (k, v) (B,T,KV,hd) for
    cross-attention, at ``kv_positions`` (T,); q then takes its projection
    and bias but no rope. Returns (out, (k, v)) for the cache."""
    B, S, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if kv_override is None:
        q, k, v = _qkv(p, x, cfg, positions)
        kv_pos = positions
    else:
        dt = cdtype(cfg)
        q = _proj(x, p["wq"], dt)
        if "bq" in p:
            q = q + p["bq"].to(dt)
        k, v = kv_override
        kv_pos = kv_positions
    kf = _expand_kv(k, cfg.n_heads)
    vf = _expand_kv(v, cfg.n_heads)
    if S <= Q_CHUNK:
        out = _sdpa(q, kf, vf, positions, kv_pos, scale, window, causal)
    else:
        if S % Q_CHUNK:
            raise ValueError(f"sequence length {S} must be a multiple of "
                             f"{Q_CHUNK} above {Q_CHUNK}")
        out = torch.cat([
            _sdpa(q[:, i:i + Q_CHUNK], kf, vf, positions[i:i + Q_CHUNK],
                  kv_pos, scale, window, causal)
            for i in range(0, S, Q_CHUNK)], dim=1)
    return _out(p, out, cfg), (k, v)


def slot_positions(pos, C):
    """(B, C) position each ring slot holds once position ``pos`` (B,) is
    written, -1 where a slot holds none: slot s holds the latest p <= pos
    with p % C == s. Prefill and decode write every position from 0 on, so
    this is the reference's per-slot position record."""
    s = torch.arange(C, device=pos.device)[None, :]
    held = pos[:, None] - torch.remainder(pos[:, None] - s, C)
    return torch.where(held >= 0, held, torch.full_like(held, -1))


def write_slot(cache, pos, new):
    """Write each row's new entry (B, ...) into slot pos % C of the ring
    caches, in place. cache, new: dicts of tensors (B, C, ...), (B, ...)."""
    first = next(iter(cache.values()))
    rows = torch.arange(first.shape[0], device=first.device)
    idx = (pos % first.shape[1]).long()
    for name, t in new.items():
        cache[name].index_put_((rows, idx), t)


def attn_decode(p, x, cfg: ModelConfig, cache, pos, window=None, grouped=False):
    """One-token decode. x: (B,1,d); cache: {'k','v'} (B,C,KV,hd), updated
    IN PLACE (the reference returns a rewritten cache); pos: (B,) int.
    Returns y (B,1,d).

    grouped=True is the route of the reference's sequence-sharded cache,
    which on one card only changes the math: the attention is
    ``_sdpa_grouped`` over ``slot_positions``, windowed or not, in place of
    the kernel. The reference's uniform-position mode (one slot written for
    every row) has no route here: when the rows share a position the
    per-row write fills the same slots.

    The new K/V go to slot pos % C. The cache always holds the last
    min(pos+1, C) positions in its first min(pos+1, C) slots: contiguously
    from slot 0 until the ring wraps, and in every slot after. Attention is
    order-free over the keys, so lengths = min(pos+1, C) selects exactly the
    slots the reference's per-slot position mask keeps. A windowed layer
    takes the plain windowed attention over ``slot_positions``, as the
    reference keeps it off the flash-decode kernel."""
    C = cache["k"].shape[1]
    q, k_new, v_new = _qkv(p, x, cfg, pos[:, None])
    write_slot(cache, pos, {"k": k_new[:, 0], "v": v_new[:, 0]})
    if grouped:
        out = _sdpa_grouped(q, cache["k"], cache["v"], pos[:, None],
                            slot_positions(pos, C), 1.0 / math.sqrt(cfg.head_dim),
                            window)
        return _out(p, out, cfg)
    if window is not None:
        out = _sdpa(q, _expand_kv(cache["k"], cfg.n_heads),
                    _expand_kv(cache["v"], cfg.n_heads), pos[:, None],
                    slot_positions(pos, C), 1.0 / math.sqrt(cfg.head_dim),
                    window)
        return _out(p, out, cfg)
    lengths = torch.clamp(pos + 1, max=C).to(torch.int32)
    out = ops.decode_gqa(q[:, 0], cache["k"], cache["v"], lengths)
    return _out(p, out[:, None], cfg)


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int):
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, cdtype(cfg)),
            "v": TensorSpec(shape, cdtype(cfg))}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device):
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in cache_spec(cfg, batch, cache_len).items()}
