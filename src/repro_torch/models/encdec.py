"""Encoder–decoder stack (port of ``repro/models/encdec.py``, the
SeamlessM4T text/speech backbone).

Encoder: bidirectional attention layers over frontend frame embeddings (the
audio frontend is a stub in the reference too: frames arrive as (B, S, d)).
Decoder: causal self-attention, cross-attention over the encoder memory,
FFN. Both stacks hold their layers' params stacked over a leading axis, as
the reference's scans do; the port loops over the layers.

The decoder's cache per layer: the self-attention ring {'k', 'v'}
(B, C, KV, hd) and the cross-attention K/V of the memory, 'cross_k' and
'cross_v' (B, M, KV, hd), computed once at prefill. Decode writes the self
cache in place and carries no slot record, as the decoder-only stacks do;
its self-attention is the GQA flash-decode kernel on the card
(``attention.attn_decode``), or under ``grouped_decode`` the grouped
attention. The FFNs carry biases (``use_bias``), which the training
kernels refuse, so every ``apply_ffn`` here is the dense masked FFN and the
train step's ``ffn_kernels`` does not reach this stack.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import (TensorSpec, apply_ffn, apply_norm,
                                       cdtype, init_ffn, init_norm)
from repro_torch.models.transformer import _at, _ring_from_seq, _stack_caches, remat


def _init_layers(gen, cfg: ModelConfig, n, names, device, dtype):
    """Params of n layers stacked (n, ...): norms, attentions ('attn',
    'cross') and the FFN, by name."""
    kw = dict(device=device, dtype=dtype, repeats=n)
    out = {}
    for name in names:
        if name.startswith("norm"):
            out[name] = init_norm(cfg, device, repeats=n)
        elif name == "ffn":
            out[name] = init_ffn(gen, cfg, **kw)
        else:
            out[name] = attention.init_attention(gen, cfg, **kw)
    return out


def init_encdec_stack(gen, cfg: ModelConfig, device, dtype):
    """{'enc': layers stacked over enc_layers, 'dec': over n_layers}."""
    return {"enc": _init_layers(gen, cfg, cfg.enc_layers,
                                ("norm1", "attn", "norm2", "ffn"), device, dtype),
            "dec": _init_layers(gen, cfg, cfg.n_layers,
                                ("norm1", "attn", "norm_c", "cross", "norm2", "ffn"),
                                device, dtype)}


def _cross_kv(p_cross, mem, cfg: ModelConfig):
    dt = cdtype(cfg)
    k, v = attention._proj(mem, p_cross["wk"], dt), attention._proj(mem, p_cross["wv"], dt)
    if "bk" in p_cross:
        k, v = k + p_cross["bk"].to(dt), v + p_cross["bv"].to(dt)
    return k, v


def _mem_positions(mem_k):
    """Every memory position visible to every query: position 0 each."""
    return torch.zeros((mem_k.shape[1],), dtype=torch.int32, device=mem_k.device)


def _ffn_mask(masks, r):
    return masks["ffn"][r] if masks is not None and "ffn" in masks else None


def run_encoder(params, frames, cfg: ModelConfig, masks=None):
    """frames: (B,S,d). Bidirectional, rope on. masks: {'ffn': (enc_layers,
    d_ff)} or None."""
    S = frames.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=frames.device)

    def layer(x, p, mask):
        y, _ = attention.attn_seq(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                                  positions, causal=False)
        x = x + y
        return x + apply_ffn(p["ffn"], apply_norm(p["norm2"], x, cfg), cfg,
                             neuron_mask=mask)
    x = frames.to(cdtype(cfg))
    for r in range(cfg.enc_layers):
        x = remat(cfg, layer, x, _at(params["enc"], r), _ffn_mask(masks, r))
    return x


def _dec_layer_seq(p, x, mem_kv, cfg: ModelConfig, positions, mask,
                   want_cache, cache_len=None, window_override=None):
    mem_k, mem_v = mem_kv
    y, (k, v) = attention.attn_seq(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                                   positions, window=window_override)
    cache = {}
    if want_cache:
        cache = {"attn": _ring_from_seq({"k": k, "v": v}, positions, window_override,
                                        cache_len=cache_len),
                 "cross_k": mem_k, "cross_v": mem_v}
    x = x + y
    y, _ = attention.attn_seq(p["cross"], apply_norm(p["norm_c"], x, cfg), cfg,
                              positions, kv_override=(mem_k, mem_v),
                              kv_positions=_mem_positions(mem_k))
    x = x + y
    x = x + apply_ffn(p["ffn"], apply_norm(p["norm2"], x, cfg), cfg, neuron_mask=mask)
    return x, cache


def run_decoder_seq(params, x, memory, cfg: ModelConfig, positions, masks=None,
                    want_cache=False, cache_len=None, window_override=None):
    """x: (B,S,d) decoder token embeddings; memory: (B,M,d). Returns (x,
    caches): with want_cache, {'attn': {'k','v'}, 'cross_k', 'cross_v'}
    stacked over the layers, else None."""
    def layer(x, memory, p, mask):
        return _dec_layer_seq(p, x, _cross_kv(p["cross"], memory, cfg), cfg,
                              positions, mask, want_cache, cache_len, window_override)
    per_layer = []
    for r in range(cfg.n_layers):
        x, cache = remat(cfg, layer, x, memory, _at(params["dec"], r), _ffn_mask(masks, r))
        per_layer.append(cache)
    return x, (_stack_caches(per_layer) if want_cache else None)


def run_decoder_decode(params, caches, x, cfg: ModelConfig, pos, masks=None,
                       window_override=None, grouped_decode=False):
    """x: (B,1,d); pos: (B,). Returns x; the self-attention caches are
    updated in place. grouped_decode: the self-attention by
    ``attention._sdpa_grouped``."""
    for r in range(cfg.n_layers):
        p, c = _at(params["dec"], r), _at(caches, r)
        x = x + attention.attn_decode(p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
                                      c["attn"], pos, window=window_override,
                                      grouped=grouped_decode)
        y, _ = attention.attn_seq(p["cross"], apply_norm(p["norm_c"], x, cfg), cfg,
                                  pos[:, None], kv_override=(c["cross_k"], c["cross_v"]),
                                  kv_positions=_mem_positions(c["cross_k"]))
        x = x + y
        x = x + apply_ffn(p["ffn"], apply_norm(p["norm2"], x, cfg), cfg,
                          neuron_mask=_ffn_mask(masks, r))
    return x


def dec_cache_specs(cfg: ModelConfig, batch, seq_len, mem_len, window_override=None):
    """{'attn': {'k','v': (L, B, C, KV, hd)}, 'cross_k', 'cross_v':
    (L, B, mem_len, KV, hd)}, L = n_layers, C = seq_len (min(window_override,
    seq_len) under window_override), in the compute dtype."""
    C = seq_len if window_override is None else min(window_override, seq_len)
    L = cfg.n_layers
    stacked = lambda s: TensorSpec((L,) + s.shape, s.dtype)
    cross = TensorSpec((batch, mem_len, cfg.n_kv_heads, cfg.head_dim), cdtype(cfg))
    return {"attn": {k: stacked(s) for k, s in
                     attention.cache_spec(cfg, batch, C).items()},
            "cross_k": stacked(cross), "cross_v": stacked(cross)}
