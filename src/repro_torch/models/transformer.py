"""Segment-based decoder stack (port of ``repro/models/transformer.py``).

A model is a list of *segments*: (unit_pattern, repeats). Params of a
segment are stacked over repeats with a leading axis R, as in the
reference, and the reference's ``lax.scan`` over repeats is a Python loop
over r here. Mixed-pattern archs (RecurrentGemma's 2:1) decompose into a
few segments.

Layer kinds:  attn | local_attn (MLA or GQA) | rglru | rwkv    (mixer)
              dense | moe | cmix                              (ffn)
A parallel block (Command-R) sums mixer and FFN of one norm. An MoE FFN
(models/moe.py) takes the layer's (E, f) expert-unit mask and (E,) expert
mask, and its router loss is summed over layers. Decode updates the caches
in place. With cfg.remat == "block" a differentiated sequence pass
recomputes each unit in the backward (``remat``), as the reference
checkpoints each scanned unit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models import attention, mla, moe, rglru, rwkv6
from repro_torch.models.layers import (TensorSpec, apply_ffn, apply_norm,
                                       cdtype, init_ffn, init_norm)

LayerSpec = Tuple[str, str]        # (mixer, ffn)

PORTED = (("attn", "dense"), ("attn", "moe"), ("local_attn", "dense"),
          ("rglru", "dense"), ("rwkv", "cmix"))
ATTN_MIXERS = ("attn", "local_attn")


@dataclass(frozen=True)
class Segment:
    unit: Tuple[LayerSpec, ...]
    repeats: int


def layer_specs(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    out = []
    for i in range(cfg.n_layers):
        mixer = cfg.block_pattern[i % len(cfg.block_pattern)]
        ffn = "cmix" if mixer == "rwkv" else cfg.ffn_kind_for_layer(i)
        out.append((mixer, ffn))
    return tuple(out)


def _rle(specs):
    runs = []
    for s in specs:
        if runs and runs[-1][0] == s:
            runs[-1][1] += 1
        else:
            runs.append([s, 1])
    return runs


def build_segments(cfg: ModelConfig) -> Tuple[Segment, ...]:
    specs = layer_specs(cfg)
    runs = _rle(specs)
    if len(runs) <= 3:
        return tuple(Segment((s,), n) for s, n in runs)
    unit = specs[:len(cfg.block_pattern)]
    k = len(specs) // len(unit)
    rem = specs[k * len(unit):]
    segs = [Segment(unit, k)]
    segs += [Segment((s,), n) for s, n in _rle(rem)]
    return tuple(segs)


def _check_ported(spec: LayerSpec, cfg: ModelConfig):
    if spec not in PORTED:
        raise NotImplementedError(
            f"layer kind {spec} of {cfg.name} is not ported to repro_torch "
            f"yet; only {PORTED} are (see ROADMAP.md queue A)")


def _layer_window(mixer: str, cfg: ModelConfig, window_override=None):
    """An attention layer's window: cfg.window for local attention, else
    window_override (the long-context windowed variant), else None."""
    if mixer == "local_attn":
        return cfg.window
    return window_override


def _at(tree, r):
    """Repeat r of a stacked (R, ...) param or mask dict."""
    if isinstance(tree, dict):
        return {k: _at(v, r) for k, v in tree.items()}
    return tree[r]


# ---------------------------------------------------------------------------
# init

def init_segment(gen, seg: Segment, cfg: ModelConfig, device, dtype):
    out = {}
    for i, spec in enumerate(seg.unit):
        kw = dict(device=device, dtype=dtype, repeats=seg.repeats)
        p = {"norm1": init_norm(cfg, device, repeats=seg.repeats)}
        if spec[0] in ATTN_MIXERS and cfg.use_mla:
            p["mla"] = mla.init_mla(gen, cfg, **kw)
        elif spec[0] in ATTN_MIXERS:
            p["attn"] = attention.init_attention(gen, cfg, **kw)
        elif spec[0] == "rglru":
            p["rglru"] = rglru.init_rglru(gen, cfg, **kw)
        else:
            p["rwkv"] = rwkv6.init_tmix(gen, cfg, **kw)
        if not cfg.parallel_block:
            p["norm2"] = init_norm(cfg, device, repeats=seg.repeats)
        if spec[1] == "cmix":
            p["cmix"] = rwkv6.init_cmix(gen, cfg, **kw)
        elif spec[1] == "moe":
            p["moe"] = moe.init_moe(gen, cfg, **kw)
        else:
            p["ffn"] = init_ffn(gen, cfg, **kw)
        out[f"l{i}"] = p
    return out


def init_stack(gen, cfg: ModelConfig, device, dtype):
    for spec in layer_specs(cfg):          # raise before drawing anything
        _check_ported(spec, cfg)
    segs = build_segments(cfg)
    return [init_segment(gen, s, cfg, device, dtype) for s in segs], segs


# ---------------------------------------------------------------------------
# sequence (prefill) pass

def _m(masks, key):
    if masks is None:
        return None
    return masks.get(key)


def _ring_from_seq(tensors, positions, window=None, cache_len=None):
    """Fold full-sequence K/V (B,S,...) into a ring cache of C slots,
    C = cache_len (default S), or min(window, cache_len) for a windowed
    layer; the last min(C, S) positions p land in slot p % C. cache_len > S
    leaves decode headroom."""
    S = positions.shape[-1]
    cap = cache_len or S
    C = cap if window is None else min(window, cap)
    out = {}
    for name, t in tensors.items():
        if C == S:
            out[name] = t
            continue
        n = min(C, S)
        idx = (positions[-n:] % C).long()
        ring = torch.zeros((t.shape[0], C) + tuple(t.shape[2:]), dtype=t.dtype,
                           device=t.device)
        ring[:, idx] = t[:, -n:]
        out[name] = ring
    return out


def _apply_ffn_or_moe(spec, p, h2, cfg: ModelConfig, masks, ffn_kernels=False):
    """The layer's FFN on the normed h2: (y, aux), aux 0 for a dense FFN.
    ffn_kernels: a dense FFN takes the training kernels (``apply_ffn``)."""
    if spec[1] == "moe":
        return moe.apply_moe(p["moe"], h2, cfg, neuron_mask=_m(masks, "moe"),
                             expert_mask=_m(masks, "experts"))
    return apply_ffn(p["ffn"], h2, cfg, neuron_mask=_m(masks, "ffn"),
                     kernels=ffn_kernels), 0.0


def _apply_layer_seq(spec, p, x, cfg: ModelConfig, positions, masks,
                     want_cache, cache_len=None, window_override=None,
                     ffn_kernels=False):
    """Returns (x, cache_entry, aux)."""
    _check_ported(spec, cfg)
    mixer = spec[0]
    h = apply_norm(p["norm1"], x, cfg)
    if mixer == "rwkv":
        y, last_tm, state = rwkv6.tmix_seq(p["rwkv"], h, cfg)
        x = x + y
        h2 = apply_norm(p["norm2"], x, cfg)
        y, last_cm = rwkv6.cmix_seq(p["cmix"], h2, cfg,
                                    neuron_mask=_m(masks, "ffn"))
        cache = ({"rwkv": {"S": state, "shift_tm": last_tm, "shift_cm": last_cm}}
                 if want_cache else {})
        return x + y, cache, 0.0
    cache = {}
    if mixer == "rglru":
        y, cache["rglru"] = rglru.rglru_seq(p["rglru"], h, cfg)
    elif cfg.use_mla:
        y, (c_kv, k_rope) = mla.mla_seq(p["mla"], h, cfg, positions)
        cache["mla"] = {"c_kv": c_kv, "k_rope": k_rope}
    else:
        y, (k, v) = attention.attn_seq(p["attn"], h, cfg, positions,
                                       window=_layer_window(mixer, cfg, window_override))
        cache["attn"] = {"k": k, "v": v}
    if not want_cache:
        cache = {}
    elif mixer in ATTN_MIXERS:
        cache = {name: _ring_from_seq(c, positions,
                                      _layer_window(mixer, cfg, window_override), cache_len)
                 for name, c in cache.items()}
    if cfg.parallel_block:
        return x + y + apply_ffn(p["ffn"], h, cfg, neuron_mask=_m(masks, "ffn"),
                                 kernels=ffn_kernels), cache, 0.0
    x = x + y
    f, aux = _apply_ffn_or_moe(spec, p, apply_norm(p["norm2"], x, cfg), cfg, masks,
                               ffn_kernels)
    return x + f, cache, aux


def _stack_caches(per_repeat):
    """[{'l0': {'attn': {'k': t}}}] * R -> {'l0': {'attn': {'k': (R, ...)}}}."""
    first = per_repeat[0]
    if isinstance(first, dict):
        return {k: _stack_caches([c[k] for c in per_repeat]) for k in first}
    return torch.stack(per_repeat)


def remat(cfg: ModelConfig, fn, *args):
    """fn(*args); under cfg.remat == "block", when the call is
    differentiated, its activations are dropped and recomputed in the
    backward (``torch.utils.checkpoint``), the reference's jax.checkpoint.
    fn carries its routes in its closure, so the recompute takes the
    forward's."""
    if not (cfg.remat == "block" and torch.is_grad_enabled()
            and any(isinstance(t, torch.Tensor) and t.requires_grad
                    for t in tree_leaves(args))):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def run_stack_seq(seg_params, segs, x, cfg: ModelConfig, positions,
                  masks=None, want_cache=False, cache_len=None, window_override=None,
                  ffn_kernels=False):
    """x: (B,S,d). Returns (x, caches, aux): aux the MoE router losses
    summed in layer order (0 without an MoE layer). masks: list per segment
    of per-unit dicts with stacked (R, ...) leaves, or None.
    window_override: a window for every full-attention layer. ffn_kernels:
    dense FFNs under an (f,) mask take the training kernels."""
    caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (seg, sp) in enumerate(zip(segs, seg_params)):
        smasks = masks[si] if masks is not None else None

        # the unit and the routes are bound now: remat runs the body again
        # in the backward
        def unit_body(x, aux_total, up, um, unit=seg.unit):
            cache_u = {}
            for i, spec in enumerate(unit):
                lm = um[f"l{i}"] if um is not None else None
                x, cache_u[f"l{i}"], aux = _apply_layer_seq(
                    spec, up[f"l{i}"], x, cfg, positions, lm, want_cache, cache_len,
                    window_override, ffn_kernels)
                aux_total = aux_total + aux
            return x, aux_total, cache_u

        per_repeat = []
        for r in range(seg.repeats):
            x, aux_total, cache_u = remat(cfg, unit_body, x, aux_total, _at(sp, r),
                                          _at(smasks, r) if smasks is not None else None)
            per_repeat.append(cache_u)
        caches.append(_stack_caches(per_repeat) if want_cache else None)
    return x, caches, aux_total


# ---------------------------------------------------------------------------
# decode pass

def _apply_layer_decode(spec, p, x, cache, cfg: ModelConfig, pos, masks,
                        mla_absorb=False, window_override=None, grouped_decode=False):
    _check_ported(spec, cfg)
    mixer = spec[0]
    h = apply_norm(p["norm1"], x, cfg)
    if mixer == "rwkv":
        c = cache["rwkv"]
        y, last_tm, S1 = rwkv6.tmix_decode(p["rwkv"], h, cfg, c["shift_tm"], c["S"])
        c["S"].copy_(S1)
        c["shift_tm"].copy_(last_tm)
        x = x + y
        h2 = apply_norm(p["norm2"], x, cfg)
        y, last_cm = rwkv6.cmix_decode(p["cmix"], h2, cfg, c["shift_cm"],
                                       neuron_mask=_m(masks, "ffn"))
        c["shift_cm"].copy_(last_cm)
        return x + y
    if mixer == "rglru":
        y = rglru.rglru_decode(p["rglru"], h, cfg, cache["rglru"])
    elif cfg.use_mla:
        y = mla.mla_decode(p["mla"], h, cfg, cache["mla"], pos, absorb=mla_absorb)
    else:
        y = attention.attn_decode(p["attn"], h, cfg, cache["attn"], pos,
                                  window=_layer_window(mixer, cfg, window_override),
                                  grouped=grouped_decode)
    if cfg.parallel_block:
        return x + y + apply_ffn(p["ffn"], h, cfg, neuron_mask=_m(masks, "ffn"))
    x = x + y
    return x + _apply_ffn_or_moe(spec, p, apply_norm(p["norm2"], x, cfg), cfg, masks)[0]


def run_stack_decode(seg_params, segs, caches, x, cfg: ModelConfig, pos,
                     masks=None, mla_absorb=False, window_override=None,
                     grouped_decode=False):
    """x: (B,1,d). Returns x; the caches are updated in place.
    grouped_decode: GQA layers attend by ``attention._sdpa_grouped``."""
    for si, (seg, sp) in enumerate(zip(segs, seg_params)):
        smasks = masks[si] if masks is not None else None
        for r in range(seg.repeats):
            for i, spec in enumerate(seg.unit):
                lm = _at(smasks[f"l{i}"], r) if smasks is not None else None
                x = _apply_layer_decode(spec, _at(sp[f"l{i}"], r), x,
                                        _at(caches[si][f"l{i}"], r), cfg, pos,
                                        lm, mla_absorb, window_override, grouped_decode)
    return x


# ---------------------------------------------------------------------------
# cache specs

def _layer_cache_spec(spec, cfg: ModelConfig, batch, seq_len, window_override=None):
    _check_ported(spec, cfg)
    mixer = spec[0]
    if mixer == "rwkv":
        H, N = cfg.rwkv_heads, cfg.rwkv_head_size
        shift = TensorSpec((batch, cfg.d_model), cdtype(cfg))
        return {"rwkv": {"S": TensorSpec((batch, H, N, N), torch.float32),
                         "shift_tm": shift, "shift_cm": shift}}
    if mixer == "rglru":
        return {"rglru": rglru.state_spec(cfg, batch)}
    win = _layer_window(mixer, cfg, window_override)
    C = seq_len if win is None else min(win, seq_len)
    if cfg.use_mla:
        return {"mla": mla.cache_spec(cfg, batch, C)}
    return {"attn": attention.cache_spec(cfg, batch, C)}


def stack_cache_specs(cfg: ModelConfig, batch, seq_len, window_override=None):
    """Per segment, {'l<i>': {'attn': {'k','v': TensorSpec (R, B, C, KV, hd)}}}
    (C = min(window, seq_len) for a local_attn layer, and for every
    attention layer under window_override); for an MLA layer
    {'mla': {'c_kv': (R, B, C, lora), 'k_rope': (R, B, C, rope)}}; for an
    RG-LRU layer {'rglru': {'h': (R, B, w) fp32, 'conv': (R, B, K-1, w)}};
    for an RWKV layer {'rwkv': {'S': (R, B, H, N, N) fp32, 'shift_tm',
    'shift_cm': (R, B, d)}}."""
    out = []
    for seg in build_segments(cfg):
        unit = {}
        for i, s in enumerate(seg.unit):
            lc = _layer_cache_spec(s, cfg, batch, seq_len, window_override)
            unit[f"l{i}"] = {m: {k: type(t)((seg.repeats,) + t.shape, t.dtype)
                                 for k, t in d.items()}
                             for m, d in lc.items()}
        out.append(unit)
    return out
