"""Shared layer primitives: norms, RoPE, embeddings, FFN (port of
``repro/models/layers.py``).

Params are plain dicts of tensors with the reference's keys. Weights are
cast to the compute dtype at use (``.to`` is a no-op when
``init_params(dtype=...)`` already stored them in it).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor not yet allocated (jax.ShapeDtypeStruct)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# init helpers

DRAW_CHUNK = 1 << 30           # elements of one fp32 draw at most: 4 GiB

def dense_init(gen: torch.Generator, fan_in, *shape, dtype, device,
               repeats=None):
    """normal * 1/sqrt(fan_in), drawn in fp32 and cast to ``dtype``. With
    ``repeats`` the result is stacked (repeats, *shape) and drawn one repeat
    at a time, so the fp32 draw never holds more than one layer's matrix;
    a matrix of more than DRAW_CHUNK elements (Command-R-35B's 256000-row
    vocab tables) is drawn DRAW_CHUNK elements of leading rows at a time.
    On the meta device nothing is drawn (``param_specs``)."""
    scale = 1.0 / math.sqrt(fan_in)
    lead = (repeats,) if repeats else ()
    out = torch.empty(lead + shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    for sub in (out if repeats else [out]):
        rows = sub.shape[0] if sub.numel() <= DRAW_CHUNK else max(
            1, DRAW_CHUNK // (sub.numel() // sub.shape[0]))
        for part in sub.split(rows):
            part.copy_(torch.randn(part.shape, generator=gen, device=device).mul_(scale))
    return out


# ---------------------------------------------------------------------------
# norms

def init_norm(cfg: ModelConfig, device, dim=None, repeats=None):
    dim = dim or cfg.d_model
    lead = (repeats,) if repeats else ()
    p = {"scale": torch.ones(*lead, dim, dtype=pdtype(cfg), device=device)}
    if cfg.norm_kind == "layernorm":
        p["bias"] = torch.zeros(*lead, dim, dtype=pdtype(cfg), device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig, eps=1e-6):
    """RMSNorm / LayerNorm computed in fp32, returned in x.dtype."""
    xf = x.float()
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE

def rope_freqs(dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))


def yarn_mscale(scale: float, m: float = 1.0) -> float:
    """YaRN's magnitude factor 0.1 · m · ln(scale) + 1 (1 at scale <= 1)."""
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn_freqs(dim: int, theta: float, yarn: dict):
    """DeepSeek-V2's YaRN frequencies of a ``dim``-wide rotary slice: the
    interpolated frequencies (over ``factor``) below the correction range,
    the original ones above it, and a linear ramp between, the range from
    ``beta_fast`` and ``beta_slow`` rotations at the original length."""
    s, L0 = yarn["factor"], yarn["original_max_position_embeddings"]
    extra = rope_freqs(dim, theta)
    inter = extra / np.float32(s)

    def corr(rotations):
        return dim * math.log(L0 / (rotations * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(corr(yarn["beta_fast"])), 0)
    high = min(math.ceil(corr(yarn["beta_slow"])), dim - 1)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - low)
                   / np.float32(max(high - low, 1e-3)), 0, 1)
    return (inter * ramp + extra * (1 - ramp)).astype(np.float32)


def yarn_cos_scale(yarn: dict) -> float:
    """The factor on YaRN's cos and sin: mscale(s, mscale) over
    mscale(s, mscale_all_dim)."""
    s = yarn["factor"]
    return (yarn_mscale(s, yarn.get("mscale", 1.0))
            / yarn_mscale(s, yarn.get("mscale_all_dim", 0.0)))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(dim: int, theta: float, device: torch.device, scaling=None):
    # cached per device: a host-to-device copy per call would block the
    # host until the card's queue drains, every layer of every decode step
    f = rope_freqs(dim, theta) if scaling is None else yarn_freqs(dim, theta, dict(scaling))
    return torch.from_numpy(f).to(device)


def apply_rope(x, positions, theta: float, has_heads: bool = True, scaling=None):
    """Split-halves RoPE. x: (..., S, H, hd) if has_heads else (..., S, hd);
    positions: (..., S). ``scaling``: a config's ``rope_scaling`` (YaRN's
    frequencies, and its factor on cos and sin where that is not 1), or
    None."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device, scaling)
    ang = positions[..., None].float() * freqs          # (..., S, hd/2)
    if has_heads:
        ang = ang[..., None, :]                          # heads axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None:
        k = yarn_cos_scale(dict(scaling))
        if k != 1.0:
            cos, sin = cos * k, sin * k
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings

def init_embed(gen, cfg: ModelConfig, device, dtype):
    v = cfg.padded_vocab
    p = {"embed": dense_init(gen, cfg.d_model, v, cfg.d_model, dtype=dtype,
                             device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.d_model, v,
                                  dtype=dtype, device=device)
    return p


def embed_tokens(p, tokens, cfg: ModelConfig):
    # gather, then cast: the same numbers as casting the table first
    return p["embed"][tokens.long()].to(cdtype(cfg))


def lm_logits(p, x, cfg: ModelConfig):
    w = p.get("lm_head")
    if w is None:
        w = p["embed"].T
    logits = x @ w.to(cdtype(cfg))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# FFN

GATED = {"swiglu", "gelu_gated"}


def init_ffn(gen, cfg: ModelConfig, device, dtype, repeats=None, d_ff=None):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    kw = dict(dtype=dtype, device=device, repeats=repeats)
    p = {"w_in": dense_init(gen, d, d, f, **kw),
         "w_out": dense_init(gen, f, f, d, **kw)}
    if cfg.ffn_kind in GATED:
        p["w_gate"] = dense_init(gen, d, d, f, **kw)
    if cfg.use_bias:
        lead = (repeats,) if repeats else ()
        zeros = lambda n: torch.zeros(*lead, n, dtype=pdtype(cfg), device=device)
        p["b_in"], p["b_out"] = zeros(f), zeros(d)
        if cfg.ffn_kind in GATED:
            p["b_gate"] = zeros(f)
    return p


def _act(h, kind):
    if kind == "swiglu":
        return F.silu(h)
    if kind in ("gelu", "gelu_gated"):
        return F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    if kind == "relu":
        return torch.relu(h)
    if kind == "relu2":
        return torch.square(torch.relu(h))
    raise ValueError(kind)


_KERNEL_ACT = {"swiglu": ("silu", True), "gelu_gated": ("gelu", True),
               "gelu": ("gelu", False), "relu": ("relu", False),
               "relu2": ("relu2", False)}


def _ffn_kernel_ok(p, x, cfg, neuron_mask) -> bool:
    """masked_ffn_batch applies on the single-token decode shape:
    per-request masks, no biases, 128-aligned hidden dim."""
    return (x.ndim == 3 and x.shape[1] == 1
            and neuron_mask is not None and neuron_mask.ndim == 3
            and "b_in" not in p
            and p["w_in"].shape[1] % ops.BLOCK_NEURONS == 0
            and cfg.ffn_kind in _KERNEL_ACT)


def _ffn_train_kernel_ok(p, x, cfg, neuron_mask) -> bool:
    """The differentiable masked kernels apply on the (B, S, d) train shape
    with one shared (f,) layer mask, no biases, 128-aligned hidden dim."""
    return (x.ndim == 3 and neuron_mask is not None and neuron_mask.ndim == 1
            and "b_in" not in p
            and p["w_in"].shape[1] % ops.BLOCK_NEURONS == 0
            and cfg.ffn_kind in _KERNEL_ACT)


def apply_ffn(p, x, cfg: ModelConfig, neuron_mask=None, kernels=False):
    """FFN with an optional 0/1 neuron mask (the invariant-dropout
    sub-model): (f,) for one mask, (B, 1, f) per request at decode, where
    the masked FFN kernel runs. With ``kernels`` (the train step's
    ``use_kernels``) an (f,) mask on the (B, S, d) train shape goes through
    the training kernels (forward, dx and dW skip dropped 128-blocks) at
    C = 1, M = B·S."""
    dt = cdtype(cfg)
    if kernels and _ffn_train_kernel_ok(p, x, cfg, neuron_mask):
        act, gated = _KERNEL_ACT[cfg.ffn_kind]
        B, S, d = x.shape
        f = p["w_in"].shape[1]
        # every row carries the layer mask, as the reference broadcasts it;
        # the dW comes back in dt and autograd carries it through the cast
        rm = neuron_mask.to(x.device, torch.float32).expand(1, B * S, f).contiguous()
        one = lambda w: w.to(dt)[None]
        y = ops.masked_ffn_train(
            x.reshape(1, B * S, d).to(dt).contiguous(), one(p["w_in"]),
            one(p["w_out"]), rm, w_gate=one(p["w_gate"]) if gated else None,
            act=act)
        return y.reshape(B, S, d)
    if _ffn_kernel_ok(p, x, cfg, neuron_mask):
        act, gated = _KERNEL_ACT[cfg.ffn_kind]
        B, _, d = x.shape
        y = ops.masked_ffn_batch(
            x.reshape(B, d).to(dt), p["w_in"].to(dt), p["w_out"].to(dt),
            neuron_mask.reshape(B, -1),
            w_gate=p["w_gate"].to(dt) if gated else None, act=act)
        return y.reshape(B, 1, d)
    h = x @ p["w_in"].to(dt)
    if "b_in" in p:
        h = h + p["b_in"].to(dt)
    if cfg.ffn_kind in GATED:
        g = x @ p["w_gate"].to(dt)
        if "b_gate" in p:
            g = g + p["b_gate"].to(dt)
        h = _act(g, cfg.ffn_kind) * h
    else:
        h = _act(h, cfg.ffn_kind)
    if neuron_mask is not None:
        h = h * neuron_mask.to(dt)
    out = h @ p["w_out"].to(dt)
    if "b_out" in p:
        out = out + p["b_out"].to(dt)
    return out


# ---------------------------------------------------------------------------
# losses

def softmax_xent(logits, targets, mask=None):
    """Mean next-token NLL in fp32 over the padded vocabulary; with a
    ``loss_mask`` the masked mean sum(nll·mask) / max(sum(mask), 1)."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - lf.gather(-1, targets[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
