"""Plain PyTorch decoder: the reference for both configurations.

A decoder-only transformer as the configuration file states it: token
embedding; per layer a norm (RMSNorm, or LayerNorm with bias), grouped-query
attention with split-halves RoPE and a causal mask, and a gated (SwiGLU)
FFN whose hidden units a 0/1 mask selects; sequential blocks (x + attn,
then x + ffn, each from its own norm) or parallel blocks (x + attn(h) +
ffn(h) from one norm); a final norm and an untied output head. Float32
throughout, with TF32 off, no kernels, no cache and no batching tricks.

``precision="fp8"`` is the control: every matmul operand (and every
gradient of one) rounded to float8 (e4m3 forward, e5m2 backward, one scale
a tensor), products summed in float32; ``"fp8_ffn"`` rounds the FFN's
matmuls alone.

Imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math

import torch

NEG = -1e30


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matmuls and convolutions while the reference runs."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def _round8(x, dtype):
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2)


def operand(x, precision):
    """A matmul operand as the precision takes it."""
    return _Fp8.apply(x) if precision == "fp8" else x


def mm(a, b, precision="fp32"):
    return operand(a, precision) @ operand(b, precision)


def norm(p, x, c):
    eps = c["layer_norm_eps"]
    if c["norm_kind"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * p["scale"].float()


def rope(x, positions, theta):
    """Split-halves rotary embedding of x (B, S, heads, hd) at positions (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions.float()[:, None] * freqs              # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, h, c, precision="fp32"):
    B, S, d = h.shape
    H, KV, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    w = lambda name: p[name].float().reshape(d, -1)
    q = mm(h, w("wq"), precision).reshape(B, S, H, hd)
    k = mm(h, w("wk"), precision).reshape(B, S, KV, hd)
    v = mm(h, w("wv"), precision).reshape(B, S, KV, hd)
    pos = torch.arange(S, device=h.device)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bqhk,bthk->bhqt", operand(q, precision),
                          operand(k, precision)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = torch.where(causal, scores, torch.full_like(scores, NEG))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqt,bthk->bqhk", operand(probs, precision), operand(v, precision))
    return mm(o.reshape(B, S, H * hd), p["wo"].float().reshape(H * hd, d), precision)


def ffn(p, h, c, keep, precision="fp32"):
    """keep: a bool (F,) mask, or (B, F) one a sequence; None keeps every unit."""
    precision = "fp8" if precision == "fp8_ffn" else precision
    up = mm(h, p["w_in"].float(), precision)
    if "w_gate" in p:
        up = torch.nn.functional.silu(mm(h, p["w_gate"].float(), precision)) * up
    else:
        up = torch.nn.functional.silu(up)
    if keep is not None:
        keep = keep if keep.ndim == 1 else keep[:, None, :]
        up = torch.where(keep, up, torch.zeros_like(up))
    return mm(up, p["w_out"].float(), precision)


def block(p, x, c, keep, precision="fp32"):
    h = norm(p["norm1"], x, c)
    if c["parallel_block"]:
        return x + attention(p["attn"], h, c, precision) + ffn(p["ffn"], h, c, keep, precision)
    x = x + attention(p["attn"], h, c, precision)
    return x + ffn(p["ffn"], norm(p["norm2"], x, c), c, keep, precision)


def hidden(params, tokens, c, keeps=None, precision="fp32", layer_params=None):
    """The final-normed hidden states (B, S, d) of tokens (B, S). keeps: per
    layer a keep mask for ffn (or None). layer_params(r) gives layer r's
    params where the stacked tree is not held whole."""
    x = params["tok"]["embed"].float()[tokens.long()]
    for r in range(c["num_hidden_layers"]):
        p = layer_params(r) if layer_params else _layer(params, r)
        x = block(p, x, c, None if keeps is None else keeps[r], precision)
    return norm(params["final_norm"], x, c)


def logits(params, x, c, precision="fp32"):
    return mm(x, params["tok"]["lm_head"].float(), precision)


def loss(params, batch, c, keeps=None, precision="fp32"):
    """Mean next-token cross-entropy over every position."""
    lg = logits(params, hidden(params, batch["tokens"], c, keeps, precision), c, precision)
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, batch["targets"].long()[..., None])[..., 0]
    return nll.mean()


def _layer(params, r):
    """Layer r of the stacked (R, ...) layer tree."""
    def at(t):
        return {k: at(v) for k, v in t.items()} if isinstance(t, dict) else t[r]
    return at(params["stack"]["seg0"]["l0"])
