"""RWKV-6 "Finch" time mix and channel mix (port of ``repro/models/rwkv6.py``).

Recurrence per head (key/value dim N):
  S_t = diag(w_t) S_{t-1} + k_t v_t^T
  y_t = r_t^T S_{t-1} + (r_t . (u ⊙ k_t)) v_t

``tmix_seq`` (prefill) runs the chunked form through
``ops.rwkv_chunk_scan``: on the card the hand-written chunked WKV kernel,
where the reference scans the same chunk math in jnp. Differentiated
(training), it runs the plain chunked form, ``rwkv_chunk_scan_plain``,
under autograd on any device: the kernel has no backward, and the
reference differentiates its jnp scan. cfg.rwkv_chunk_dtype "bfloat16"
takes the bf16 chunk form, ``ops.rwkv_chunk_scan_bf16``. ``tmix_ref`` is the
naive per-token recurrence (the oracle); ``tmix_decode`` advances one token.
The channel mix is plain torch, as the reference computes it outside any
Pallas kernel. The decay LoRA's second product and the log decay stay
fp32, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv_chunk import rwkv_chunk_scan_plain
from repro_torch.models.layers import cdtype, dense_init, pdtype

LORA_MIX = 32
LORA_DECAY = 64
MIX_KEYS = ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g")


def _stack(make, repeats):
    """make() -> tensor, stacked (repeats, ...) when repeats is given."""
    return torch.stack([make() for _ in range(repeats)]) if repeats else make()


def init_tmix(gen, cfg: ModelConfig, device, dtype, repeats=None):
    """The reference's keys and init scales; matrices in ``dtype``, vectors
    in cfg.param_dtype."""
    d = cfg.d_model
    pd = pdtype(cfg)
    lead = (repeats,) if repeats else ()
    kw = dict(dtype=dtype, device=device, repeats=repeats)

    def small(*shape):               # 1e-3 * normal, drawn in fp32
        return _stack(lambda: 1e-3 * torch.randn(shape, generator=gen, device=device),
                      repeats).to(dtype)
    p = {k: torch.full(lead + (d,), 0.5, dtype=pd, device=device)
         for k in ("mix_x",) + MIX_KEYS}
    p.update({
        "lora_mix_a": dense_init(gen, d, d, 5 * LORA_MIX, **kw),
        "lora_mix_b": small(5, LORA_MIX, d),
        "w_decay": torch.linspace(-6.0, -1.0, d, dtype=pd, device=device).expand(
            lead + (d,)).clone(),
        "lora_w_a": dense_init(gen, d, d, LORA_DECAY, **kw),
        "lora_w_b": small(LORA_DECAY, d),
        "w_u": _stack(lambda: 0.1 * torch.randn(d, generator=gen, device=device),
                      repeats).to(pd),
        **{k: dense_init(gen, d, d, d, **kw)
           for k in ("w_r", "w_k", "w_v", "w_g", "w_o")},
        "ln_scale": torch.ones(lead + (d,), dtype=pd, device=device),
        "ln_bias": torch.zeros(lead + (d,), dtype=pd, device=device)})
    return p


def init_cmix(gen, cfg: ModelConfig, device, dtype, repeats=None):
    d, f = cfg.d_model, cfg.d_ff
    lead = (repeats,) if repeats else ()
    kw = dict(dtype=dtype, device=device, repeats=repeats)
    return {"mix_k": torch.full(lead + (d,), 0.5, dtype=pdtype(cfg), device=device),
            "mix_r": torch.full(lead + (d,), 0.5, dtype=pdtype(cfg), device=device),
            "w_in": dense_init(gen, d, d, f, **kw),
            "w_out": dense_init(gen, f, f, d, **kw),
            "w_r": dense_init(gen, d, d, d, **kw)}


# ---------------------------------------------------------------------------


def _ddlerp(p, x, x_prev, cfg):
    """Data-dependent token-shift mixing -> (xr, xk, xv, xw, xg)."""
    dt = cdtype(cfg)
    xx = x_prev - x
    sx = x + xx * p["mix_x"].to(dt)
    z = torch.tanh(sx @ p["lora_mix_a"].to(dt))
    z = z.reshape(*z.shape[:-1], 5, LORA_MIX)
    delta = torch.einsum("...fr,frd->...fd", z, p["lora_mix_b"].to(dt))
    return [x + xx * (p[nm].to(dt) + delta[..., i, :])
            for i, nm in enumerate(MIX_KEYS)]


def _rkvwg(p, x, x_prev, cfg):
    dt = cdtype(cfg)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev, cfg)
    r = xr @ p["w_r"].to(dt)
    k = xk @ p["w_k"].to(dt)
    v = xv @ p["w_v"].to(dt)
    g = xg @ p["w_g"].to(dt)
    ww = (p["w_decay"].float()
          + torch.tanh(xw @ p["lora_w_a"].to(dt)).float() @ p["lora_w_b"].float())
    logw = -torch.exp(ww)                                 # log decay, < 0
    return r, k, v, g, logw


def _heads(x, H, N):
    return x.reshape(*x.shape[:-1], H, N)


def _group_norm(p, y, H, N, eps=1e-5):
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yn = (yf - mu) * torch.rsqrt(var + eps)
    yn = yn.reshape(*y.shape[:-2], H * N)
    return yn * p["ln_scale"].float() + p["ln_bias"].float()


def _out(p, y, g, cfg):
    """Group norm, the silu(g) gate and the output projection."""
    dt = cdtype(cfg)
    H, N = cfg.rwkv_heads, cfg.rwkv_head_size
    y = _group_norm(p, y, H, N).to(dt)
    return (y * F.silu(g)) @ p["w_o"].to(dt)


def _shifted(x, shift_in, dt):
    """x_prev: the previous token of each position; shift_in before the first."""
    B, _, d = x.shape
    if shift_in is None:
        shift_in = torch.zeros((B, d), dtype=dt, device=x.device)
    return torch.cat([shift_in[:, None].to(x.dtype), x[:, :-1]], dim=1)


def tmix_seq(p, x, cfg: ModelConfig, shift_in=None, state_in=None):
    """x: (B,S,d). Returns (y, last_x, state_out). The chunk loop runs in
    ``ops.rwkv_chunk_scan`` from ``state_in`` (zero when None), or in
    ``ops.rwkv_chunk_scan_bf16`` when cfg.rwkv_chunk_dtype is "bfloat16";
    differentiated, in ``rwkv_chunk_scan_plain`` under autograd."""
    if cfg.rwkv_chunk_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"rwkv_chunk_dtype must be float32 or bfloat16, "
                         f"got {cfg.rwkv_chunk_dtype!r}")
    bf16 = cfg.rwkv_chunk_dtype == "bfloat16"
    B, S, d = x.shape
    H, N = cfg.rwkv_heads, cfg.rwkv_head_size
    r, k, v, g, logw = _rkvwg(p, x, _shifted(x, shift_in, cdtype(cfg)), cfg)
    u = _heads(p["w_u"].float(), H, N)
    c = min(cfg.rwkv_chunk, S)
    while S % c:
        c -= 1
    args = (_heads(r, H, N), _heads(k, H, N), _heads(v, H, N), _heads(logw, H, N), u)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (*args, state_in)):
        y, state_out = rwkv_chunk_scan_plain(
            *args, chunk=c, state=state_in,
            chunk_dtype=torch.bfloat16 if bf16 else torch.float32)
    else:
        scan = ops.rwkv_chunk_scan_bf16 if bf16 else ops.rwkv_chunk_scan
        y, state_out = scan(*args, chunk=c, state=state_in)
    return _out(p, y, g, cfg), x[:, -1], state_out


def tmix_ref(p, x, cfg: ModelConfig, shift_in=None, state_in=None):
    """Naive per-token recurrence: the oracle for the chunked path."""
    B, S, d = x.shape
    H, N = cfg.rwkv_heads, cfg.rwkv_head_size
    r, k, v, g, logw = _rkvwg(p, x, _shifted(x, shift_in, cdtype(cfg)), cfg)
    u = _heads(p["w_u"].float(), H, N)
    rs, ks, vs = (_heads(t, H, N).float() for t in (r, k, v))
    ws = torch.exp(_heads(logw, H, N))
    state = (torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
             if state_in is None else state_in.float())
    ys = []
    for t in range(S):
        rt, kt, vt = rs[:, t], ks[:, t], vs[:, t]
        ys.append(torch.einsum("bhn,bhnm->bhm", rt, state)
                  + torch.einsum("bhn,bhn->bh", rt, u[None] * kt)[..., None] * vt)
        state = ws[:, t, ..., None] * state + kt[..., None] * vt[..., None, :]
    return _out(p, torch.stack(ys, dim=1), g, cfg), x[:, -1], state


def tmix_decode(p, x1, cfg: ModelConfig, shift_in, state_in):
    """x1: (B,1,d); one token of the recurrence. Returns (y, last_x, S1)."""
    H, N = cfg.rwkv_heads, cfg.rwkv_head_size
    r, k, v, g, logw = _rkvwg(p, x1, shift_in[:, None].to(x1.dtype), cfg)
    u = _heads(p["w_u"].float(), H, N)
    rt, kt, vt = (_heads(t[:, 0], H, N).float() for t in (r, k, v))
    wt = torch.exp(_heads(logw[:, 0], H, N))
    y = (torch.einsum("bhn,bhnm->bhm", rt, state_in)
         + torch.einsum("bhn,bhn->bh", rt, u[None] * kt)[..., None] * vt)
    S1 = wt[..., None] * state_in + kt[..., None] * vt[..., None, :]
    return _out(p, y[:, None], g, cfg), x1[:, -1], S1


# ---------------------------------------------------------------------------


def cmix_seq(p, x, cfg: ModelConfig, shift_in=None, neuron_mask=None):
    """Squared-ReLU channel mix with a receptance gate; ``neuron_mask``
    (a 0/1 (.., d_ff) keep-mask) drops hidden units. Returns (y, last_x)."""
    dt = cdtype(cfg)
    xx = _shifted(x, shift_in, dt) - x
    xk = x + xx * p["mix_k"].to(dt)
    xr = x + xx * p["mix_r"].to(dt)
    h = torch.square(torch.relu(xk @ p["w_in"].to(dt)))
    if neuron_mask is not None:
        h = h * neuron_mask.to(dt)
    kv = h @ p["w_out"].to(dt)
    return torch.sigmoid(xr @ p["w_r"].to(dt)) * kv, x[:, -1]


def cmix_decode(p, x1, cfg: ModelConfig, shift_in, neuron_mask=None):
    return cmix_seq(p, x1, cfg, shift_in=shift_in, neuron_mask=neuron_mask)
