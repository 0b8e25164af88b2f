"""RG-LRU recurrent block, Griffin / RecurrentGemma (port of
``repro/models/rglru.py``).

Block: x -> [W_x -> causal depthwise conv1d -> RG-LRU] ⊙ gelu(W_gate x) -> W_out.
RG-LRU:
  r_t = sigmoid(w_a ⊙ x_t + b_a)        (recurrence gate, per channel)
  i_t = sigmoid(w_i ⊙ x_t + b_i)        (input gate)
  a_t = exp(-c * softplus(lam) * r_t)   (c = 8)
  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t)

Prefill evaluates the linear recurrence in fp32 with a log-depth scan
(``_linear_scan``, the combine of the reference's ``associative_scan``
applied by doubling strides); decode is the one-step recurrence. The
reference has no Pallas kernel here: every op is plain torch. Decode
updates the state in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import TensorSpec, cdtype, dense_init, pdtype

C_FACTOR = 8.0


def init_rglru(gen, cfg: ModelConfig, device, dtype, repeats=None):
    """Matrices (w_x, w_gate, w_out and the (K, w) conv_w) in ``dtype``;
    the gate vectors, a_param and biases in cfg.param_dtype."""
    d, w = cfg.d_model, cfg.lru_dim
    kw = dict(dtype=dtype, device=device, repeats=repeats)
    lead = (repeats,) if repeats else ()
    pd = pdtype(cfg)
    zeros = lambda: torch.zeros(*lead, w, dtype=pd, device=device)
    # fan-in 100 draws 0.1 * N(0, 1), the reference's scale for these
    small = lambda *shape, dt: dense_init(gen, 100, *shape, dtype=dt,
                                          device=device, repeats=repeats)
    return {
        "w_x": dense_init(gen, d, d, w, **kw),
        "w_gate": dense_init(gen, d, d, w, **kw),
        "w_out": dense_init(gen, w, w, d, **kw),
        "conv_w": small(cfg.conv1d_width, w, dt=dtype),
        "conv_b": zeros(),
        "a_param": torch.linspace(0.9, 4.0, w, dtype=pd, device=device)
                        .expand(*lead, w).clone(),        # softplus argument
        "w_a": small(w, dt=pd),
        "b_a": zeros(),
        "w_i": small(w, dt=pd),
        "b_i": zeros(),
    }


def _conv1d_seq(p, u, conv_state, cfg: ModelConfig):
    """Causal depthwise conv. u: (B,S,w); conv_state: (B, K-1, w) history.
    Returns (out (B,S,w), the new history (B, K-1, w))."""
    K = cfg.conv1d_width
    dt = u.dtype
    hist = torch.cat([conv_state.to(dt), u], dim=1)       # (B, S+K-1, w)
    S = u.shape[1]
    out = torch.zeros_like(u)
    for j in range(K):
        out = out + hist[:, j:j + S] * p["conv_w"][K - 1 - j].to(dt)
    out = out + p["conv_b"].to(dt)
    return out, hist[:, -(K - 1):]


def _gates(p, u):
    """Per-channel decay a and input term b of the recurrence, fp32."""
    uf = u.float()
    r = torch.sigmoid(uf * p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(uf * p["w_i"].float() + p["b_i"].float())
    log_a = -C_FACTOR * F.softplus(p["a_param"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    return a, b


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by doubling
    strides: after the step of stride k every position holds the
    composition of the (up to 2k) steps ending at it. a, b: (B,S,w) fp32."""
    S = a.shape[1]
    k = 1
    while k < S:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def _gelu(x):
    return F.gelu(x, approximate="tanh")          # jax.nn.gelu's default


def rglru_seq(p, x, cfg: ModelConfig, state_in=None, conv_in=None):
    """x: (B,S,d). Returns (y, {'h': (B,w) fp32, 'conv': (B,K-1,w)})."""
    B = x.shape[0]
    w = cfg.lru_dim
    dt = cdtype(cfg)
    if state_in is None:
        state_in = torch.zeros((B, w), dtype=torch.float32, device=x.device)
    if conv_in is None:
        conv_in = torch.zeros((B, cfg.conv1d_width - 1, w), dtype=dt,
                              device=x.device)
    u = x @ p["w_x"].to(dt)
    u, conv_out = _conv1d_seq(p, u, conv_in, cfg)
    a, b = _gates(p, u)
    # the carried state enters as the first step's a_0 h_in (the
    # reference's pseudo-step (1, h_in) composed with (a_0, b_0))
    b = torch.cat([a[:, :1] * state_in[:, None] + b[:, :1], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)                                 # (B,S,w)
    gate = _gelu(x @ p["w_gate"].to(dt))
    y = (h.to(dt) * gate) @ p["w_out"].to(dt)
    return y, {"h": h[:, -1], "conv": conv_out}


def rglru_decode(p, x1, cfg: ModelConfig, state):
    """x1: (B,1,d); state: {'h': (B,w) fp32, 'conv': (B,K-1,w)}, updated
    IN PLACE. Returns y (B,1,d)."""
    dt = cdtype(cfg)
    u = x1 @ p["w_x"].to(dt)
    hist = torch.cat([state["conv"].to(dt), u], dim=1)    # (B,K,w)
    # the seq path's conv_w[0] multiplies the newest step: flip for the history
    conv = torch.einsum("bkw,kw->bw", hist, p["conv_w"].flip(0).to(dt))[:, None]
    conv = conv + p["conv_b"].to(dt)
    a, b = _gates(p, conv)
    h = a[:, 0] * state["h"] + b[:, 0]
    gate = _gelu(x1 @ p["w_gate"].to(dt))
    y = (h[:, None].to(dt) * gate) @ p["w_out"].to(dt)
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:])
    return y


def state_spec(cfg: ModelConfig, batch: int):
    return {"h": TensorSpec((batch, cfg.lru_dim), torch.float32),
            "conv": TensorSpec((batch, cfg.conv1d_width - 1, cfg.lru_dim),
                               cdtype(cfg))}
