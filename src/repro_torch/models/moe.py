"""Mixture-of-Experts FFN: top-k router and grouped expert matmuls (port of
``repro/models/moe.py``, its mesh-less branch).

Invariant-Dropout hooks:
  expert_mask  (E,)   -- 0 drops a whole expert (router logit -> -1e30)
  neuron_mask  (E, f) -- 0 drops an expert-hidden unit

Two forms of the expert matmuls, as in the reference. "capacity" (the
default) scatters the routed rows into per-expert buckets of
cap = ceil(T·k/E · capacity_factor) rows and runs one (E, cap, d) batched
matmul, every expert's weights read whether a row reached it or not;
"ragged" runs each expert's contiguous group of sorted rows through its
own matmuls. The reference computes both in XLA ops, not in a Pallas
kernel, and so does the port, in plain torch ops.

Two results of the reference are kept as they are (see ROADMAP.md, C):

- The capacity scatter writes a dropped row as zeros to slot cap − 1 of
  its expert, after the kept rows, so an expert that overflows loses the
  row it kept at rank cap − 1 as well. The port writes the kept rows, then
  zeros slot cap − 1 of every expert with more than cap rows.
- ``jax.lax.top_k`` puts the lower expert first among equal probabilities
  (masked experts tie at exactly 0); the port takes its top k from a stable
  descending sort, which does the same.

The weighted combine sums each token's k rows in the reference's order
(sorted by expert) one after the other, never by atomics, so two runs on
the card give the same bits.

Two settings of DeepSeek-V2's published gate, beyond the reference:
``norm_topk_prob`` False combines with each pick's softmax probability as
it is (the default divides the k by their sum), and ``seq_aux`` takes the
balance loss per sequence and then the mean over the batch.

Spans (``tracing``): ``moe.layer`` around a call, holding ``moe.route``
(its attributes the tokens, picks, capacity slots and experts),
``moe.dispatch`` (its attributes the route's outcome as the device holds
it: each expert's load, and each sorted pick's token and expert),
``moe.experts``, ``moe.combine`` and ``moe.shared``; ``moe.backward``
from the backward's arrival at the layer's output to its departure from
the input.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import GATED, apply_ffn, cdtype, dense_init, init_ffn


def init_moe(gen, cfg: ModelConfig, device, dtype, repeats=None):
    """Router (d, E), always fp32; experts' w_in, w_gate (E, d, f) and
    w_out (E, f, d) in ``dtype``; the shared experts (one FFN of
    n_shared_experts · f) and Arctic's dense residual FFN (d_ff)."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_ff
    kw = dict(dtype=dtype, device=device, repeats=repeats)
    p = {"router": dense_init(gen, d, d, E, dtype=torch.float32, device=device,
                              repeats=repeats),
         "w_in": dense_init(gen, d, E, d, f, **kw),
         "w_out": dense_init(gen, f, E, f, d, **kw)}
    if cfg.ffn_kind in GATED:
        p["w_gate"] = dense_init(gen, d, E, d, f, **kw)
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(gen, cfg, d_ff=cfg.n_shared_experts * f, **kw)
    if cfg.dense_ff_residual:
        p["dense"] = init_ffn(gen, cfg, d_ff=cfg.d_ff, **kw)
    return p


def _route(p, x2d, cfg: ModelConfig, expert_mask, seq_len=None):
    """Top-k routing of x2d (T, d), whole sequences of ``seq_len`` tokens
    (used by ``seq_aux``). Returns (order, tok, gs, w, row_e, aux): the
    (T·k) picks sorted by expert (stable), each pick's token, the picks per
    expert, each sorted pick's weight (normalised over the k unless
    ``norm_topk_prob`` is off) and expert, and the Switch-style
    load-balance loss."""
    T = x2d.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = x2d.float() @ p["router"].float()
    if expert_mask is not None:
        logits = torch.where(expert_mask[None, :] > 0, logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    # jax.lax.top_k: largest first, the lower index first among equals
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    if cfg.norm_topk_prob:
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat_e = topi.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    tok = order // k
    # picks per expert: ones added at each pick's expert (torch.bincount has
    # no meta kernel; integer adds give the same counts in any order)
    gs = torch.zeros(E, dtype=torch.int32, device=x2d.device).index_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    w = topv.reshape(T * k)[order]
    if cfg.seq_aux:
        aux = _seq_balance_loss(probs, flat_e, cfg, seq_len or T)
    else:
        frac = gs.float() / max(T * k, 1)
        aux = E * torch.sum(frac * probs.mean(dim=0))
    return order, tok, gs, w, flat_e[order], aux


def _seq_balance_loss(probs, flat_e, cfg: ModelConfig, S: int):
    """DeepSeek-V2's sequence-wise loss: for each sequence b,
    sum_i ce_b[i] · P_b[i] with ce_b[i] = b's picks of expert i · E / (S·k)
    and P_b[i] its mean router probability; the mean over sequences."""
    T, E = probs.shape
    k = cfg.top_k
    nb = T // S
    seq = torch.arange(T * k, device=probs.device) // (S * k)
    ce = torch.zeros(nb * E, dtype=torch.float32, device=probs.device).index_add_(
        0, seq * E + flat_e, torch.ones(T * k, dtype=torch.float32, device=probs.device))
    ce = ce.view(nb, E) * (E / (S * k))
    return (ce * probs.view(nb, S, E).mean(dim=1)).sum(dim=1).mean()


def _expert_act(h, g):
    if g is not None:
        return F.silu(g) * h
    return F.gelu(h, approximate="tanh")          # jax.nn.gelu's default


def capacity(T: int, cfg: ModelConfig) -> int:
    """Rows an expert's bucket holds for T tokens (the reference's cap)."""
    return max(int(math.ceil(T * cfg.top_k / cfg.n_experts
                             * cfg.moe_capacity_factor)), 1)


def rank_in_expert(gs, row_e):
    """Each sorted pick's rank within its expert's group (kept where <
    capacity)."""
    offsets = torch.cumsum(gs, 0) - gs                         # (E,)
    return torch.arange(row_e.numel(), device=row_e.device) - offsets[row_e]


def token_chunk(T: int, cfg: ModelConfig) -> int:
    """Tokens a chunk of ``_moe_local`` takes: T up to moe_token_chunk,
    else moe_token_chunk halved until it divides T."""
    ck = cfg.moe_token_chunk
    if T <= ck:
        return T
    while T % ck:
        ck //= 2
    return ck


def _combine(out, w, order, T, k, dt):
    """y (T, d): each token's k weighted rows summed in sorted order (by
    expert), as the reference's scatter-add visits them, one add at a time
    in ``dt``."""
    contrib = out * w[:, None].to(dt)                          # (T·k, d) sorted
    at = torch.empty_like(order)
    at[order] = torch.arange(order.numel(), device=order.device)
    rows = torch.sort(at.view(T, k), dim=1).values             # sorted positions
    y = contrib[rows[:, 0]]
    for j in range(1, k):
        y = y + contrib[rows[:, j]]
    return y


def _expert_matmul(buckets, wi, wg, wo, nm, dt):
    """(E', cap, d) buckets through E' experts: (E', cap, d)."""
    h = torch.bmm(buckets, wi.to(dt))
    g = torch.bmm(buckets, wg.to(dt)) if wg is not None else None
    h = _expert_act(h, g)
    if nm is not None:
        h = h * nm[:, None, :].to(dt)
    return torch.bmm(h, wo.to(dt))


def _moe_tokens(p, x2d, cfg: ModelConfig, neuron_mask, expert_mask, seq_len=None):
    """The routed experts over flat tokens x2d (T, d), whole sequences of
    ``seq_len``. Returns (y, aux)."""
    dt = cdtype(cfg)
    T, d = x2d.shape
    E, k = cfg.n_experts, cfg.top_k
    ragged = cfg.moe_impl == "ragged"
    cap = None if ragged else capacity(T, cfg)
    with tracing.span("moe.route", tokens=T, picks=T * k, slots=None if ragged else E * cap,
                      experts=E):
        order, tok, gs, w, row_e, aux = _route(p, x2d, cfg, expert_mask, seq_len)
    routed = dict(load=gs, token_of=tok, expert_of=row_e)

    if ragged:
        with tracing.span("moe.dispatch", **routed):
            xs = x2d[tok]                                      # (T·k, d)
        with tracing.span("moe.experts"):
            out = torch.empty((T * k, d), dtype=dt, device=x2d.device)
            start = 0
            for e, n in enumerate(gs.tolist()):
                if n:
                    rows = xs[start:start + n]
                    g = rows @ p["w_gate"][e].to(dt) if "w_gate" in p else None
                    h = _expert_act(rows @ p["w_in"][e].to(dt), g)
                    if neuron_mask is not None:
                        h = h * neuron_mask[e].to(dt)
                    out[start:start + n] = h @ p["w_out"][e].to(dt)
                start += n
        with tracing.span("moe.combine"):
            return _combine(out, w, order, T, k, dt), aux

    with tracing.span("moe.dispatch", **routed):
        xs = x2d[tok]                                          # (T·k, d)
        rank = rank_in_expert(gs, row_e)
        keep = rank < cap
        # kept rows to their (expert, rank) slot, each slot written once;
        # dropped rows to one spare row past the buckets, thrown away (no
        # boolean indexing: its host sync would stall every decode layer)
        dst = torch.where(keep, row_e * cap + rank, torch.full_like(rank, E * cap))
        flat = torch.zeros((E * cap + 1, d), dtype=dt, device=x2d.device)
        flat[dst] = xs.to(dt)
        buckets = flat[:E * cap].view(E, cap, d)
        # the reference writes each dropped row's zeros to slot cap - 1 after
        # the kept rows: an overflowing expert's slot cap - 1 ends up 0
        buckets[:, cap - 1].masked_fill_((gs > cap)[:, None], 0)

    with tracing.span("moe.experts"):
        wg = p.get("w_gate")
        ec = cfg.moe_expert_chunk
        if ec and E > ec and E % ec == 0:
            # expert chunks bound the working set to ec experts at a time
            parts = []
            for s in range(0, E, ec):
                sl = slice(s, s + ec)
                parts.append(_expert_matmul(
                    buckets[sl], p["w_in"][sl], wg[sl] if wg is not None else None,
                    p["w_out"][sl], neuron_mask[sl] if neuron_mask is not None else None,
                    dt))
            out_b = torch.cat(parts)
        else:
            out_b = _expert_matmul(buckets, p["w_in"], wg, p["w_out"], neuron_mask, dt)
    with tracing.span("moe.combine"):
        out = out_b[row_e, torch.clamp(rank, 0, cap - 1)]      # (T·k, d)
        out = torch.where(keep[:, None], out, torch.zeros_like(out))
        return _combine(out, w, order, T, k, dt), aux


def _moe_local(p, x, neuron_mask, expert_mask, cfg: ModelConfig):
    """x (B, S, d): the routed experts over token chunks of at most
    moe_token_chunk (halved until it divides T; capacity per chunk, aux the
    mean over chunks), then the shared and dense FFNs added. With
    ``seq_aux`` a chunk holds whole sequences."""
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    ck = token_chunk(T, cfg)
    if cfg.seq_aux and ck % S:
        raise NotImplementedError(
            f"seq_aux takes whole sequences in a token chunk: {S} tokens a "
            f"sequence, chunks of {ck} (moe_token_chunk {cfg.moe_token_chunk})")
    if ck == T:
        y, aux = _moe_tokens(p, x2d, cfg, neuron_mask, expert_mask, S)
    else:
        ys, auxs = zip(*(_moe_tokens(p, x2d[i:i + ck], cfg, neuron_mask, expert_mask, S)
                         for i in range(0, T, ck)))
        y, aux = torch.cat(ys), torch.stack(auxs).mean()
    y = y.reshape(B, S, d)
    with tracing.span("moe.shared"):
        if "shared" in p:
            y = y + apply_ffn(p["shared"], x, cfg)
        if "dense" in p:
            y = y + apply_ffn(p["dense"], x, cfg)
    return y, aux


def apply_moe(p, x, cfg: ModelConfig, neuron_mask=None, expert_mask=None):
    """x: (B,S,d). Returns (y, aux_loss). The reference's mesh branch
    (shard_map over experts' hidden units, weight streaming) is not ported
    (ROADMAP.md, A.5). On the meta device (the dry-run) only the capacity
    form runs: the ragged form's host loop reads the group sizes' values,
    which a meta tensor has not; the dry-run takes moe_impl="capacity", as
    the reference's jitted dry-run does."""
    mark_input, mark_output = tracing.backward_marks("moe.backward")
    with tracing.span("moe.layer"):
        y, aux = _moe_local(p, mark_input(x), neuron_mask, expert_mask, cfg)
        return mark_output(y), aux
