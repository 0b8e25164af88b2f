"""Public wrappers around the port's kernels (mirror of ``repro/kernels/ops.py``).

Each wrapper launches its hand-written CUDA kernel when given CUDA tensors
and runs the kernel's plain PyTorch version when given CPU tensors (meta
tensors, the dry-run's: the launch's checks, then the plain version): the
masked FFN (serving, training and block-masked forms), the head-masked attention
projections, ``decode_gqa``, the chunked RWKV-6 scan and
``invariant_stats`` (an entry point that no main path calls, as in the
reference). Models call the kernels through this module, so a caller can
swap a wrapper for its plain version (chip_smoke.py does, to compare).
"""
from __future__ import annotations

import numpy as np

from repro_torch.kernels import decode_gqa as _decode_gqa_mod
from repro_torch.kernels import invariant_stats as _invariant_stats_mod
from repro_torch.kernels import masked_attn as _masked_attn_mod
from repro_torch.kernels import masked_ffn as _masked_ffn_mod
from repro_torch.kernels import rwkv_chunk as _rwkv_chunk_mod

BLOCK_NEURONS = 128

# launch counters of the kernels, by public name
LAUNCHES = {"masked_ffn_batch": _masked_ffn_mod.launches,
            "decode_gqa": _decode_gqa_mod.launches,
            "masked_ffn_train_fwd": _masked_ffn_mod.train_fwd_launches,
            "masked_ffn_dx": _masked_ffn_mod.dx_launches,
            "masked_ffn_train_fwd_tc": _masked_ffn_mod.train_fwd_tc_launches,
            "masked_ffn_dx_tc": _masked_ffn_mod.dx_tc_launches,
            "masked_ffn_dw": _masked_ffn_mod.dw_launches,
            "masked_ffn_dw_tc": _masked_ffn_mod.dw_tc_launches,
            **_masked_attn_mod.LAUNCHES,
            "rwkv_chunk_scan": _rwkv_chunk_mod.launches,
            "rwkv_chunk_scan_bf16": _rwkv_chunk_mod.bf16_launches,
            "invariant_stats": _invariant_stats_mod.launches}


def reset_launch_counts():
    for c in LAUNCHES.values():
        c.reset()


def launch_counts() -> dict:
    return {name: c.n for name, c in LAUNCHES.items()}


def invariant_stats(w0, w1):
    """Per-column relative update norm ||dW_col|| / (||W0_col|| + eps).

    w0, w1: (d_in, n), same shape and dtype (fp32 or bf16). Returns (n,)
    fp32, the per-neuron invariance statistic of core/invariant.py in one
    reduction. Forward-only. Plain version:
    invariant_stats.invariant_stats_plain."""
    return _invariant_stats_mod.invariant_stats(w0, w1)


def masked_ffn(x, w_in, w_out, block_mask, w_gate=None, act="silu"):
    """Block-masked FFN, differentiable: y = act-FFN(x) with 128-neuron
    hidden blocks dropped per ``block_mask`` ((F//128,) 0/1). x: (M, d);
    w_in/(w_gate): (d, F); w_out: (F, d); F a multiple of 128. Dropped
    blocks are skipped forward and backward, and their dW is exactly 0.
    The training kernels at C = 1 (one launch each of forward, dx, dW).
    Plain versions: those of masked_ffn_train."""
    return _masked_ffn_mod.masked_ffn(x, w_in, w_out, block_mask,
                                      w_gate=w_gate, act=act)


def neuron_mask_to_block_mask(mask: np.ndarray) -> np.ndarray:
    """Per-neuron 0/1 mask (F,) -> per-128-block mask (F//128,).
    A block survives if ANY of its neurons survives (conservative)."""
    F = mask.shape[0]
    assert F % BLOCK_NEURONS == 0
    return (mask.reshape(F // BLOCK_NEURONS, BLOCK_NEURONS).max(axis=1) > 0
            ).astype(np.int32)


def masked_ffn_batch(x, w_in, w_out, row_mask, w_gate=None, act="silu"):
    """Per-row-masked FFN forward: each row of x (M, d) carries its own
    (F,) 0/1 neuron mask (row_mask: (M, F)); w_in/(w_gate): (d, F), w_out:
    (F, d), F a multiple of 128. An (8-row, 128-neuron) tile that every row
    drops is skipped; kept tiles apply the exact per-row mask.
    Plain version: masked_ffn.masked_ffn_batch_plain."""
    return _masked_ffn_mod.masked_ffn_batch(x, w_in, w_out, row_mask,
                                            w_gate=w_gate, act=act)


def masked_ffn_train(x, w_in, w_out, row_mask, w_gate=None, act="silu"):
    """Client-batched, differentiable per-row-masked FFN (the fleet's
    training form): x (C, M, d), w_in/(w_gate) (C, d, F), w_out (C, F, d),
    row_mask (C, M, F). Its forward launches one kernel for all C clients,
    its backward one dx and one dW kernel; dropped tiles are skipped and
    their dW is exactly 0. Plain versions: masked_ffn.masked_ffn_batch_plain,
    masked_ffn_dx_plain, masked_ffn_dw_plain."""
    return _masked_ffn_mod.masked_ffn_train(x, w_in, w_out, row_mask,
                                            w_gate=w_gate, act=act)


def decode_gqa(q, k, v, lengths):
    """Flash-decode grouped-query attention over a ragged KV cache.

    q: (B, H, hd); k/v: (B, C, KV, hd); lengths: (B,) valid prefix per
    batch row. Returns (B, H, hd). Forward-only (serving path).
    Plain version: decode_gqa.decode_gqa_plain."""
    return _decode_gqa_mod.decode_gqa(q, k, v, lengths)


def masked_head_proj(x, w, head_mask):
    """Client-batched, differentiable head-masked projection y = x·W (Q,
    K, V): x (C, M, din), w (C, din, H·hd), head_mask (C, H). Dropped
    heads' columns are exact zeros, and so are their dW slabs. One launch
    forward, one dx and one dW launch backward. Plain versions:
    masked_attn.masked_head_proj_plain, masked_head_proj_dx_plain,
    masked_head_proj_dw_plain."""
    return _masked_attn_mod.masked_head_proj(x, w, head_mask)


def masked_head_merge(a, w, head_mask):
    """Client-batched, differentiable head-masked merge y = Σ_kept a_h·W_h
    (O): a (C, M, H·hd), w (C, H·hd, d), head_mask (C, H). One launch
    forward, one da and one dW launch backward; dropped heads' da slabs
    and dW rows are exact zeros. Plain versions:
    masked_attn.masked_head_merge_plain, masked_head_merge_da_plain,
    masked_head_merge_dw_plain."""
    return _masked_attn_mod.masked_head_merge(a, w, head_mask)


def masked_attention(x, wq, wk, wv, wo, head_mask, n_heads):
    """Head-masked causal self-attention over a client axis: x (C, B, S,
    d), wq/wk/wv (C, d, H·hd), wo (C, H·hd, d), head_mask (C, H). Q/K/V
    and O go through ``masked_head_proj`` and ``masked_head_merge`` (this
    module's, so that a caller's swap reaches them); the softmax is plain
    torch. Plain version: the same composition over the plain versions
    (masked_attn.masked_attention on CPU tensors)."""
    return _masked_attn_mod.masked_attention(x, wq, wk, wv, wo, head_mask,
                                             n_heads, proj=masked_head_proj,
                                             merge=masked_head_merge)


def rwkv_chunk_scan(r, k, v, logw, u, chunk=64, state=None):
    """Chunked RWKV-6 linear-attention recurrence.

    r/k/v/logw: (B, S, H, N), logw fp32 (< 0); u: (H, N); state: optional
    (B, H, N, N) fp32 initial state, zero when None. Returns (y (B,S,H,N)
    fp32, final state (B,H,N,N) fp32). The kernel is forward-only (serving
    prefill); under autograd the plain chunked form runs instead.
    Plain version: rwkv_chunk.rwkv_chunk_scan_plain."""
    return _rwkv_chunk_mod.rwkv_chunk_scan(r, k, v, logw, u, chunk=chunk,
                                           state=state)


def rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=64, state=None):
    """The bf16 chunk form of ``rwkv_chunk_scan`` (the reference's
    ``rwkv_chunk_dtype="bfloat16"``): the decay tensor and the intra-chunk
    scores rounded to bf16 as the reference rounds them, the rest fp32.
    Plain version: rwkv_chunk.rwkv_chunk_scan_plain(chunk_dtype=bf16)."""
    return _rwkv_chunk_mod.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=chunk,
                                                state=state)
