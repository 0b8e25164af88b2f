"""The work a cell's traffic needs, counted from the configuration's shapes,
the masks the benchmark hands the program and the tokens processed: never
from what the program executes, so any route that computes the same
sub-model reads the same work.

Model FLOPs (``mfu``): every matmul with only the kept FFN units counted,
attention's context term over the positions actually attended, and the
output head; no embedding lookup and no recomputed (remat) work; a train
step counts 3x its forward.

Kernel work (the rooflines): each call's operations from its shape and its
mask's kept blocks, and its bytes with each input read once and each
output written once.
"""
from __future__ import annotations

BLOCK = 128          # neurons in an FFN block


def attn_proj_flops(c) -> int:
    """FLOPs of one token's q, k, v and o projections in one layer."""
    d, H, KV, hd = (c["hidden_size"], c["num_attention_heads"],
                    c["num_key_value_heads"], c["head_dim"])
    return 2 * d * (H * hd + 2 * KV * hd) + 2 * H * hd * d


def attn_context_flops(c, attended: int) -> int:
    """FLOPs of one query's scores and weighted sum over ``attended`` keys."""
    return 4 * c["num_attention_heads"] * c["head_dim"] * attended


def ffn_flops(c, kept_units: int) -> int:
    """FLOPs of one token through one layer's FFN keeping ``kept_units``."""
    gated = c["ffn_kind"] in ("swiglu", "gelu_gated")
    return (3 if gated else 2) * 2 * c["hidden_size"] * kept_units


def head_flops(c) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def causal_context_sum(first: int, last: int) -> int:
    """Sum of attended keys over query positions first..last-1 (causal:
    position p attends p + 1 keys)."""
    return (last * (last + 1) - first * (first + 1)) // 2


def forward_flops(c, kept_units_by_layer, first: int, last: int,
                  head_tokens: int) -> int:
    """Forward FLOPs of query positions first..last-1 of one sequence
    through every layer (``kept_units_by_layer``: FFN units kept in each
    layer), with the output head on ``head_tokens`` of them."""
    n = last - first
    per_layer = n * attn_proj_flops(c) + attn_context_flops(
        c, 1) * causal_context_sum(first, last)
    return (sum(per_layer + n * ffn_flops(c, k) for k in kept_units_by_layer)
            + head_tokens * head_flops(c))


def train_step_flops(c, kept_units_by_layer, batch: int, seq: int) -> int:
    """Model FLOPs of one train step: 3x the forward of batch sequences of
    seq positions, every position through the head."""
    return 3 * batch * forward_flops(c, kept_units_by_layer, 0, seq, seq)


def serve_request_flops(c, kept_units_by_layer, prompt_len: int,
                        gen_len: int) -> int:
    """Model FLOPs of one served request: the prompt's positions and the
    gen_len - 1 generated tokens fed back, each through every layer; the
    head once for each generated token (the prompt's last position gives
    the first)."""
    return forward_flops(c, kept_units_by_layer, 0, prompt_len + gen_len - 1,
                         gen_len)


# ---------------------------------------------------------------------------
# the masked-FFN kernels

def train_kernel_work(c, kept_blocks: int, M: int, elem: int = 2):
    """(flops, bytes) of one call of each training kernel at C 1, M rows
    sharing one layer mask of ``kept_blocks`` blocks: the forward's two up
    products and one down product over the kept units; dx recomputes the up
    products, takes the hidden gradient and its two products (5 products);
    dW recomputes the up products, the hidden gradient and all three weight
    gradients (6). Bytes: x (and gy) read and y / dx written once, the kept
    blocks' weights read once, the fp32 row mask read once, dW written
    whole."""
    d, F = c["hidden_size"], c["intermediate_size"]
    gated = c["ffn_kind"] in ("swiglu", "gelu_gated")
    nmat = 3 if gated else 2
    product = 2 * M * d * kept_blocks * BLOCK
    io, wbytes, mbytes = M * d * elem, kept_blocks * BLOCK * d * elem * nmat, M * F * 4
    return {"fwd": (product * nmat, 2 * io + wbytes + mbytes),
            "dx": (product * (5 if gated else 3), 3 * io + wbytes + mbytes),
            "dw": (product * (6 if gated else 4),
                   2 * io + wbytes + mbytes + d * F * elem * nmat)}


def serve_ffn_bytes(c, union_blocks: int, M: int, elem: int = 2) -> int:
    """Least bytes of one decode call of the serving FFN: every block that
    some live slot keeps, read once, the activations in and out, and the
    fp32 row mask read once."""
    gated = c["ffn_kind"] in ("swiglu", "gelu_gated")
    d, F = c["hidden_size"], c["intermediate_size"]
    return (union_blocks * BLOCK * d * elem * (3 if gated else 2) + 2 * M * d * elem
            + M * F * 4)
