"""The work of an MLA + MoE train step (DeepSeek-V2's block), counted from
the configuration's shapes, the masks the benchmark hands the program and
the tokens processed, never from what the program executes.

Model FLOPs (``mfu``), per token of a layer: MLA's projections (the query,
the latent and its rotary key, the K and V up-projections once a token,
the output), attention over the positions attended (scores over the
nope + rope width, the weighted sum over v), the router, the routed
experts' kept units (k picks, three matrices each) and the shared experts'
units; the leading dense layers' kept units; the head. No embedding, no
recomputed (remat) work, and no unit a route computes but the mask drops;
a train step counts 3x its forward.

Kernel work (``expert_gemm_roofline``): one call of the routed experts'
three products over a layer's picks, each pick through its expert's kept
units, and its least bytes, the kept units' bf16 weights read once.
"""
from __future__ import annotations

from harness.counts import causal_context_sum
from harness.weights_mla_moe import dims


def mla_proj_flops(c) -> int:
    """FLOPs of one token's MLA projections in one layer."""
    z = dims(c)
    d, H, qk = z["d"], z["H"], z["nope"] + z["rope"]
    return 2 * (d * H * qk + d * (z["lora"] + z["rope"])
                + z["lora"] * H * (z["nope"] + z["vd"]) + H * z["vd"] * d)


def mla_context_flops(c, attended: int) -> int:
    """FLOPs of one query's scores and weighted sum over ``attended`` keys."""
    z = dims(c)
    return 2 * z["H"] * (z["nope"] + z["rope"] + z["vd"]) * attended


def router_flops(c) -> int:
    z = dims(c)
    return 2 * z["d"] * z["E"]


def swiglu_flops(c, units: float) -> float:
    """FLOPs of one token through ``units`` SwiGLU units (three matrices)."""
    return 3 * 2 * dims(c)["d"] * units


def moe_flops(c, kept_per_expert: float) -> float:
    """FLOPs of one token through one MoE layer's experts: k picks of
    ``kept_per_expert`` units, the shared experts' units and the router."""
    z = dims(c)
    k = c["num_experts_per_tok"]
    return router_flops(c) + swiglu_flops(c, k * kept_per_expert) + swiglu_flops(c, z["fs"])


def head_flops(c) -> int:
    z = dims(c)
    return 2 * z["d"] * z["V"]


def forward_flops(c, dense_kept, moe_kept_per_expert, seq: int) -> float:
    """Forward FLOPs of one sequence of ``seq`` positions: ``dense_kept``
    the kept units of each dense layer, ``moe_kept_per_expert`` the mean
    kept units an expert of each MoE layer."""
    mla = seq * mla_proj_flops(c) + mla_context_flops(c, 1) * causal_context_sum(0, seq)
    return (sum(mla + seq * swiglu_flops(c, k) for k in dense_kept)
            + sum(mla + seq * moe_flops(c, k) for k in moe_kept_per_expert)
            + seq * head_flops(c))


def train_step_flops(c, dense_kept, moe_kept_per_expert, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 3x the forward of batch sequences."""
    return 3 * batch * forward_flops(c, dense_kept, moe_kept_per_expert, seq)


def expert_gemm_work(c, picks: int, kept_units: float, elem: int = 2):
    """(flops, bytes) of one call of a layer's routed experts: ``picks``
    rows, each through its expert's kept units (``kept_units`` over all
    the layer's experts, so kept_units / E an expert), up, gate and down;
    the kept units' three matrices read once in bf16."""
    z = dims(c)
    return (swiglu_flops(c, picks * kept_units / z["E"]),
            3 * kept_units * z["d"] * elem)
