"""Snowflake Arctic 480B — dense-MoE hybrid [hf:Snowflake/snowflake-arctic-base].

35 layers, d_model=7168, 56 heads (GQA kv=8), MoE 128 experts top-2 with
expert d_ff=4864, plus a dense residual FFN (d_ff=4864) in parallel,
vocab 32000. Optimizer sgdm to bound per-chip optimizer-state bytes at 480B.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    citation="hf:Snowflake/snowflake-arctic-base",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,             # dense residual branch
    moe_d_ff=4864,
    n_experts=128,
    top_k=2,
    moe_weight_stream=True,
    grad_accum=8,
    dense_ff_residual=True,
    vocab_size=32000,
    block_pattern=("attn",),
    param_dtype="bfloat16",  # 480B: fp32 master + state would exceed HBM
    optimizer="sgdm",
    remat="block",
)
