"""Granite-20B code model [arXiv:2405.04324].

52 layers, d_model=6144, 48 heads MQA (kv=1), d_ff=24576 (non-gated GELU),
vocab 49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    citation="arXiv:2405.04324",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    ffn_kind="gelu",
    use_bias=True,
    norm_kind="layernorm",
    vocab_size=49152,
    block_pattern=("attn",),
    remat="block",
    optimizer="adamw",
)
