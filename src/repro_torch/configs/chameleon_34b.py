"""Chameleon-34B — early-fusion mixed-modal [arXiv:2405.09818].

48 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=22016 (SwiGLU),
vocab 65536 including VQ-VAE image-token codes. Early fusion means the
"vision frontend" is the VQ tokenizer — inputs are already token ids, so
input_specs supplies interleaved text+image token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    citation="arXiv:2405.09818",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    ffn_kind="swiglu",
    norm_kind="rmsnorm",
    vocab_size=65536,
    frontend="vision",
    block_pattern=("attn",),
    remat="block",
    optimizer="adamw",
)
