"""MiniCPM3-4B — MLA attention [hf:openbmb/MiniCPM3-4B].

62 layers, d_model=2560, 40 heads, MLA kv_lora_rank=256, d_ff=6400 (SwiGLU),
vocab 73448.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    arch_type="dense",
    citation="hf:openbmb/MiniCPM3-4B",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    ffn_kind="swiglu",
    use_mla=True,
    kv_lora_rank=256,
    q_lora_rank=768,
    qk_rope_dim=32,
    qk_nope_dim=64,
    v_head_dim=64,
    vocab_size=73448,
    block_pattern=("attn",),
    remat="block",
    optimizer="adamw",
)
