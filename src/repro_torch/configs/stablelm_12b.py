"""StableLM-2 12B [hf:stabilityai/stablelm-2-1_6b family].

40 layers, d_model=5120, 32 heads (GQA kv=8), d_ff=13824 (SwiGLU),
vocab 100352.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    citation="hf:stabilityai/stablelm-2-1_6b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    ffn_kind="swiglu",
    vocab_size=100352,
    block_pattern=("attn",),
    remat="block",
    optimizer="adamw",
)
