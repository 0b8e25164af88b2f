"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

40 layers, d_model=8192, 64 heads (GQA kv=8), d_ff=22528 (SwiGLU), no biases,
parallel attention+FFN blocks, vocab 256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    citation="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    ffn_kind="swiglu",
    use_bias=False,
    parallel_block=True,
    norm_kind="layernorm",
    vocab_size=256000,
    block_pattern=("attn",),
    remat="block",
    optimizer="adamw",
)
