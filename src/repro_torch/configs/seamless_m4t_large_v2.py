"""SeamlessM4T-Large v2 text/speech backbone [arXiv:2308.11596].

Enc-dec transformer: 24 encoder + 24 decoder layers ("24L" in the assignment
is read as the per-stack depth of the published large-v2 card), d_model=1024,
16 heads (GQA kv=16 == MHA), d_ff=8192 (ReLU, non-gated), vocab 256206.
The speech frontend (mel + conformer feature extractor) is a stub: input_specs
provides frame embeddings (B, S, d_model) directly.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    citation="arXiv:2308.11596",
    n_layers=24,
    enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    ffn_kind="relu",
    norm_kind="layernorm",
    use_bias=True,
    vocab_size=256206,
    frontend="audio",
    block_pattern=("attn",),
    remat="block",
    optimizer="adamw",
)
