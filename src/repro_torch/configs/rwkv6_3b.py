"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay [arXiv:2404.05892].

32 layers, d_model=2560 (40 heads x 64), channel-mix d_ff=8960 (squared-ReLU),
vocab 65536. Prefill runs the chunked linear-attention formulation
(intra-chunk parallel, inter-chunk carry) through the chunked WKV kernel.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    citation="arXiv:2404.05892",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # = d_model / rwkv_head_size
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    ffn_kind="relu2",
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv_head_size=64,
    rwkv_chunk=128,
    remat="block",
    optimizer="adamw",
)
