"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention 2:1 [arXiv:2402.19427].

38 layers in a (recurrent, recurrent, local_attn) cycle (12 full cycles + 2
trailing recurrent layers), d_model=4096, 16 heads MQA (kv=1), d_ff=12288
(gated GeLU), vocab 256000, local attention window 2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    citation="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    ffn_kind="gelu_gated",
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    lru_width=4096,
    conv1d_width=4,
    logit_softcap=30.0,
    remat="block",
    optimizer="adamw",
)
