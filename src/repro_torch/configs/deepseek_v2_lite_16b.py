"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE [arXiv:2405.04434].

27 layers, d_model=2048, 16 heads, MLA kv_lora_rank=512, MoE with
2 shared + 64 routed experts top-6, expert d_ff=1408; first layer dense.
(The assignment line lists both "64e top-6" and "160 routed"; 160 routed
belongs to full V2 — the Lite card is 64 routed, which we use.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    citation="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,            # dense FFN of the first layer
    moe_d_ff=1408,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    first_k_dense=1,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,         # Lite has no q-LoRA
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    vocab_size=102400,
    block_pattern=("attn",),
    remat="block",
    optimizer="adamw",
)
