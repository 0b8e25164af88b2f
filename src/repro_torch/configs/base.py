"""Model configuration schema + registry (port of ``repro/configs/base.py``).

The schema is the reference's field for field, plus ``PORT_ONLY``: fields
of published blocks the reference does not model, whose defaults keep the
reference's behaviour. ``smoke()`` cuts every config to the same shapes in
both packages. Every architecture of the reference is registered, and
``models.model`` builds and runs each.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------------
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    citation: str = ""

    # trunk ------------------------------------------------------------------
    n_layers: int = 2          # decoder layers (encdec: decoder side)
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024
    vocab_pad_multiple: int = 256

    # block layout -----------------------------------------------------------
    block_pattern: Tuple[str, ...] = ("attn",)  # cycled layer kinds
    ffn_kind: str = "swiglu"   # swiglu | gelu | gelu_gated | relu | relu2
    use_bias: bool = False
    parallel_block: bool = False   # command-r style parallel attn+ffn
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm
    rope_theta: float = 10000.0
    # YaRN (DeepSeek-V2's ``rope_scaling``), read by MLA's rotary slice and
    # softmax scale: None, or the published dict, kept as sorted (key,
    # value) pairs so the config stays hashable; ``yarn`` gives the dict
    rope_scaling: Optional[Tuple[Tuple[str, object], ...]] = None
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # attention --------------------------------------------------------------
    window: Optional[int] = None        # sliding window for "local" layers
    long_context_window: int = 4096     # window substituted at long_500k

    # MLA --------------------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # MoE --------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_ff_residual: bool = False
    first_k_dense: int = 0
    router_aux_coef: float = 0.001
    norm_topk_prob: bool = True    # top-k weights over their sum; else raw probs
    seq_aux: bool = False          # balance loss per sequence, then the mean
    moe_impl: str = "capacity"
    moe_token_chunk: int = 8192
    moe_expert_chunk: int = 0
    moe_weight_stream: bool = False
    moe_capacity_factor: float = 1.25

    # RWKV-6 -----------------------------------------------------------------
    rwkv_head_size: int = 64
    rwkv_chunk: int = 256
    rwkv_chunk_dtype: str = "float32"

    # RG-LRU (RecurrentGemma) --------------------------------------------------
    lru_width: int = 0
    conv1d_width: int = 4

    # encoder–decoder ----------------------------------------------------------
    enc_layers: int = 0
    cross_every: int = 1

    # modality frontend stub ---------------------------------------------------
    frontend: Optional[str] = None

    # numerics -----------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # training -----------------------------------------------------------------
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    remat: str = "none"
    grad_accum: int = 1

    def reference_fields(self) -> dict:
        """``dataclasses.asdict`` without ``PORT_ONLY``: the reference's
        schema. Raises where a port-only field is off its default, which
        that schema cannot state."""
        out = dataclasses.asdict(self)
        for f in dataclasses.fields(self):
            if f.name in PORT_ONLY:
                if out.pop(f.name) != f.default:
                    raise ValueError(f"{f.name} is set; the reference's schema "
                                     f"has no such field")
        return out

    def __post_init__(self):
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(self, "rope_scaling",
                               tuple(sorted(self.rope_scaling.items())))

    # derived -------------------------------------------------------------------
    @property
    def yarn(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind list of length n_layers (decoder side)."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def ffn_kind_for_layer(self, i: int) -> str:
        """'dense' or 'moe' FFN for decoder layer i."""
        if self.n_experts and i >= self.first_k_dense:
            return "moe"
        return "dense"

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Reduced variant for CPU smoke tests -------------------------------------
    def smoke(self) -> "ModelConfig":
        d = min(self.d_model, 256)
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        hd = min(self.head_dim, 32)
        over = dict(
            n_layers=min(self.n_layers, 2) if not self.block_pattern or len(self.block_pattern) == 1
            else len(self.block_pattern),
            d_model=d, n_heads=heads, n_kv_heads=kv, head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512), vocab_pad_multiple=64,
            window=None if self.window is None else min(self.window, 64),
        )
        if self.n_experts:
            over.update(n_experts=min(self.n_experts, 4),
                        top_k=min(self.top_k, 2),
                        moe_d_ff=min(self.moe_ff, 128),
                        n_shared_experts=min(self.n_shared_experts, 1),
                        first_k_dense=min(self.first_k_dense, 1))
        if self.use_mla:
            over.update(kv_lora_rank=min(self.kv_lora_rank, 64), q_lora_rank=0,
                        qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32)
        if self.arch_type == "ssm":
            over.update(rwkv_head_size=32, rwkv_chunk=16, d_model=128, d_ff=448)
        if self.lru_width:
            over.update(lru_width=128, d_model=128)
        if self.enc_layers:
            over.update(enc_layers=2, n_layers=2)
        return self.with_overrides(**over)


PORT_ONLY = ("rope_scaling", "norm_topk_prob", "seq_aux")

# ---------------------------------------------------------------------------
# Registry

_ARCH_MODULES = [
    "seamless_m4t_large_v2",
    "rwkv6_3b",
    "deepseek_v2_lite_16b",
    "granite_20b",
    "stablelm_12b",
    "minicpm3_4b",
    "recurrentgemma_9b",
    "command_r_35b",
    "arctic_480b",
    "chameleon_34b",
]

ARCH_IDS = [m.replace("_", "-") for m in _ARCH_MODULES]

_REGISTRY: dict = {}


def get_config(arch_id: str) -> ModelConfig:
    """Look up an architecture config by its public id (e.g. 'stablelm-12b')."""
    key = arch_id.replace("-", "_")
    if key not in _ARCH_MODULES:
        raise KeyError(f"unknown architecture {arch_id!r}; known: {ARCH_IDS}")
    if key not in _REGISTRY:
        mod = importlib.import_module(f"repro_torch.configs.{key}")
        _REGISTRY[key] = mod.CONFIG
    return _REGISTRY[key]


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
