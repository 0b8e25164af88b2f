"""FLuID hooks for the transformer path (port of ``repro/core/transformer_hooks.py``).

Only ``full_masks`` is ported so far; ``ffn_unit_stats`` and
``build_masks`` come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def full_masks(cfg: ModelConfig):
    """All-ones masks (the r=1.0 sub-model), host float32 tensors:
    per segment, {'l<i>': {'ffn': (R, d_ff)}}."""
    out = []
    for seg in transformer.build_segments(cfg):
        unit = {}
        for i, (mixer, ffn) in enumerate(seg.unit):
            m = {}
            if ffn in ("dense", "cmix"):
                m["ffn"] = torch.ones((seg.repeats, cfg.d_ff),
                                      dtype=torch.float32)
            elif ffn == "moe":
                m["moe"] = torch.ones((seg.repeats, cfg.n_experts,
                                       cfg.moe_ff), dtype=torch.float32)
            unit[f"l{i}"] = m
        out.append(unit)
    return out
