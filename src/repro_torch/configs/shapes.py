"""The four input shapes of the dry-run and their input specs (port of
``repro/configs/shapes.py``).

``input_specs(cfg, shape)`` returns the kwargs tree a step is called with,
as ``TensorSpec`` leaves (the port's ``jax.ShapeDtypeStruct``), allocating
nothing. The decode caches come from ``model.cache_specs``; they carry no
per-slot position record, which the reference's do (``slots``): the port
derives slot positions from the decode position.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def window_override_for(cfg: ModelConfig, shape: InputShape):
    """long_500k swaps full attention for the sliding-window variant."""
    if shape.name != "long_500k":
        return None
    has_full_attn = any(k == "attn" for k in cfg.block_pattern) or cfg.is_encdec
    return cfg.long_context_window if has_full_attn else None


def input_specs(cfg: ModelConfig, shape, batch_override=None):
    """{'batch': {'tokens', 'targets' (train), 'frames' (encoder–decoder)}}
    for train and prefill; {'token', 'pos', 'caches'} for decode: ONE new
    token against a seq_len-deep cache."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.layers import TensorSpec, cdtype
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    B = batch_override or shape.global_batch
    S = shape.seq_len
    i32 = torch.int32

    if shape.mode in ("train", "prefill"):
        spec = {"tokens": TensorSpec((B, S), i32)}
        if shape.mode == "train":
            spec["targets"] = TensorSpec((B, S), i32)
        if cfg.is_encdec:
            spec["frames"] = TensorSpec((B, S, cfg.d_model), cdtype(cfg))
        return {"batch": spec}

    wo = window_override_for(cfg, shape)
    return {"token": TensorSpec((B, 1), i32),
            "pos": TensorSpec((B,), i32),
            "caches": model_lib.cache_specs(cfg, B, S, window_override=wo)}
