"""FLuID hooks for the transformer path (port of ``repro/core/transformer_hooks.py``).

The FL simulator drops neurons by physical extraction (core/submodel.py).
On the big architectures the same statistic is applied through masks: per
layer, FFN hidden units (an MoE layer's expert units, and whole experts
with ``drop_experts``) are scored by the norm-relative update statistic
and the lowest-stat units masked. ``block128`` rounds the kept set to
128-unit blocks, the blocks the masked FFN kernel skips.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dropout import keep_count
from repro_torch.models import transformer


def _ffn_stat(prev_l, new_l):
    """Per-hidden-unit norm-relative delta of one stacked FFN: w_in,
    w_gate (R, d, f) and w_out (R, f, d). Returns (R, f) fp32."""
    num = den = 0.0
    for key, axis in (("w_in", 1), ("w_gate", 1), ("w_out", 2)):
        if key in prev_l:
            w0, w1 = prev_l[key].float(), new_l[key].float()
            num = num + torch.square(w1 - w0).sum(dim=axis)
            den = den + torch.square(w0).sum(dim=axis)
    return torch.sqrt(num) / (torch.sqrt(den) + 1e-8)


def ffn_unit_stats(prev_params, new_params, cfg: ModelConfig):
    """Per segment, {'l<i>': {'ffn': (R, f)}} for a dense FFN or channel
    mix, {'l<i>': {'moe': (R, E, f), 'experts': (R, E)}} for an MoE layer
    (its experts' w_in alone, and each expert's mean)."""
    out = []
    for si, seg in enumerate(transformer.build_segments(cfg)):
        seg_prev = prev_params["stack"][f"seg{si}"]
        seg_new = new_params["stack"][f"seg{si}"]
        unit = {}
        for i, (_, ffn) in enumerate(seg.unit):
            lp, ln = seg_prev[f"l{i}"], seg_new[f"l{i}"]
            entry = {}
            if ffn in ("dense", "cmix"):
                key = "ffn" if ffn == "dense" else "cmix"
                entry["ffn"] = _ffn_stat(lp[key], ln[key])
            elif ffn == "moe":
                w0, w1 = lp["moe"]["w_in"].float(), ln["moe"]["w_in"].float()
                num = torch.square(w1 - w0).sum(dim=2)           # (R, E, f)
                den = torch.square(w0).sum(dim=2)
                entry["moe"] = torch.sqrt(num) / (torch.sqrt(den) + 1e-8)
                entry["experts"] = entry["moe"].mean(dim=-1)     # (R, E)
            unit[f"l{i}"] = entry
        out.append(unit)
    return out


def _mask_from_stats(stats: np.ndarray, r: float, block128: bool):
    """Keep the (r * n) highest-stat units along the last axis."""
    n = stats.shape[-1]
    k = keep_count(n, r)
    if block128 and n % 128 == 0:
        blocks = stats.reshape(*stats.shape[:-1], n // 128, 128).mean(-1)
        kb = max(1, int(round(n // 128 * r)))
        thresh = np.sort(blocks, axis=-1)[..., -kb][..., None]
        bm = (blocks >= thresh).astype(np.float32)
        return np.repeat(bm, 128, axis=-1)
    thresh = np.sort(stats, axis=-1)[..., -k][..., None]
    return (stats >= thresh).astype(np.float32)


def build_masks(unit_stats, cfg: ModelConfig, r: float, block128: bool = True,
                drop_experts: bool = False):
    """Masks for ``model.forward_seq(masks=...)`` from ffn_unit_stats, host
    float32 tensors: 'ffn' (R, f), an MoE layer's 'moe' (R, E, f) and, with
    drop_experts, 'experts' (R, E)."""
    def mask(stats, blocks):
        arr = stats.detach().cpu().numpy()
        return torch.from_numpy(_mask_from_stats(arr, r, blocks))
    out = []
    for seg_stats in unit_stats:
        unit = {}
        for lname, entry in seg_stats.items():
            m = {}
            if "ffn" in entry:
                m["ffn"] = mask(entry["ffn"], block128)
            if "moe" in entry:
                m["moe"] = mask(entry["moe"], block128)
                if drop_experts:
                    m["experts"] = mask(entry["experts"], False)
            unit[lname] = m
        out.append(unit)
    return out


def full_masks(cfg: ModelConfig):
    """All-ones masks (the r=1.0 sub-model), host float32 tensors:
    per segment, {'l<i>': {'ffn': (R, d_ff)}} or, for an MoE layer,
    {'l<i>': {'moe': (R, E, moe_ff)}}."""
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
