#!/usr/bin/env python3
"""Where a full-width decode step's kernel-vs-plain gap grows, layer by layer.

    python3 scripts/step_noise_curves.py [ARCH ...]    # default: recurrentgemma-9b

For each model (bf16 weights from ``init_params``, seed 0) it takes
``chip_smoke.step_state``'s decode step five times from the same caches:
with the kernels (twice), with the plain versions (twice), and with the
plain versions but masked_ffn_batch's fp32 products summed as two halves
(``chip_smoke.reordered_plain(2)``: the same arithmetic in another order,
no kernel). It prints one JSON line per model: the relative 2-norm of the
residual stream after each layer, kernel against plain and reordered
against plain; the final hidden state's gaps; whether reruns repeat
bitwise; and the stream's rms by layer. Needs one CUDA device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def curves(torch, np, cs, arch):
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import model, transformer
    cfg = get_config(arch)
    params = model.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    caches, tok, pos, masks, _ = cs.step_state(torch, np, params, cfg)
    saved = tree_map(lambda t: t.clone(), caches)
    layer_out = []
    apply_layer = transformer._apply_layer_decode

    def recording(*a, **k):
        y = apply_layer(*a, **k)
        layer_out.append(y.float().clone())
        return y
    transformer._apply_layer_decode = recording
    runs = {}
    try:
        for name in ("kernel", "kernel2", "plain", "plain2", "reordered"):
            tree_map(lambda c, s0: c.copy_(s0), caches, saved)
            layer_out.clear()
            undo = None if name.startswith("kernel") else cs.swap_in_plain(ops)
            if name == "reordered":
                ops.masked_ffn_batch = cs.reordered_plain(2)
            try:
                h = model.decode_hidden(params, cfg, caches, tok, pos, masks=masks)
            finally:
                if undo:
                    undo()
            runs[name] = (list(layer_out), h.float())
    finally:
        transformer._apply_layer_decode = apply_layer

    def by_layer(a, b):
        return [cs.rel2(x, y) for x, y in zip(runs[a][0], runs[b][0])]
    return {"arch": arch, "layers": cfg.n_layers,
            "kernel_vs_plain_by_layer": by_layer("kernel", "plain"),
            "reordered_vs_plain_by_layer": by_layer("reordered", "plain"),
            "hidden_kernel_vs_plain": cs.rel2(runs["kernel"][1], runs["plain"][1]),
            "hidden_reordered_vs_plain": cs.rel2(runs["reordered"][1], runs["plain"][1]),
            "kernel_repeats_bitwise": bool(torch.equal(runs["kernel"][1], runs["kernel2"][1])),
            "plain_repeats_bitwise": bool(torch.equal(runs["plain"][1], runs["plain2"][1])),
            "rms_by_layer": [float(x.pow(2).mean().sqrt()) for x in runs["plain"][0]]}


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("step_noise_curves: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    for arch in sys.argv[1:] or ["recurrentgemma-9b"]:
        print(json.dumps(curves(torch, np, cs, arch)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
