#!/usr/bin/env python3
"""How far a bf16 masked train step's FFN gradients lie from the fp32 ones,
by route: the dense masked FFN and the training kernels' route.

    python3 scripts/train_route_noise.py [--device cpu|cuda] [L:d:F ...]
                                         # default: cpu, 4:256:1024 2:1024:2048

For each StableLM-2-12B smoke config cut to L layers of width d and FFN
width F (fp32 params, seed 0, blocks 1 of every layer dropped, the
reference's synthetic batch of 2 x 64) it takes the gradients three ways
(``launch.steps.make_grads_fn``): fp32 compute, bf16 dense, bf16 through
the kernel route (their plain versions on the CPU), and prints one JSON
line: each bf16 route's loss, and each layer's W_in gradient against the
fp32 one and against the other route (relative 2-norm). It sets the scale
chip_smoke's kernel-against-dense gradient gate (2e-2) is read against.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def gaps(torch, np, L, d, F, dev):
    from repro_torch.configs import get_config
    from repro_torch.core import transformer_hooks as hooks
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import steps, train
    from repro_torch.models import model
    cfg = get_config("stablelm-12b").smoke().with_overrides(n_layers=L, d_model=d, d_ff=F)
    params = model.init_params(cfg, seed=0, device=dev)
    masks = hooks.full_masks(cfg)
    masks[0]["l0"]["ffn"][:, 128:256] = 0
    masks = tree_map(lambda m: m.to(dev), masks)
    batch = train.synth_batch(np.random.RandomState(0), cfg, 2, 65, dev)
    rel2 = lambda a, b: float((a - b).norm() / b.norm())
    grads, losses = {}, {}
    for name, c, kernels in (("fp32", dataclasses.replace(cfg, dtype="float32"), False),
                             ("dense_bf16", cfg, False), ("kernel_bf16", cfg, True)):
        (loss, _), g = steps.make_grads_fn(c, kernels)(params, batch, masks)
        grads[name], losses[name] = g["stack"]["seg0"]["l0"]["ffn"]["w_in"], float(loss)
    ref = grads["fp32"]
    return {"L": L, "d": d, "F": F, "device": str(dev), "loss": losses,
            "dense_vs_fp32": [rel2(a, b) for a, b in zip(grads["dense_bf16"], ref)],
            "kernel_vs_fp32": [rel2(a, b) for a, b in zip(grads["kernel_bf16"], ref)],
            "kernel_vs_dense": [rel2(a, b) for a, b in zip(grads["kernel_bf16"],
                                                            grads["dense_bf16"])]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("shapes", nargs="*", default=["4:256:1024", "2:1024:2048"])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    for shape in args.shapes:
        L, d, F = (int(v) for v in shape.split(":"))
        print(json.dumps(gaps(torch, np, L, d, F, torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
