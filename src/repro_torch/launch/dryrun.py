"""Dry-run of every (arch x shape x variant) on the meta device (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-12b --shape train_4k

Per combo the step a user would call (``launch/steps``: ``make_train_step``
with AdamW, ``make_prefill_step`` or ``make_serve_step``) runs once at the
config's full size on meta tensors: params from ``init_params(cfg,
device="meta")``, inputs from ``configs/shapes.input_specs``. Nothing is
allocated and no kernel is built: a kernel wrapper given a meta tensor
applies the checks the card's launch applies and runs its plain version, so
a combo the card would refuse raises that refusal here. This is the port's
counterpart of the reference's "lowers and compiles on the mesh". The
reference lowers on a mesh of 256 (or 512) placeholder TPU devices and its
counts are per device; here there is one card, and every count is the
whole step's.

The step runs under ``roofline.count_terms``, which gives its FLOPs, its
bytes (floor and ceiling) and the peak of its live storages. The
reference's per-segment probe lowerings exist only because XLA counts a
while-loop body once; an eager meta run executes every layer, so the port
has none. Results go to ``<out>/<arch>__<shape>__1gpu[__<variant>].json``;
a combo that raises is written as ``.FAIL`` with its traceback.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, input_specs
from repro_torch.configs.shapes import InputShape, window_override_for
from repro_torch.core import transformer_hooks as hooks
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as model_lib
from repro_torch.models.layers import cdtype
from repro_torch.optim import make_optimizer

CARD = "NVIDIA H100 80GB HBM3"
DEFAULT_OUT = os.path.join("build", "dryrun_torch")

# The reference's variants (EXPERIMENTS.md §Perf), by the same names. On one
# card "no_fsdp" changes nothing (there is no ZeRO sharding to drop),
# "cache_seq_shard" selects the grouped decode attention of
# models/attention.attn_decode, not a sharding, and "uniform_pos" changes
# nothing: the per-row cache write fills the same slots (see ``routes``).
VARIANTS = {
    "base": {},
    "serve_tp_bf16": {"no_fsdp": True,
                      "cfg_overrides": {"param_dtype": "bfloat16"}},
    "serve_seqcache": {"no_fsdp": True, "cache_seq_shard": True,
                       "cfg_overrides": {"param_dtype": "bfloat16"}},
    "serve_upos": {"no_fsdp": True, "cache_seq_shard": True,
                   "uniform_pos": True,
                   "cfg_overrides": {"param_dtype": "bfloat16"}},
    "mla_absorb": {"mla_absorb": True, "no_fsdp": True, "cache_seq_shard": True,
                   "cfg_overrides": {"param_dtype": "bfloat16"}},
    "rwkv_chunk32": {"cfg_overrides": {"rwkv_chunk": 32}},
    "rwkv_chunk16": {"cfg_overrides": {"rwkv_chunk": 16}},
    "rwkv_chunk128": {"cfg_overrides": {"rwkv_chunk": 128}},
    "rwkv_c128_bf16": {"cfg_overrides": {"rwkv_chunk": 128,
                                         "rwkv_chunk_dtype": "bfloat16"}},
    "fluid_mask_r75": {"fluid_mask": 0.75},
    "submodel_r75": {"dff_scale": 0.75},
    "submodel_r50": {"dff_scale": 0.5},
    "accum4": {"cfg_overrides": {"grad_accum": 4}},
}


def variant_config(arch: str, variant_name: str = "base"):
    """The arch's config under a variant's overrides (the reference's
    run_combo: cfg_overrides, then d_ff cut to a multiple of 128 and an MoE
    expert's to a multiple of 64 under dff_scale)."""
    variant = VARIANTS[variant_name]
    cfg = get_config(arch)
    if variant.get("cfg_overrides"):
        cfg = cfg.with_overrides(**variant["cfg_overrides"])
    if variant.get("dff_scale"):
        sc = variant["dff_scale"]
        over = {"d_ff": int(cfg.d_ff * sc) // 128 * 128}
        if cfg.n_experts:
            over["moe_d_ff"] = int(cfg.moe_ff * sc) // 64 * 64
        cfg = cfg.with_overrides(**over)
    return cfg


def active_params(cfg) -> int:
    """Active parameter count (MoE: top-k + shared experts only)."""
    sp = model_lib.param_specs(cfg)
    total = model_lib.count_params(sp)
    if cfg.n_experts:
        def moe_size(tree):
            n = 0
            for k, v in tree.items():
                if k == "moe":
                    n += sum(model_lib.count_params([v[kk]])
                             for kk in ("w_in", "w_gate", "w_out") if kk in v)
                elif isinstance(v, dict):
                    n += moe_size(v)
            return n
        routed = moe_size(sp)
        total = total - routed + routed * cfg.top_k // cfg.n_experts
    return total


def _meta(spec_tree):
    """TensorSpec tree -> the same tree of meta tensors."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), spec_tree)


def _bytes(tree) -> int:
    seen, n = set(), 0
    for t in tree_leaves(tree):
        k = t.untyped_storage()._cdata
        if k not in seen:
            seen.add(k)
            n += t.untyped_storage().nbytes()
    return n


def routes(cfg, shape, variant) -> dict:
    """What the variant's switches select on one card."""
    out = {"fsdp": "none on one card (no_fsdp changes nothing)"}
    if shape.mode == "decode":
        out["decode_attention"] = ("_sdpa_grouped (grouped_decode=True)"
                                   if variant.get("cache_seq_shard")
                                   else "decode_gqa (B11), windowed layers plain _sdpa")
        out["cache_write"] = "slot pos % C of each row"
        if variant.get("uniform_pos"):
            out["cache_write"] += ("; on one card the per-row write, which gives the "
                                   "same bits when the rows share a position")
    if cfg.block_pattern and "rwkv" in cfg.block_pattern and shape.mode != "decode":
        out["rwkv_chunk"] = {"chunk": cfg.rwkv_chunk, "dtype": cfg.rwkv_chunk_dtype}
    return out


def dry_step(cfg, shape: InputShape, variant=None):
    """Run cfg's step for ``shape`` once on the meta device under
    ``roofline.count_terms``. Returns (terms, memory): memory with
    argument_bytes (and its breakdown), output_bytes,
    saved_for_backward_bytes and peak_estimate."""
    variant = variant or {}
    wo = window_override_for(cfg, shape)
    specs = _meta(input_specs(cfg, shape))
    params = model_lib.init_params(cfg, device="meta")
    parts = {"params": _bytes(params)}
    if shape.mode == "train":
        opt = make_optimizer(cfg.optimizer)
        state = opt.init(params)
        parts["opt_state"] = _bytes(state)
        masked = variant.get("fluid_mask") is not None
        fn = steps_lib.make_train_step(cfg, with_masks=masked)
        args = (params, state, specs["batch"])
        if masked:
            args += (tree_map(lambda m: torch.empty_like(m, device="meta"),
                              hooks.full_masks(cfg)),)
    elif shape.mode == "prefill":
        fn = steps_lib.make_prefill_step(cfg, window_override=wo)
        args = (params, specs["batch"])
    else:
        fn = steps_lib.make_serve_step(cfg, mla_absorb=variant.get("mla_absorb", False),
                                       window_override=wo,
                                       grouped_decode=bool(variant.get("cache_seq_shard")))
        args = (params, specs["caches"], specs["token"], specs["pos"])
    parts["inputs"] = _bytes(args) - sum(parts.values())
    arg_keys = {t.untyped_storage()._cdata for t in tree_leaves(args)}
    saved = {}

    def pack(t):
        k = t.untyped_storage()._cdata
        if k not in arg_keys:
            saved[k] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _, terms, mem = rl.count_terms(fn, *args, peak=rl.peak_flops(cdtype(cfg)))
    memory = {"argument_bytes": mem["argument_bytes"], "argument_breakdown": parts,
              "output_bytes": mem["output_bytes"], "written_bytes": mem["written_bytes"],
              "saved_for_backward_bytes": sum(saved.values()),
              "peak_estimate": mem["peak_bytes"]}
    return terms, memory


def card_bytes():
    """(name, bytes) of the card: the device's own when one is present,
    else the H100 80GB HBM3 constant."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_name(0),
                torch.cuda.get_device_properties(0).total_memory)
    return CARD, rl.HBM_CAPACITY


def run_combo(arch, shape_name, variant_name="base"):
    variant = VARIANTS[variant_name]
    cfg = variant_config(arch, variant_name)
    shape = INPUT_SHAPES[shape_name]
    t0 = time.time()
    terms, memory = dry_step(cfg, shape, variant)
    run_s = time.time() - t0
    card, capacity = card_bytes()
    n_active = active_params(cfg)
    mf = rl.model_flops(cfg, shape, n_active)
    return {
        "arch": arch, "shape": shape_name, "variant": variant_name,
        "device": "meta", "card": card, "mode": shape.mode,
        "window_override": window_override_for(cfg, shape),
        "routes": routes(cfg, shape, variant), "run_s": round(run_s, 2),
        "memory": memory,
        "fits_one_card": memory["peak_estimate"] <= capacity, "card_bytes": capacity,
        "roofline": terms.to_dict(),
        "model_flops": mf, "active_params": n_active,
        "useful_flops_ratio": mf / terms.flops if terms.flops else 0.0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--variant", default="base", choices=sorted(VARIANTS))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch}__{shape_name}__1gpu"
            if args.variant != "base":
                tag += f"__{args.variant}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[skip] {tag}")
                continue
            t0 = time.time()
            try:
                res = run_combo(arch, shape_name, args.variant)
                with open(path, "w") as f:
                    json.dump(res, f, indent=2)
                rt = res["roofline"]
                print(f"[ok]   {tag} bottleneck={rt['bottleneck']} "
                      f"peak={res['memory']['peak_estimate'] / 2**30:.2f}GiB "
                      f"fits={res['fits_one_card']} wall={time.time() - t0:.0f}s",
                      flush=True)
            except Exception as e:
                failures.append((tag, repr(e)))
                with open(os.path.join(args.out, tag + ".FAIL"), "w") as f:
                    f.write(traceback.format_exc())
                print(f"[FAIL] {tag}: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e[:200])
        return 1
    print("\nall combos ran on the meta device")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
