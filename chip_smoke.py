#!/usr/bin/env python3
"""Prove the PyTorch port runs on one NVIDIA GPU: build its CUDA kernels,
hold each against its plain PyTorch version at the serving path's shapes,
serve StableLM-2-12B at full width through ``repro_torch``, and check the
result.

    python3 chip_smoke.py

Run from the root of a checkout. Phases print one JSON line each (env,
build, kernels, small, serve, step, profile); any failure exits non-zero. The last
three lines are the per-kernel summary, the card's name and power limit as
nvidia-smi gives them, and {"ok": true, "device": {...}}. Without a CUDA
device, or without the repo beside this script, it exits 2 and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense tensor-core peak, bf16
FFN_SHAPE = dict(M=8, d=5120, F=13824)
GQA_SHAPE = dict(B=8, H=32, KV=8, hd=128, C=576)
N_TIMED = 25


class SmokeFailure(Exception):
    pass


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def time_ms(fn, torch, n=N_TIMED, warmup=3):
    """Median of n single-call CUDA-event timings, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def rel_inf(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------

def phase_kernels(torch, np):
    from repro_torch.core.dropout import keep_count
    from repro_torch.kernels import decode_gqa as gqa
    from repro_torch.kernels import masked_ffn as ffn
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    out = []

    # masked_ffn_batch at the decode shape: 8 slots, SwiGLU, bf16
    M, d, F = FFN_SHAPE["M"], FFN_SHAPE["d"], FFN_SHAPE["F"]
    rnd = lambda *s, fan: (torch.randn(*s, generator=g, device=dev)
                           / fan ** 0.5).to(bf)
    x = rnd(M, d, fan=1)
    w_in, w_gate, w_out = rnd(d, F, fan=d), rnd(d, F, fan=d), rnd(F, d, fan=F)

    def ordered(rates):
        m = torch.zeros(M, F, device=dev)
        for i, r in enumerate(rates):
            m[i, :keep_count(F, r)] = 1.0 if r > 0 else 0.0
        return m
    cyc = [(1.0, 0.5, 0.25)[i % 3] for i in range(M)]
    mixes = {"rate1.0": ordered([1.0] * M), "rate0.5": ordered([0.5] * M),
             "mixed1.0/0.5/0.25": ordered(cyc),
             "mixed+dropped_row": ordered(cyc[:-1] + [0.0])}
    per_mix = {}
    for name, mask in mixes.items():
        run = lambda: ffn.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate,
                                           act="silu")
        got = run()
        want = ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, "silu")
        torch.cuda.synchronize()
        err = rel_inf(got, want)
        dropped = mask.sum(1) == 0
        check(err <= 1e-2, f"masked_ffn_batch[{name}] rel err {err}")
        check(bool((got[dropped] == 0).all()),
              f"masked_ffn_batch[{name}] dropped row not exactly 0")
        kept_blocks = int((mask.view(M, F // 128, 128).amax((0, 2)) > 0).sum())
        fk = kept_blocks * 128
        nbytes = 3 * d * fk * 2 + M * d * 2 * 2 + M * F * 4
        b_ms, b_by = bound_ms(nbytes, 2 * 3 * M * d * fk)
        per_mix[name] = {
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "rel_err": err, "kept_blocks": kept_blocks,
            "ms": time_ms(run, torch),
            "plain_ms": time_ms(lambda: ffn.masked_ffn_batch_plain(
                x, w_in, w_out, mask, w_gate, "silu"), torch, n=20),
            "bound_ms": b_ms, "bound_by": b_by}
    head = per_mix["mixed1.0/0.5/0.25"]
    out.append({"name": "masked_ffn_batch", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/masked_ffn.cu",
                "replaces": "src/repro/kernels/masked_ffn.py:107",
                "max_abs_err": max(v["max_abs_err"] for v in per_mix.values()),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": None, "shape": FFN_SHAPE, "mixes": per_mix})
    del x, w_in, w_gate, w_out, mixes

    # decode_gqa at the decode shape, ragged lengths
    B, H, KV, hd, C = (GQA_SHAPE[k] for k in ("B", "H", "KV", "hd", "C"))
    q = torch.randn(B, H, hd, generator=g, device=dev).to(bf)
    k = torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf)
    v = torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf)
    lens_np = np.random.RandomState(1).randint(1, C + 1, B)
    lens_np[0], lens_np[-1] = 1, C
    lengths = torch.tensor(lens_np, dtype=torch.int32, device=dev)
    run = lambda: gqa.decode_gqa(q, k, v, lengths)
    got = run()
    want = gqa.decode_gqa_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    err = rel_inf(got, want)
    check(err <= 1e-2, f"decode_gqa rel err {err}")
    # library yardstick: one SDPA call over the same cache, never used by the port
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    q4 = q[:, :, None]
    amask = (torch.arange(C, device=dev)[None, :] < lengths[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q4, kt, vt, attn_mask=amask, enable_gqa=True)
    lib_err = rel_inf(lib()[:, :, 0], want)
    check(lib_err <= 1e-2, f"decode_gqa library yardstick disagrees: {lib_err}")
    n_valid = int(lens_np.sum())
    nbytes = 2 * n_valid * KV * hd * 2 + 2 * B * H * hd * 2 + B * 4
    b_ms, b_by = bound_ms(nbytes, 4 * n_valid * H * hd)
    out.append({"name": "decode_gqa", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_gqa.cu",
                "replaces": "src/repro/kernels/decode_gqa.py:21",
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "rel_err": err, "ms": time_ms(run, torch),
                "plain_ms": time_ms(lambda: gqa.decode_gqa_plain(q, k, v, lengths),
                                    torch),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lib, torch),
                "library_call": "scaled_dot_product_attention(enable_gqa=True)",
                "shape": GQA_SHAPE, "lengths": lens_np.tolist()})
    return out


def swap_in_plain(ops):
    """Point the model's kernel calls at the plain versions; returns undo."""
    from repro_torch.kernels import decode_gqa as gqa
    from repro_torch.kernels import masked_ffn as ffn
    saved = ops.masked_ffn_batch, ops.decode_gqa
    ops.masked_ffn_batch = lambda x, wi, wo, m, w_gate=None, act="silu": \
        ffn.masked_ffn_batch_plain(x, wi, wo, m, w_gate, act)
    ops.decode_gqa = gqa.decode_gqa_plain

    def undo():
        ops.masked_ffn_batch, ops.decode_gqa = saved
    return undo


def phase_small(torch, np):
    """Smoke-size fp32 model: two decode steps on the card (kernels) and on
    the CPU (plain versions) from the same params, logits within 1e-3."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serving import rate_masks
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config("stablelm-12b").smoke(), dtype="float32")
    cpu = model.init_params(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    B, S = 3, 12
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (B, S)))
    masks = tree_map(lambda m: m[:, None, None, :].expand(-1, B, 1, -1).contiguous(),
                     rate_masks(cfg, 0.5, policy="random", seed=1))
    errs = []
    res = {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        _, caches, _ = model.forward_seq(params, cfg, {"tokens": toks.to(dev)},
                                         want_cache=True, cache_len=S + 2)
        tok, pos = toks[:, -1:].to(dev), torch.full((B,), S, device=dev)
        steps = []
        for _ in range(2):
            logits, caches = model.decode_step(params, cfg, caches, tok, pos,
                                               masks=tree_map(lambda m: m.to(dev), masks))
            steps.append(logits.float().cpu())
            tok, pos = torch.argmax(logits[:, -1], -1)[:, None], pos + 1
        res[name] = steps
    for a, b in zip(res["cpu"], res["cuda"]):
        check(bool(torch.isfinite(b).all()), "small: non-finite logits")
        errs.append(float((a - b).abs().max()))
    check(max(errs) <= 1e-3, f"small: cuda vs cpu logits differ by {max(errs)}")
    return {"max_abs_err": max(errs)}


def phase_serve(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    from repro_torch.models import model
    cfg = get_config("stablelm-12b")
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()                  # main path starts here
    t0 = time.perf_counter()
    results, summ = serve_engine(cfg, batch=8, prompt_len=512, gen_len=64,
                                 n_requests=24, rates=(1.0, 0.5, 0.25), seed=0,
                                 device="cuda", params=params)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()               # main path ends here

    steps = summ["decode_steps"]
    check(len(results) == 24, f"serve: {len(results)} of 24 requests finished")
    rng = np.random.RandomState(0)             # serve_engine's draws, replayed
    for rid in range(24):
        L = rng.randint(256, 513)
        rng.randint(0, 256, (L,), dtype=np.int32)
        g = int(rng.randint(32, 65))
        toks = results[rid]
        check(len(toks) == g, f"serve: request {rid} has {len(toks)} of {g} tokens")
        check(bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
              f"serve: request {rid} has out-of-vocab tokens")
    for name, n in counts.items():
        check(n == cfg.n_layers * steps,
              f"serve: {name} launched {n} times, expected {cfg.n_layers} x {steps}")
    out = {"params": n_params, "init_s": init_s, "wall_s": wall_s,
           "prefill_s": summ["prefill_s"], "decode_s": summ["decode_s"],
           "decode_steps": steps, "decode_tokens": summ["decode_tokens"],
           "decode_tok_per_s": summ["tok_per_s"],
           "decode_ms_per_step": 1e3 * summ["decode_s"] / max(steps, 1),
           "prefills": summ["prefills"],
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts}
    return out, counts, params, cfg


def hold_each_launch(ops, worst):
    """Wrap the model's kernel calls so that each launch is also computed by
    its plain version on the same inputs; ``worst`` collects the largest
    relative error per kernel. Returns undo."""
    from repro_torch.kernels import decode_gqa as gqa
    from repro_torch.kernels import masked_ffn as ffn
    saved = ops.masked_ffn_batch, ops.decode_gqa

    def ffn_both(x, wi, wo, m, w_gate=None, act="silu"):
        y = saved[0](x, wi, wo, m, w_gate=w_gate, act=act)
        ref = ffn.masked_ffn_batch_plain(x, wi, wo, m, w_gate, act)
        worst["masked_ffn_batch"] = max(worst["masked_ffn_batch"], rel_inf(y, ref))
        check(bool((y[m.sum(1) == 0] == 0).all()), "step: dropped row not 0")
        return y

    def gqa_both(q, k, v, lengths):
        y = saved[1](q, k, v, lengths)
        worst["decode_gqa"] = max(worst["decode_gqa"],
                                  rel_inf(y, gqa.decode_gqa_plain(q, k, v, lengths)))
        return y
    ops.masked_ffn_batch, ops.decode_gqa = ffn_both, gqa_both

    def undo():
        ops.masked_ffn_batch, ops.decode_gqa = saved
    return undo


def phase_step(torch, np, params, cfg):
    """One full-width decode step from a real prefill. Every kernel launch
    in it is held against its plain version on the same inputs (relative
    ∞-norm <= 1e-2); then the whole step is rerun with the plain versions
    swapped in. End to end the two differ by bf16 rounding compounded over
    40 layers: relative 2-norm <= 2e-2 is required, the ∞-norm is reported."""
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch.serving import rate_masks
    from repro_torch.models import layers, model
    B, S, C = 8, 256, 576
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (B, S))).cuda()
    _, caches, _ = model.forward_seq(params, cfg, {"tokens": toks},
                                     want_cache=True, cache_len=C)
    rates = [(1.0, 0.5, 0.25)[i % 3] for i in range(B - 1)] + [0.0]
    rows = [rate_masks(cfg, r) if r > 0 else tree_map(torch.zeros_like,
                                                      rate_masks(cfg, 1.0))
            for r in rates]
    masks = tree_map(lambda *ms: torch.stack(ms, 1)[:, :, None].cuda(), *rows)
    pos = torch.tensor([S - 16 * i for i in range(B)], device="cuda")
    tok = toks[torch.arange(B, device="cuda"), pos - 1][:, None]
    worst = {"masked_ffn_batch": 0.0, "decode_gqa": 0.0}
    undo = hold_each_launch(ops, worst)
    try:
        hk = model.decode_hidden(params, cfg, caches, tok, pos, masks=masks)
    finally:
        undo()
    lk = layers.lm_logits(params["tok"], hk, cfg)
    undo = swap_in_plain(ops)
    try:
        hp = model.decode_hidden(params, cfg, caches, tok, pos, masks=masks)
        lp = layers.lm_logits(params["tok"], hp, cfg)
    finally:
        undo()
    torch.cuda.synchronize()
    rel2 = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    out = {"per_launch_rel_err": worst,
           "hidden_rel_err_inf": rel_inf(hk, hp), "logits_rel_err_inf": rel_inf(lk, lp),
           "hidden_rel_err_2": rel2(hk, hp), "logits_rel_err_2": rel2(lk, lp),
           "greedy_agreement": float((lk.argmax(-1) == lp.argmax(-1)).float().mean()),
           "positions": pos.tolist(), "rates": rates}
    check(bool(torch.isfinite(lk).all()), "step: non-finite logits")
    check(max(worst.values()) <= 1e-2, f"step: per-launch kernel vs plain {worst}")
    check(out["hidden_rel_err_2"] <= 2e-2 and out["logits_rel_err_2"] <= 2e-2,
          f"step: kernel vs plain step {out}")
    return out, (caches, tok, pos, masks)


def phase_profile(torch, params, cfg, state, steps=3):
    """Device time by kernel over a few full-width decode steps (the step
    phase's state), and the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model
    caches, tok, pos, masks = state
    model.decode_step(params, cfg, caches, tok, pos, masks=masks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step(params, cfg, caches, tok, pos, masks=masks)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in kern)
    kern.sort(key=lambda e: -e.self_device_time_total)
    top = [{"kernel": e.key[:90], "calls_per_step": e.count / steps,
            "ms_per_step": e.self_device_time_total / steps / 1e3}
           for e in kern[:12]]
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": dev_us / steps / 1e3,
            "device_busy_share": dev_us / wall_us, "top": top}


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch "
              "not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    try:
        smi = nvidia_smi()
        emit("env", torch=torch.__version__, cuda=torch.version.cuda,
             python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), nvidia_smi=smi)
        t0 = time.perf_counter()
        built = _build.build_all()
        ptxas = {n: [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
                 for n, log in _build.build_log.items()}
        emit("build", seconds=time.perf_counter() - t0, per_source=built,
             ptxas=ptxas)
        kernels = phase_kernels(torch, np)
        emit("kernels", kernels=kernels)
        emit("small", **phase_small(torch, np))
        serve, counts, params, cfg = phase_serve(torch, np)
        emit("serve", **serve)
        step, state = phase_step(torch, np, params, cfg)
        emit("step", **step)
        emit("profile", **phase_profile(torch, params, cfg, state))
    except SmokeFailure as e:
        emit("failed", error=str(e))
        return 1
    summary = [{k: v for k, v in kern.items()
                if k not in ("mixes", "shape", "lengths", "rel_err", "library_call")}
               | {"launches": counts[kern["name"]]} for kern in kernels]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
