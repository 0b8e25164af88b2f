#!/usr/bin/env python3
"""Time the serving kernels of two checkouts on one card, in turns.

    python3 scripts/serving_kernels_ab.py --a PARENT_CHECKOUT [--b CHECKOUT]
        [--variants JSON] [--profile] [--out FILE]
        [--set serving|scan_dw|fwd_dx|zoo_train|gqa_bits|bf16_scan_stats]

Each turn is a fresh process that puts one checkout's ``src/`` first on
``sys.path``, builds that checkout's ``masked_ffn`` and ``decode_gqa``
sources, and runs this checkout's ``chip_smoke.phase_kernels`` on them:
masked_ffn_batch and decode_gqa at the serve's decode shapes, each held to
its plain version, ``ms`` as device time on a cold cache, ``call_ms`` as
one call between two CUDA events, and SDPA's device time beside
decode_gqa. The turns run A, B, B, A, so that drift of the card shows.
``--profile`` adds, in each of those turns, the device time by kernel of
three full-width StableLM-2-12B decode steps (``chip_smoke.phase_profile``
on the ``step`` phase's state) and, in the B turns, masked_ffn_batch's
device time with calls rotating over two weight sets beside one set.
Every turn also gives each CUDA kernel's device time a call, from
torch.profiler over eager calls, and decode_gqa's and SDPA's device time
at the step lengths as the number of caches the calls rotate over grows.
``--variants`` is a JSON list of launch shapes for B alone, run after the
turns, e.g. ``[{"ts": 32}, {"ks": 8, "fs": 4}]``: ``ts`` the cache
positions a decode_gqa split takes, ``ks``/``fs`` the bf16
masked_ffn_batch's cluster sizes. One JSON line per turn,
then a summary line; ``--out`` also writes them all to a file. Needs one
CUDA device.

``--set scan_dw`` times two other kernels instead, the same way (A, B, B,
A, each held to its plain version): the chunked RWKV-6 scan
(rwkv_chunk_scan) at RWKV-6-3B's prefill shape (B 1, S 512, H 40, N 64,
chunk 128, bf16), at the model's decay and at logw = -8, and the masked-FFN
dW (masked_ffn_dw, fp32 gelu, the training path's masks) at femnist_attn's
M 490 and femnist_kernel's M 10, each at C 5 and 64; ``ms`` is device time
from a CUDA graph of calls, ``call_ms`` one call between two CUDA events,
and ``by_kernel`` each CUDA kernel's device time a call (torch.profiler).

``--set fwd_dx`` times the masked-FFN training forward
(masked_ffn_train_fwd) and dx (masked_ffn_dx) the same way (A, B, B, A,
each held to its plain version and to a second call's bits), fp32 gelu
under the training path's masks, at femnist_attn's M 490 (F 256) and
femnist_kernel's M 10 (F 1024), each at C 5 and 64, beside the launch
shape (``fwd_dx_launch_geometry``); ``--variants`` may set ``cover``
(blocks wanted per SM) for B.

``--set zoo_train`` times B1's training form, B2 and B3 at the zoo train
step's shape (C 1, M 1024, d 5120, F 13824, bf16, silu gated; StableLM-2-12B
at batch 4 x 256) under a layer mask of 81 of 108 blocks, the same way (A,
B, B, A; ``chip_smoke.zoo_kernel_times``: each held to its plain version,
``ms`` one call between two CUDA events, the median of 10), beside the
dense route's forward and backward, and each CUDA kernel's device time a
call (torch.profiler).

``--set bf16_scan_stats`` times B12's bf16 chunk form
(rwkv_chunk_scan_bf16, ``rwkv_out_bf16_kernel``) at RWKV-6-3B's prefill
shape (chip_smoke's RWKV_SCAN_SHAPE: B 1, S 512, H 40, N 64, chunk 128,
bf16) and B10 (invariant_stats) at chip_smoke's STATS_SHAPES (1024 x 1024
fp32 and bf16, 2560 x 8960 bf16) the same way (A, B, B, A), with B12's fp32
form (rwkv_chunk_scan, which shares the state pass) beside them: each held to
its plain version (RWKV_BF16_TOL; 1e-5 fp32 and 5e-2 bf16) and to a second
call's bits, ``ms`` device time from a CUDA graph of calls, ``call_ms`` one
call between two CUDA events, ``by_kernel`` each CUDA kernel's device time
a call (torch.profiler).

``--set gqa_bits`` checks that decode_gqa gives the same bits in both
checkouts at the group sizes G ∈ {1, 2, 4, 8} (fp32 and bf16, hd 64 and
128, C 300, 576 and 4096, ragged lengths; inputs drawn with numpy from
fixed seeds), and times each case; it exits 1 if any output differs.
"""
from __future__ import annotations

import argparse
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def summarise(rows):
    """Per kernel and case, the device and call times of the turn."""
    out = {}
    for r in rows:
        cases = r.get("mixes") or r.get("lengths")
        for case, v in cases.items():
            out[f"{r['name']}/{case}"] = {k: v.get(k) for k in (
                "ms", "call_ms", "library_ms", "library_call_ms", "plain_ms",
                "bound_ms", "rel_err")}
    return out


def by_kernel(torch, cs, run, n=10, watch=("rwkv", "dw")):
    """Device µs a call of each CUDA kernel that ``run`` launches (those
    whose names hold a string of ``watch``), from torch.profiler over n
    eager calls."""
    torch.cuda.synchronize()
    rows = cs.busy_share(torch, lambda: [run() for _ in range(n)], watch=watch)
    name = lambda k: re.search(r"(\w+_kernel\w*)", k).group(1) if "_kernel" in k else k[:60]
    return {name(r["kernel"]): r["us_per_call"] for r in rows.get("watched", [])}


def scan_dw(torch, np, cs):
    """Device and call times of rwkv_chunk_scan at the prefill shape and of
    masked_ffn_dw at (C, M) in {5, 64} x {490, 10}, each held to its plain
    version (relative ∞-norm 1e-4)."""
    from repro_torch.kernels import masked_ffn as ffn
    from repro_torch.kernels import rwkv_chunk as rwkv
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    B, S, H, N, c = (cs.RWKV_SCAN_SHAPE[k] for k in ("B", "S", "H", "N", "chunk"))
    r, k, v = (torch.randn(B, S, H, N, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    u = 0.1 * torch.randn(H, N, generator=g, device=dev)
    w = (torch.rand(H, N, generator=g, device=dev) * 5 - 6
         + 0.1 * torch.randn(B, S, H, N, generator=g, device=dev))
    for name, logw in (("model_decay", -torch.exp(w)), ("logw=-8", torch.full_like(w, -8.0))):
        run = lambda: rwkv.rwkv_chunk_scan(r, k, v, logw, u, chunk=c)
        (y, st), (yp, sp) = run(), rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=c)
        err = max(cs.rel_inf(y, yp), cs.rel_inf(st, sp))
        if not err <= 1e-4:
            raise SystemExit(f"rwkv_chunk_scan[{name}] rel err {err}")
        out[f"rwkv_chunk_scan/{name}"] = {"ms": cs.graph_ms(run, torch),
                                          "call_ms": cs.time_ms(run, torch), "rel_err": err,
                                          "by_kernel": by_kernel(torch, cs, run)}
    del r, k, v, u, w
    d = cs.TRAIN_SHAPE["d"]
    for C, (M, F) in itertools.product((5, 64), ((cs.ATTN_SHAPE["M"], cs.ATTN_SHAPE["F"]),
                                               (cs.TRAIN_SHAPE["M"], cs.TRAIN_SHAPE["F"]))):
        rnd = lambda *sh, fan: torch.randn(*sh, generator=g, device=dev) / fan ** 0.5
        x, gy = rnd(C, M, d, fan=1), rnd(C, M, d, fan=1)
        w_in, w_out = rnd(C, d, F, fan=d), rnd(C, F, d, fan=F)
        mask = cs.train_masks(torch, np, C, "main", dev, M, F)
        run = lambda: ffn.masked_ffn_dw(gy, x, w_in, w_out, mask, None, act="gelu")
        got, want = run(), ffn.masked_ffn_dw_plain(gy, x, w_in, w_out, mask, None, "gelu")
        err = max(cs.rel_inf(a, b) for a, b in zip(got, want) if b is not None)
        if not err <= 1e-4:
            raise SystemExit(f"masked_ffn_dw[C{C}/M{M}] rel err {err}")
        out[f"masked_ffn_dw/C{C}/M{M}"] = {
            "ms": cs.graph_ms(run, torch), "call_ms": cs.time_ms(run, torch), "rel_err": err,
            "by_kernel": by_kernel(torch, cs, run), "geometry": (ffn.dw_launch_geometry(C, M, d, F)
                         if hasattr(ffn, "dw_launch_geometry") else None)}
    return out


def fwd_dx(torch, np, cs, ffn):
    """Device and call times of masked_ffn_train_fwd and masked_ffn_dx (fp32
    gelu, ungated, the training path's "main" masks) at (C, M) in {5, 64} x
    {490, 10} (F 256 at M 490, 1024 at M 10, d 64), each held to its plain
    version (relative ∞-norm 1e-4), with the launch shape where the
    checkout has one."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    d = cs.TRAIN_SHAPE["d"]
    out = {}
    for C, (M, F) in itertools.product((5, 64), ((cs.ATTN_SHAPE["M"], cs.ATTN_SHAPE["F"]),
                                               (cs.TRAIN_SHAPE["M"], cs.TRAIN_SHAPE["F"]))):
        rnd = lambda *sh, fan: torch.randn(*sh, generator=g, device=dev) / fan ** 0.5
        x, gy = rnd(C, M, d, fan=1), rnd(C, M, d, fan=1)
        w_in, w_out = rnd(C, d, F, fan=d), rnd(C, F, d, fan=F)
        mask = cs.train_masks(torch, np, C, "main", dev, M, F)
        geo = (ffn.fwd_dx_launch_geometry(C, M, d, F) if hasattr(ffn, "fwd_dx_launch_geometry")
               else None)
        for name, run, plain in (
                ("masked_ffn_train_fwd",
                 lambda: ffn.masked_ffn_train_fwd(x, w_in, w_out, mask, None, act="gelu"),
                 lambda: ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, None, "gelu")),
                ("masked_ffn_dx",
                 lambda: ffn.masked_ffn_dx(gy, x, w_in, w_out, mask, None, act="gelu"),
                 lambda: ffn.masked_ffn_dx_plain(gy, x, w_in, w_out, mask, None, "gelu"))):
            got, again, want = run(), run(), plain()
            torch.cuda.synchronize()
            err = cs.rel_inf(got, want)
            if not err <= 1e-4:
                raise SystemExit(f"{name}[C{C}/M{M}] rel err {err}")
            if not torch.equal(got, again):
                raise SystemExit(f"{name}[C{C}/M{M}] two calls differ")
            out[f"{name}/C{C}/M{M}"] = {
                "ms": cs.graph_ms(run, torch), "call_ms": cs.time_ms(run, torch),
                "rel_err": err, "geometry": geo,
                "by_kernel": by_kernel(torch, cs, run, watch=("train_", "reduce"))}
    return out


def zoo_train(torch, np, cs):
    """chip_smoke.zoo_kernel_times at StableLM-2-12B's FFN under a fixed
    mask of 81 of its 108 blocks (B1-B3, the dense route's forward and
    backward, and a kernel step's layer: the forward twice, dx and dW), and
    the device µs a call of each kernel under B1-B3 from one profiled call
    each."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import masked_ffn as ffn
    dev = torch.device("cuda")
    cfg = get_config(cs.ZOO_TRAIN["arch"])
    nb = cfg.d_ff // 128
    keep = np.zeros(nb, np.float32)
    keep[np.random.RandomState(0).choice(nb, round(nb * 0.75), replace=False)] = 1
    mask = torch.from_numpy(np.repeat(keep, 128)).to(dev)
    times = cs.zoo_kernel_times(torch, cfg, mask, dev)
    out = {k: times[k] for k in cs.TRAIN_KERNELS}
    out["dense_forward_backward"] = {"ms": times["dense_forward_backward_ms"],
                                     "forward_ms": times["dense_forward_ms"]}
    out["kernel_layer"] = {"ms": times["kernel_layer_ms"], "shape": times["shape"],
                           "kept_blocks": times["kept_blocks"]}
    M, d, F = times["shape"]["M"], times["shape"]["d"], times["shape"]["F"]
    g = torch.Generator(device=dev).manual_seed(9)
    r = lambda *sh: torch.randn(*sh, generator=g, device=dev).to(torch.bfloat16)
    x, gy = r(1, M, d), r(1, M, d)
    w_in, w_gate, w_out = r(1, d, F), r(1, d, F), r(1, F, d)
    row = mask.expand(1, M, F).contiguous()
    for name, run in (
            ("masked_ffn_train_fwd", lambda: ffn.masked_ffn_train_fwd(x, w_in, w_out, row, w_gate, act="silu")),
            ("masked_ffn_dx", lambda: ffn.masked_ffn_dx(gy, x, w_in, w_out, row, w_gate, act="silu")),
            ("masked_ffn_dw", lambda: ffn.masked_ffn_dw(gy, x, w_in, w_out, row, w_gate, act="silu"))):
        out[name]["by_kernel"] = by_kernel(torch, cs, run, n=1, watch=("train_",))
    return out


GQA_BITS_CASES = [(dt, G, hd, C) for dt in ("float32", "bfloat16") for G in (1, 2, 4, 8)
                  for hd in (64, 128) for C in (300, 576, 4096)]


def gqa_bits(torch, np, cs, gqa):
    """sha256 of decode_gqa's output bytes, and its device time, at each
    of GQA_BITS_CASES: B 8, KV 2 (8 at the serve's shape), lengths from
    numpy (first 1, last C)."""
    import hashlib
    dev = torch.device("cuda")
    out = {}
    for dt, G, hd, C in GQA_BITS_CASES:
        KV = 8 if (G, hd, C) == (4, 128, 576) else 2
        B = 8
        rng = np.random.RandomState(G * 1000 + hd + C)
        mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
            dev, getattr(torch, dt))
        q, k, v = mk(B, KV * G, hd), mk(B, C, KV, hd), mk(B, C, KV, hd)
        lens = rng.randint(1, C + 1, B)
        lens[0], lens[-1] = 1, C
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        y = gqa.decode_gqa(q, k, v, lengths)
        torch.cuda.synchronize()
        raw = y.view(torch.int16 if dt == "bfloat16" else torch.int32).cpu().numpy().tobytes()
        out[f"{dt}/G{G}/hd{hd}/C{C}"] = {
            "digest": hashlib.sha256(raw).hexdigest()[:16],
            "ms": cs.graph_ms(lambda: gqa.decode_gqa(q, k, v, lengths), torch)}
    return out


def bf16_scan_stats(torch, np, cs):
    """Device and call times of rwkv_chunk_scan_bf16 at RWKV_SCAN_SHAPE
    (inputs drawn as chip_smoke's kernels phase draws them) and of
    invariant_stats at STATS_SHAPES, each held to its plain version and to a
    second call's bits."""
    from repro_torch.kernels import invariant_stats as stats
    from repro_torch.kernels import rwkv_chunk as rwkv
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    B, S, H, N, c = (cs.RWKV_SCAN_SHAPE[k] for k in ("B", "S", "H", "N", "chunk"))
    r, k, v = (torch.randn(B, S, H, N, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    u = 0.1 * torch.randn(H, N, generator=g, device=dev)
    logw = -torch.exp(torch.rand(H, N, generator=g, device=dev) * 5 - 6
                      + 0.1 * torch.randn(B, S, H, N, generator=g, device=dev))
    run = lambda: rwkv.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=c)
    (y, st), (y2, st2) = run(), run()
    yp, sp = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=c, chunk_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    errs = {"rel2": cs.rel2(y, yp), "inf": cs.rel_inf(y, yp), "state": cs.rel_inf(st, sp)}
    if not all(errs[key] <= tol for key, tol in cs.RWKV_BF16_TOL.items()):
        raise SystemExit(f"rwkv_chunk_scan_bf16 vs its plain form {errs}")
    if not (torch.equal(y, y2) and torch.equal(st, st2)):
        raise SystemExit("rwkv_chunk_scan_bf16: two calls differ")
    out["rwkv_chunk_scan_bf16"] = {"ms": cs.graph_ms(run, torch), "call_ms": cs.time_ms(run, torch),
                                   "rel_err": errs, "by_kernel": by_kernel(torch, cs, run)}
    run = lambda: rwkv.rwkv_chunk_scan(r, k, v, logw, u, chunk=c)   # the fp32 form: the same state pass
    out["rwkv_chunk_scan"] = {"ms": cs.graph_ms(run, torch), "call_ms": cs.time_ms(run, torch),
                              "by_kernel": by_kernel(torch, cs, run)}
    del r, k, v, u, logw
    for d_in, n, dt in cs.STATS_SHAPES:
        dtype = getattr(torch, dt)
        w0 = torch.randn(d_in, n, generator=g, device=dev)
        w1 = (w0 + 0.02 * torch.randn(d_in, n, generator=g, device=dev)).to(dtype)
        w0 = w0.to(dtype)
        run = lambda: stats.invariant_stats(w0, w1)
        got, again = run(), run()
        err = cs.rel_inf(got, stats.invariant_stats_plain(w0, w1))
        if not err <= (1e-5 if dtype == torch.float32 else 5e-2):
            raise SystemExit(f"invariant_stats[{d_in}x{n}/{dt}] rel err {err}")
        if not torch.equal(got, again):
            raise SystemExit(f"invariant_stats[{d_in}x{n}/{dt}]: two calls differ")
        out[f"invariant_stats/{d_in}x{n}/{dt}"] = {
            "ms": cs.graph_ms(run, torch), "call_ms": cs.time_ms(run, torch), "rel_err": err,
            "by_kernel": by_kernel(torch, cs, run, watch=("stats",))}
    return out


def child(src: str, tune: dict, profile: bool, rotate_ffn: bool, which: str) -> dict:
    checkout = str(Path(src).resolve() / "src")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke as cs
    # chip_smoke puts this checkout's src/ first and imports repro_torch when
    # it is imported: the turn's checkout goes first again, its own package
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path[:] = [x for x in sys.path if x != str(ROOT / "src")]
    sys.path.insert(0, checkout)
    from repro_torch.kernels import _build
    if Path(_build.__file__).resolve().parents[2] != Path(checkout):
        raise SystemExit(f"serving_kernels_ab: imported {_build.__file__}, not {checkout}")
    from repro_torch.kernels import decode_gqa as gqa
    from repro_torch.kernels import masked_ffn as ffn
    if not torch.cuda.is_available():
        raise SystemExit("serving_kernels_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if which == "scan_dw":
        t0 = time.perf_counter()
        _build.build_all(["rwkv_chunk", "masked_ffn_train"])
        return {"src": src, "tune": tune, "build_s": time.perf_counter() - t0,
                "kernels": scan_dw(torch, np, cs)}
    # the training forward's and dx's sources: masked_ffn_train, and where the
    # checkout has it the tensor-core route's masked_ffn_train_tc
    train_srcs = [n for n in _build.sources() if n.startswith("masked_ffn_train")]
    if which == "zoo_train":
        t0 = time.perf_counter()
        _build.build_all(train_srcs)
        return {"src": src, "tune": tune, "build_s": time.perf_counter() - t0,
                "ptxas": [ln for name in train_srcs
                          for ln in _build.build_log.get(name, "").splitlines()
                          if "registers" in ln or "spill" in ln],
                "kernels": zoo_train(torch, np, cs)}
    if which == "bf16_scan_stats":
        t0 = time.perf_counter()
        _build.build_all(["rwkv_chunk", "invariant_stats"])
        return {"src": src, "tune": tune, "build_s": time.perf_counter() - t0,
                "ptxas": [ln for name in ("rwkv_chunk", "invariant_stats")
                          for ln in _build.build_log.get(name, "").splitlines()
                          if "registers" in ln or "spill" in ln],
                "kernels": bf16_scan_stats(torch, np, cs)}
    if which == "gqa_bits":
        t0 = time.perf_counter()
        _build.build_all(["decode_gqa"])
        return {"src": src, "tune": tune, "build_s": time.perf_counter() - t0,
                "kernels": gqa_bits(torch, np, cs, gqa)}
    if which == "fwd_dx":
        if "cover" in tune:
            ffn.FD_COVER = tune["cover"]
        t0 = time.perf_counter()
        _build.build_all(train_srcs)
        return {"src": src, "tune": tune, "build_s": time.perf_counter() - t0,
                "ptxas": [ln for name in train_srcs
                          for ln in _build.build_log.get(name, "").splitlines()
                          if "registers" in ln or "spill" in ln],
                "kernels": fwd_dx(torch, np, cs, ffn)}
    if "ts" in tune:
        gqa.split_len = lambda *a: tune["ts"]
    if {"ks", "fs"} & set(tune):
        base = ffn.ffn_geometry

        def geometry(M, d, F, n_sm):
            ks, fs = base(M, d, F, n_sm)
            return tune.get("ks", ks), tune.get("fs", fs)
        ffn.ffn_geometry = geometry
    t0 = time.perf_counter()
    _build.build_all(["masked_ffn", "decode_gqa"])
    res = {"src": src, "tune": tune, "build_s": time.perf_counter() - t0,
           "kernels": summarise(cs.phase_kernels(torch, np))}
    res["kernel_times"] = kernel_times(torch, np, cs, gqa, ffn)
    res["gqa_rotation"] = gqa_rotation(torch, np, cs, gqa)
    if rotate_ffn:
        res["ffn_rotation"] = ffn_rotation(torch, cs, ffn)
    if profile:
        from repro_torch.configs import get_config
        from repro_torch.models import model
        cfg = get_config("stablelm-12b")
        params = model.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
        caches, tok, pos, masks, _ = cs.step_state(torch, np, params, cfg)
        res["profile"] = cs.phase_profile(torch, params, cfg, (caches, tok, pos, masks))
    return res


def kernel_times(torch, np, cs, gqa, ffn):
    """Device µs a call of each CUDA kernel under decode_gqa (the step
    lengths, rotating caches) and masked_ffn_batch (the mixed tile), from
    torch.profiler over eager calls."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    B, H, KV, hd, C = (cs.GQA_SHAPE[k] for k in ("B", "H", "KV", "hd", "C"))
    q = torch.randn(B, H, hd, device=dev).to(bf)
    caches = [(torch.randn(B, C, KV, hd, device=dev).to(bf),
               torch.randn(B, C, KV, hd, device=dev).to(bf)) for _ in range(cs.GQA_ROTATIONS)]
    lengths = torch.tensor(cs.gqa_length_sets(np, B, C)["step"], dtype=torch.int32, device=dev)
    M, d, F = (cs.FFN_SHAPE[k] for k in ("M", "d", "F"))
    x, w_in = torch.randn(M, d, device=dev).to(bf), torch.randn(d, F, device=dev).to(bf)
    w_gate, w_out = torch.randn(d, F, device=dev).to(bf), torch.randn(F, d, device=dev).to(bf)
    mask = cs.ffn_mixes(torch, M, F, dev)["mixed1.0/0.5/0.25"]

    def calls():
        for kv in caches:
            gqa.decode_gqa(q, *kv, lengths)
        for _ in range(5):
            ffn.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate)
    calls()
    torch.cuda.synchronize()
    return cs.busy_share(torch, calls, watch=("gqa", "ffn"))["watched"]


def gqa_rotation(torch, np, cs, gqa):
    """decode_gqa's and SDPA's device time a call at the step lengths, with
    calls rotating over 1, 2, 4, 8 and GQA_ROTATIONS distinct caches of
    18.9 MB: how the time grows as the cache goes cold."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    B, H, KV, hd, C = (cs.GQA_SHAPE[k] for k in ("B", "H", "KV", "hd", "C"))
    q = torch.randn(B, H, hd, device=dev).to(bf)
    caches = [(torch.randn(B, C, KV, hd, device=dev).to(bf),
               torch.randn(B, C, KV, hd, device=dev).to(bf)) for _ in range(cs.GQA_ROTATIONS)]
    caches_t = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
                for k, v in caches]
    lengths = torch.tensor(cs.gqa_length_sets(np, B, C)["step"], dtype=torch.int32, device=dev)
    amask = (torch.arange(C, device=dev)[None, :] < lengths[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for r in (1, 2, 4, 8, cs.GQA_ROTATIONS):
        kern = cs.rotating([lambda kv=kv: gqa.decode_gqa(q, *kv, lengths) for kv in caches[:r]])
        lib = cs.rotating([lambda kv=kv: sdpa(q[:, :, None], *kv, attn_mask=amask,
                                              enable_gqa=True) for kv in caches_t[:r]])
        n = cs.GQA_ROTATIONS
        out[r] = {"ms": cs.graph_ms(kern, torch, n=n), "library_ms": cs.graph_ms(lib, torch, n=n)}
    return out


def ffn_rotation(torch, cs, ffn):
    """masked_ffn_batch's device time on the mixed tile with one weight set,
    and with calls alternating between two sets (850 MB)."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    M, d, F = (cs.FFN_SHAPE[k] for k in ("M", "d", "F"))
    rnd = lambda *s, fan: (torch.randn(*s, generator=g, device=dev) / fan ** 0.5).to(bf)
    x = rnd(M, d, fan=1)
    sets = [(rnd(d, F, fan=d), rnd(F, d, fan=F), rnd(d, F, fan=d)) for _ in range(2)]
    mask = cs.ffn_mixes(torch, M, F, dev)["mixed1.0/0.5/0.25"]
    calls = [lambda w=w: ffn.masked_ffn_batch(x, w[0], w[1], mask, w_gate=w[2], act="silu")
             for w in sets]
    return {"one_set_ms": cs.graph_ms(calls[0], torch),
            "two_sets_ms": cs.graph_ms(cs.rotating(calls), torch)}


def run_turn(src, tune=None, profile=False, rotate_ffn=False, which="serving", timeout=900):
    cmd = [sys.executable, __file__, "--child", str(src), "--tune", json.dumps(tune or {}),
           "--set", which]
    cmd += ["--profile"] * profile + ["--rotate-ffn"] * rotate_ffn
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise SystemExit(f"turn {src} {tune} failed ({proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="checkout A (the parent)")
    ap.add_argument("--b", default=str(ROOT), help="checkout B (default: this one)")
    ap.add_argument("--variants", default="[]", help="JSON list of B's launch shapes")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--set", default="serving",
                    choices=("serving", "scan_dw", "fwd_dx", "zoo_train", "gqa_bits",
                             "bf16_scan_stats"),
                    help="the kernels to time")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--tune", default="{}", help=argparse.SUPPRESS)
    ap.add_argument("--rotate-ffn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, json.loads(args.tune), args.profile,
                               args.rotate_ffn, args.set)))
        return 0
    turns = []
    order = [("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)] if args.a else []
    for label, src in order:
        turns.append({"turn": label, **run_turn(src, profile=args.profile,
                                                rotate_ffn=args.profile and label == "B",
                                                which=args.set)})
        print(json.dumps(turns[-1]), flush=True)
    for tune in json.loads(args.variants):
        turns.append({"turn": "B", **run_turn(args.b, tune, which=args.set)})
        print(json.dumps(turns[-1]), flush=True)
    summary = {}
    for t in turns:
        key = f"{t['turn']}{'' if not t['tune'] else json.dumps(t['tune'])}"
        for case, v in t["kernels"].items():
            summary.setdefault(key, {}).setdefault(case, []).append(v["ms"])
    line = {"summary_device_ms": summary}
    if args.set == "gqa_bits":
        digests = {json.dumps({c: v["digest"] for c, v in t["kernels"].items()},
                              sort_keys=True) for t in turns}
        line["bitwise_equal"] = len(digests) == 1
    print(json.dumps(line))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(t) for t in turns + [line]) + "\n")
    return 0 if line.get("bitwise_equal", True) else 1


if __name__ == "__main__":
    sys.exit(main())
