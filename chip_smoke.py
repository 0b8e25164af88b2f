#!/usr/bin/env python3
"""Prove the PyTorch port runs on one NVIDIA GPU: build its CUDA kernels,
hold each against its plain PyTorch version at its path's shapes, serve
StableLM-2-12B, RWKV-6-3B, MiniCPM3-4B, RecurrentGemma-9B and
Command-R-35B at full width, take a held decode step of Granite-20B,
serve DeepSeek-V2-Lite-16B, Arctic-480B (2 of its 35 layers) and
SeamlessM4T-Large v2 at full width through the reference's static-batch
``serve``, train StableLM-2-12B at full width (8 of its 40 layers) with
its masked FFN through the training kernels, run FLuID training on both
kernel workloads and on the paper's own workloads through ``repro_torch``,
run the example twins and the paper's experiment drivers,
hold the meta-device dry-run against the card's own counts, train
RWKV-6-3B at full width (2 of its 32 layers) against the CPU, run
repro_torch.analysis's contracts on the card (the dropped-dW NaN poison
through B1-B9 at every zoo width, host-sync regions, mask-as-data), and
check the results.

    python3 chip_smoke.py

Run from the root of a checkout. Phases print one JSON line each, with
the seconds the phase took (``phase_s``):

  env        torch, CUDA, the card and its power limit
  build      one nvcc per kernel source, all at once
  kernels    each kernel against its plain version, timed beside its bound
             and, where one exists, a library call: the serving forms at
             the decode shapes (two calls bitwise equal; ``ms`` device time
             from a CUDA graph, decode_gqa and SDPA on caches rotated out of
             the L2, at three sets of lengths; ``call_ms`` one call between
             two CUDA events); the masked-FFN training forms at the
             fleet's (C 5 and 64 clients, M 10, d 64, F 1024) and at
             femnist_attn's FFN (C 5 and 64, M 490, F 256; the dW twice,
             bitwise equal), and the block-masked
             entry ops.masked_ffn forward and backward; the six head-masked
             projection kernels at femnist_attn's (C 5 and 64, M 490,
             d 64, 4 heads of 16; also at M 1100, 9 m-tiles, and at width
             256, C 2, M 300, 4 heads of 64; each twice on the same
             inputs, bitwise equal); the chunked RWKV-6 scan at
             RWKV-6-3B's prefill shape (B 1, S 512, H 40, N 64, chunk
             128), also at logw = -8 and chunk 256 (each twice, bitwise
             equal; ``ms`` device time from a CUDA graph), and its bf16
             chunk form (rwkv_chunk_scan_bf16, the dry-run's
             rwkv_c128_bf16) at the same shape against its plain form
             (relative 2-norm 5e-4, ∞-norm 1e-2); invariant_stats
             at 1024 x 1024 fp32 and bf16 and at a 2560 x 8960 bf16
             channel-mix w_in (it is on no main path: its launches are
             those of its checks here); then the two serving kernels at
             the zoo's decode shapes: masked_ffn_batch at MiniCPM3-4B's
             (d 2560, F 6400, silu), RecurrentGemma-9B's (4096, 12288,
             gelu gated) and Command-R-35B's (8192, 22528, silu) under the
             same four masks, decode_gqa at Command-R's (64/8 heads),
             Granite-20B's (48/1, virtual head groups), SeamlessM4T's
             decoder (16/16 heads of 64) and Arctic-480B's (56/8: 7
             virtual groups of 1) on caches rotated out of the L2 (the
             "zoo" entry of each kernel's row)
  small      smoke-size fp32 models, card vs CPU: StableLM, MiniCPM3
             (baseline and absorbed MLA decode), RecurrentGemma (past its
             64-slot window, so the ring wraps), Command-R, Granite,
             DeepSeek-V2-Lite (under FLuID's MoE masks from build_masks),
             Arctic, SeamlessM4T (frames through the encoder)
  serve      24 mixed-rate requests at full width (serving's main path)
  step       every launch of a full-width decode step against its plain version
  decode_routes the same step with grouped_decode=True (_sdpa_grouped,
             no decode_gqa launch) against the default route (relative
             2-norm <= 2e-2 of the hidden state and the logits)
  profile    device time by kernel over a few decode steps
  serve_rwkv RWKV-6-3B at full width: 16 mixed-rate requests of exactly 512
             tokens, the chunked scan launched once per layer per prefill;
             every launch of one prefill, and every layer's time-mix output
             from the same input, against the plain version; that
             prefill's logits against the plain version's within a
             multiple of its 1e-7 noise floor; decode rate against its
             byte bound, busy share of 3 decode steps; then one 512-token
             prefill under rwkv_c128_bf16 through make_prefill_step: the
             bf16 chunk form launched once a layer (its launches on the
             summary line), each held against its plain form
  serve_mla  MiniCPM3-4B at full width (62 layers, MLA with q-LoRA), the
             serve phase's 24 requests: masked_ffn_batch launched 62 x
             decode steps, decode_gqa never (MLA is plain torch, as in the
             reference); one decode step with every launch held against
             its plain version and the step against the plain step
             (hidden, logits relative 2-norm <= 2e-2); the absorbed MLA
             decode from the same caches within 2e-2 of the baseline's
             logits; tok/s, ms a step against its byte bound (every
             weight but the embedding), prefill ms, peak memory, busy share
  serve_griffin RecurrentGemma-9B at full width (38 layers: RG-LRU, RG-LRU,
             local attention x 12, then 2 RG-LRU), serve_rwkv's 16
             requests of exactly 512 tokens: masked_ffn_batch 38 x steps
             (gelu gated), decode_gqa never (windowed attention is plain);
             held step and report as serve_mla
  granite    Granite-20B at full width (d 6144, 48 query heads on one K/V
             head): one decode step launches decode_gqa once a layer (its
             biased FFN stays plain); every launch held, the step against
             the plain step
  serve_cmdr Command-R-35B at full width (40 parallel blocks, 64/8 heads,
             64.8 GB of bf16 weights, every earlier model freed), the serve
             phase's queue: masked_ffn_batch and decode_gqa 40 x steps;
             held step and report as serve_mla
  serve_moe  DeepSeek-V2-Lite-16B at full width (27 layers, 26 of them
             MoE: 64 routed experts of 1408, top-6, 2 shared; MLA) through
             launch.serve.serve's static batch (8 prompts of 512, 64
             greedy steps): no kernel launched (as in the reference); a
             second run the same tokens, its routing recorded: the
             (token, expert) assignments lost a decode step to capacity
             and to the slot cap − 1 overwrite; the first and the last MoE
             layer held card against CPU in fp32 at the real inputs of
             the prefill (T 4096), a decode step (T 8) and a 5 x 2048
             forward (T 10240, five chunks): identical routing but for
             reported near ties (k-th and (k+1)-th probabilities within
             1e-5), outputs within 1e-4; two decode steps from the same
             caches bitwise equal; tok/s, ms a step against its byte
             bound, prefill ms, peak memory, busy share
  serve_arctic Arctic-480B at full width on 2 of its 35 layers (56/8
             heads, 128 experts of 4864, top-2, a dense residual FFN;
             54.4 GB of bf16 weights), serve_moe's static batch:
             decode_gqa launched 2 x steps; zoo_step's held step; two
             decode steps bitwise equal; report as serve_moe
  serve_seamless SeamlessM4T-Large v2 at full width (24 + 24 layers,
             16 heads of 64, biased ReLU FFN 8192, LayerNorm), 512 frames
             and 512-token prompts, 64 steps: decode_gqa launched 24 x
             steps (the decoder's self-attention); encoder and decoder
             prefill ms apart; held step, bitwise steps and report as
             serve_arctic
  train_zoo  StableLM-2-12B at full width on 8 of its 40 layers (3.15B
             params; fp32 params, grads and AdamW moments reckoned at 50.3
             GB, printed before anything is allocated on the train_zoo_plan
             line), bf16 compute, block remat, the reference's synthetic
             batches of 4 x 256: 2 full steps, the FFN's invariant unit
             statistics against a snapshot (all > 0) and build_masks at
             pick_rate(1.3) = 0.75 (81 of 108 blocks a layer); one masked
             step's loss and gradients through the kernels against the
             dense route (loss 1e-2, each layer's FFN gradients 2e-2
             relative 2-norm, dropped blocks' gradients exactly 0 in both);
             3 masked steps through B1's training form, B2 and B3 (16, 8 and
             8 launches a step: the forward twice a layer under remat), the
             first with every launch held against its plain version (1e-2),
             the last profiled (busy share); 2 dense masked steps (no
             launch), the last with AdamW timed alone; loss falling, every
             param finite, peak memory; every step's AdamW one kernel
             launch a leaf; B1-B3 at this shape (C 1, M 1024)
             against their bounds, plain versions and the dense route's
             cuBLAS forward and backward; launch.train.run_fluid (6 steps,
             calibrated every 3: statistics > 0, 81 blocks kept, no
             launch) and run_plain's checkpoint at smoke size reloaded
             bitwise; the first full step counted by FlopCounterMode, the
             params' and AdamW state's allocation and the peak after the
             two full steps recorded for the dryrun phase
  dryrun     launch/dryrun.dry_step of train_zoo's dense step on the meta
             device: its FLOPs equal to the card's count, its params and
             AdamW state bytes equal to the card's allocation within 512 B
             a tensor; its peak estimate printed beside the card's peak,
             and a serving decode step's byte floor beside decode_bytes
  adamw      AdamW's one-pass kernel (kernels/adamw.py) on the StableLM
             train cell's tree (head_dim 160, parallel LayerNorm blocks, 8
             layers: 13 leaves, 3.25B fp32 params): one step of its largest
             leaf bitwise the plain chain's, one launch a leaf a step;
             device time on the largest leaf and over the tree beside the
             byte bound (28 B a parameter), the plain chain's time and
             torch.optim.AdamW(fused=True)'s at the same shapes (the
             library yardstick; the port never calls it)
  train_rwkv RWKV-6-3B at full width on 2 of its 32 layers in fp32: one
             make_train_step AdamW step on the card against the same step
             on the CPU (loss 1e-4, gradients 1e-3 relative 2-norm); the
             time mix trains through the plain chunked form under
             autograd, so the step launches no kernel
  train      6 FLuID rounds of femnist_kernel on the fleet backend (the
             FFN training path): each masked-FFN kernel launched once per
             SGD step; the same run with the plain versions must reach the
             same stragglers, rates, keep-maps and round times; busy share,
             tile-skip shares, and a 64-client cohort
  train_attn the same for femnist_attn (KernelAttnClassifier): each
             head-masked projection kernel launched 3 times per SGD step
             (Q, K, V), each merge kernel once, each FFN kernel once; also
             the share of (client, head) slabs skipped per policy
  train_paper the paper's workloads (femnist CNN 6 rounds; cifar10 VGG-9,
             shakespeare LSTM, synth MLP 3 each; 5 clients, n_data 2000)
             on the sequential backend, the reference's default, and on
             the dense fleet: the same plans and round times, test loss
             falling, accuracy above chance; at the reference's own test
             size (4 clients, n_data 240, 3 rounds) the same keep-maps
             and params within 5e-4; no kernel launched
  train_dense femnist_kernel and femnist_attn on the dense fleet at 5 and
             64 clients, held to train / train_attn's kernel-fleet runs
             (plans, keep-maps, round times, params within 5e-4); ms per
             SGD step and busy share beside theirs; no kernel launched
  population a 100 000-client store (BENCH_population's), cohorts of 200
             sampled per round, femnist_kernel on the kernel fleet, 4
             rounds with a drift: each masked-FFN kernel launched once per
             SGD step, and every launch held against its plain version on
             the same inputs; the drifted client flagged; the plain
             versions give identical cohorts, plans, keep-maps and round
             times, params within 1e-6; the sharded fleet (4 shards) the
             same, every launch held, with shard partials summing bitwise
             to its numerator; one round at cohort 1000, every launch
             held. Then, on rounds that follow: ms a round and clients/s
             with nothing wrapped, the shares of the host batch build and
             the invariant stats, the store's ops, busy share
  async      launch/async_fl's defaults (20 000 clients, buffer_k 16,
             concurrency 128) on femnist_kernel with the kernels, drop_prob
             0.05, a flash crowd of 20 at step 3, 10 buffers: launches per
             SGD step of every dispatch group, every launch held against
             its plain version (a padding slot's rows exactly 0), stale
             arrivals, dropouts, in-flight bookkeeping; the plain versions
             give the same clock, arrivals and plans, params within 1e-6;
             zero spread (buffer_k = concurrency = cohort 16) equals the
             kernel fleet bitwise; femnist_attn (K 8, concurrency 16, a
             flash crowd of 20, 3 buffers) held the same two ways. Then
             buffers a second with nothing wrapped, ms a dispatch group
  analysis   repro_torch.analysis on the card: dw-zero-ffn through B1-B3
             (ops.masked_ffn, every other 128-block of the weights NaN:
             a finite forward, the dropped dW exactly 0, the rest against
             the plain versions on clean weights within 1e-4 fp32 / 1e-2
             bf16) at the reference's cases (d 16, M 8, fp32) and at every
             zoo arch's (d_model, F, ffn_kind) and the kernel fleet's in
             bf16, M 8; dw-zero-attn through B4-B9 (ops.masked_attention,
             C 1) at the reference's cases (B 1, S 4, d 16, hd 8, fp32, H
             each zoo head count and 4) and at every arch's (H, hd,
             d_model) in bf16, B 1, S 8; one line a case with its shape and
             the ms of its poisoned forward and backward. No host sync
             (torch.cuda.set_sync_debug_mode("error") and the dispatch
             recorder) in the kernel-fleet cohort program and combine (5
             clients, n_data 2000), in every decode chunk of StableLM-2-12B's
             ServeEngine at full width (8 requests of 512 tokens, run after
             the profile phase) and in one more train_zoo kernel step (run
             inside train_zoo, its launches off that line); StableLM's
             masked train step at smoke size under three masks: the same op
             sequence and launches, nothing built. Its launches on its own
             line.
  paper      the five example twins (examples/*_torch.py) through their
             main() at the reference examples' sizes: the four FL and train
             twins launch no kernel (the dynamic twin's assertion holds),
             the serve twin serves StableLM-2-12B's smoke config (bf16, d
             256, F 512, 4/4 heads of 32) through B1 and B11, every launch
             held against its plain version (1e-2), its launches on this
             line; the paper's drivers (scripts/paper_experiments_torch.py):
             Table 2 at r 0.75 and 0.5, seeds 0 and 1, 12 rounds, Fig 4a
             (6 rounds), Fig 4b (12) and Table 3 (thresholds 0.002-0.05)
             at the paper's 5 clients and n_data 2000, Fig 6, Fig 5 (10
             clients) and the one-shot-pruning probe at the validation
             pass's sizes: every param finite, evaluated accuracies above
             chance (1/62), Fig 4a within 10%, Fig 4b's FLuID time below
             the static and baseline times (the static arm still on client
             0, FLuID's on 3), Table 3 non-decreasing, Fig 6 in [0, 1], no
             kernel launched; Table 2's ordering reported. Then Table 2's
             run (invariant, r 0.75, 6 rounds) twice under the default cuDNN
             flags and twice under cudnn.deterministic (the flags
             restored): repeats and ms a client step; the deterministic
             pair must repeat bitwise.

Any failure exits non-zero. Before the last three lines a ``total`` line
gives the seconds of the whole run. The last three lines are the per-kernel
summary, the card's name and power limit as nvidia-smi gives them, and
{"ok": true, "device": {...}}. Without a CUDA device, or without the repo
beside this script, it exits 2 and prints no result.
"""
from __future__ import annotations

import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's rates, one copy: HBM 3.35e12 B/s, bf16 989e12 and fp32 67e12
# FLOP/s, exponentials on the SFU (src/repro_torch/launch/roofline.py)
try:
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.roofline import (BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S,
                                             SFU_EXP_PER_S)
except ImportError:        # not beside a checkout: main() says so and exits 2
    if (SRC / "repro_torch").is_dir():
        raise
    BF16_FLOPS = FP32_FLOPS = HBM_BYTES_PER_S = SFU_EXP_PER_S = float("nan")
FFN_SHAPE = dict(M=8, d=5120, F=13824)
GQA_SHAPE = dict(B=8, H=32, KV=8, hd=128, C=576)
GQA_ROTATIONS = 24         # distinct K/V caches a timing graph cycles over: 453 MB
GQA_CACHE_BYTES = 2 * 8 * 576 * 8 * 128 * 2    # one of them, K and V in bf16
# B1's serving form at the zoo's decode shapes (M 8, bf16): (d, F, act)
ZOO_FFN_SHAPES = {"minicpm3-4b": (2560, 6400, "silu"),
                  "recurrentgemma-9b": (4096, 12288, "gelu"),
                  "command-r-35b": (8192, 22528, "silu")}
# B11 at Command-R-35B's, Granite-20B's (48 heads on one), SeamlessM4T-Large
# v2's decoder (16 heads of 64 on 16) and Arctic-480B's (56 on 8: 7 virtual
# groups of 1) decode
ZOO_GQA_SHAPES = {"command-r-35b": dict(B=8, H=64, KV=8, hd=128, C=576),
                  "granite-20b": dict(B=8, H=48, KV=1, hd=128, C=576),
                  "seamless-m4t-large-v2": dict(B=8, H=16, KV=16, hd=64, C=576),
                  "arctic-480b": dict(B=8, H=56, KV=8, hd=128, C=576)}
# the serve phase's queue (StableLM-2-12B), also serve_mla's and serve_cmdr's
SERVE_QUEUE = dict(batch=8, prompt_len=512, gen_len=64, n_requests=24,
                   rates=(1.0, 0.5, 0.25))
# the small phase's smoke configs, card against CPU: (arch, mla_absorb,
# prompt, cache length, decode steps); RecurrentGemma's past its 64-slot window
SMALL_CASES = (("stablelm-12b", False, 12, 14, 2), ("minicpm3-4b", False, 12, 14, 2),
               ("minicpm3-4b", True, 12, 14, 2), ("recurrentgemma-9b", False, 60, 70, 8),
               ("command-r-35b", False, 12, 14, 2), ("granite-20b", False, 12, 14, 2),
               ("deepseek-v2-lite-16b", False, 12, 14, 2), ("arctic-480b", False, 12, 14, 2),
               ("seamless-m4t-large-v2", False, 12, 14, 2))
# the small MoE case under FLuID's masks from build_masks (r 0.5, whole experts dropped)
SMALL_MOE_MASKED = "deepseek-v2-lite-16b"
# serve()'s static batch, the reference's --baseline path: serve_moe,
# serve_arctic and serve_seamless (SeamlessM4T's frames are prompt_len long)
BASELINE_QUEUE = dict(batch=8, prompt_len=512, gen_len=64)
ARCTIC_LAYERS = 2              # of 35: 2 full-width layers are 54.4 GB of bf16 weights
# serve_moe holds DeepSeek's first and last MoE layer at the prefill's and a
# decode step's real inputs, and at T 10240 (B 5 x S 2048: five chunks of 2048)
MOE_LONG = (5, 2048)
MOE_TIE = 1e-5                 # a pick may differ where k-th and (k+1)-th probs are this close
MOE_LAYER_TOL = 1e-4           # card vs CPU, fp32, relative ∞-norm
GRANITE_LAYERS = 52            # Granite-20B's full depth, for its one held decode step
# train_zoo: StableLM-2-12B at full width on 8 of its 40 layers (3.15B
# params: params, grads and AdamW's m and v in fp32 are 50.3 GB), fp32
# params, bf16 compute, block remat, batch 4 x 256 (M 1024 rows)
ZOO_TRAIN = dict(arch="stablelm-12b", layers=8, batch=4, seq=256, slowdown=1.3)
ZOO_FLUID = dict(steps=6, calibrate_every=3)
ZOO_CKPT = dict(steps=3, batch=2, seq=32)      # run_plain's checkpoint, smoke config
# kernel step against the dense step: loss, and each layer's FFN gradients
# (relative 2-norm); every launch of the first kernel step against its plain
# version at the bf16 per-launch gate
ZOO_LOSS_TOL, ZOO_GRAD_TOL, BF16_HOLD_TOL = 1e-2, 2e-2, 1e-2
# adamw: the StableLM train cell's tree (the port's stablelm-12b at the
# published 12B's head_dim 160, parallel block and LayerNorm, 8 layers:
# 3.25B fp32 params), AdamW's hyperparameters as its configuration's
ADAMW_TREE = dict(arch="stablelm-12b", layers=8,
                  overrides=dict(head_dim=160, parallel_block=True, norm_kind="layernorm"))
ADAMW_HYPER = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8)
ADAMW_BYTES = 28               # a parameter: p, g, m, v read and p, m, v written, fp32
# train_rwkv: RWKV-6-3B at full width on 2 of its 32 layers in fp32, one
# AdamW step on the card against the same step on the CPU
RWKV_TRAIN = dict(arch="rwkv6-3b", layers=2, batch=2, seq=128)
RWKV_TRAIN_TOL = dict(loss=1e-4, grads=1e-3)
# dryrun: argument bytes against the card's allocation, a tensor's rounding
ALLOC_ROUNDING = 512
# a zoo step's end-to-end gate: 2e-2, or, where the gap of the plain step
# with masked_ffn_batch's fp32 sums in 2 and 4 pieces exceeds 2e-2 (no
# kernel in either), this factor times that gap
ZOO_NOISE_PARTS, STEP_NOISE_FACTOR = (2, 4), 1.5
TRAIN_SHAPE = dict(M=10, d=64, F=1024)     # KernelMLP's FFN, batch 10
# KernelAttnClassifier at batch 10: 490 rows a client, 4 heads of 16, FFN 256
ATTN_SHAPE = dict(M=490, d=64, H=4, hd=16, F=256)
ATTN_LONG_M = 1100             # 9 m-tiles: more than one cluster of 8 for the dW kernels
ATTN_WIDE = dict(C=2, M=300, d=256, hd=64)   # a width the slab and sum kernels once refused
HEAD_DW = ("masked_head_proj_dw", "masked_head_merge_dw")
RWKV_SCAN_SHAPE = dict(B=1, S=512, H=40, N=64, chunk=128)   # RWKV-6-3B prefill
STATS_SHAPES = ((1024, 1024, "float32"), (1024, 1024, "bfloat16"),
                (2560, 8960, "bfloat16"))                    # last: RWKV-6-3B cmix w_in
RWKV_QUEUE = dict(batch=8, prompt_len=512, gen_len=64, n_requests=16,
                  rates=(1.0, 0.5, 0.25))
# serve_rwkv's end-to-end gate against the plain scan's 1e-7 noise floor
RWKV_NOISE_SEEDS = (1, 2, 3)
E2E_GAP_FACTOR, E2E_AGREEMENT_MARGIN = 3.0, 0.2
SERVE_KERNELS = ("masked_ffn_batch", "decode_gqa")
TRAIN_KERNELS = ("masked_ffn_train_fwd", "masked_ffn_dx", "masked_ffn_dw")
# the forward's, dx's and dW's calls that took the tensor-core route (bf16, M >= 128)
TC_KERNELS = ("masked_ffn_train_fwd_tc", "masked_ffn_dx_tc", "masked_ffn_dw_tc")
# the fleet's launches an SGD step (fp32, small M: none on the tensor cores)
FLEET_PER_STEP = {**dict.fromkeys(TRAIN_KERNELS, 1), **dict.fromkeys(TC_KERNELS, 0)}
# the head-masked kernels and their launches per SGD step (Q, K, V or O)
ATTN_KERNELS = {"masked_head_proj": 3, "masked_head_proj_dx": 3,
                "masked_head_proj_dw": 3, "masked_head_merge": 1,
                "masked_head_merge_da": 1, "masked_head_merge_dw": 1}
N_TIMED = 25


class SmokeFailure(Exception):
    pass


_last_emit = [time.perf_counter()]


def emit(phase, **kw):
    """One JSON line for a phase, with the seconds since the last line."""
    now = time.perf_counter()
    print(json.dumps({"phase": phase, "phase_s": now - _last_emit[0], **kw}),
          flush=True)
    _last_emit[0] = now


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


def time_loop_ms(fn, torch, n=50, reps=5, warmup=3):
    """Median over reps of the mean time of one call in n back-to-back
    calls between two CUDA events: for kernels of a few microseconds,
    where a single call's events would time the launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, torch, n=20, reps=N_TIMED):
    """Device time of one call of fn, without the host's launch time (which
    bounds a loop of kernels of a few microseconds): n calls captured in a
    CUDA graph, each replay timed by CUDA events; the median over reps
    replays, over n."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, torch, n=reps) / n


def bound_ms(nbytes, flops, peak=BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------

def rotating(calls):
    """One function that runs ``calls`` in turn, a call each time: captured
    len(calls) times in a graph, every call reads its own inputs."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def ffn_mixes(torch, M, F, dev):
    """The serving tile's masks: ordered keep-maps at rate 1.0, at 0.5, the
    serve's 1.0/0.5/0.25 cycle, and the cycle with its last row dropped."""
    from repro_torch.core.dropout import keep_count

    def ordered(rates):
        m = torch.zeros(M, F, device=dev)
        for i, r in enumerate(rates):
            m[i, :keep_count(F, r)] = 1.0 if r > 0 else 0.0
        return m
    cyc = [(1.0, 0.5, 0.25)[i % 3] for i in range(M)]
    return {"rate1.0": ordered([1.0] * M), "rate0.5": ordered([0.5] * M),
            "mixed1.0/0.5/0.25": ordered(cyc),
            "mixed+dropped_row": ordered(cyc[:-1] + [0.0])}


def gqa_length_sets(np, B, C):
    """The lengths decode_gqa is timed at: the kernels phase's ragged draw
    (first 1, last C), the step phase's 256 − 16i, and every row full."""
    lens = np.random.RandomState(1).randint(1, C + 1, B)
    lens[0], lens[-1] = 1, C
    return {"kernels": lens, "step": np.array([256 - 16 * i for i in range(B)]),
            "full": np.full(B, C)}


def ffn_cases(torch, g, M, d, F, act, dev):
    """masked_ffn_batch at (M, d, F, act), bf16, under each of ffn_mixes:
    held to its plain version (relative ∞-norm <= 1e-2, dropped rows
    exactly 0) and to a second call's bits; device time from a CUDA graph,
    one call's time, the plain version's, and the byte bound."""
    from repro_torch.kernels import masked_ffn as ffn
    bf = torch.bfloat16
    rnd = lambda *s, fan: (torch.randn(*s, generator=g, device=dev)
                           / fan ** 0.5).to(bf)
    x = rnd(M, d, fan=1)
    w_in, w_gate, w_out = rnd(d, F, fan=d), rnd(d, F, fan=d), rnd(F, d, fan=F)
    per_mix = {}
    for name, mask in ffn_mixes(torch, M, F, dev).items():
        run = lambda: ffn.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate,
                                           act=act)
        plain = lambda: ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, act)
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        err = rel_inf(got, want)
        dropped = mask.sum(1) == 0
        tag = f"masked_ffn_batch[d {d}, F {F}, {act}, {name}]"
        check(err <= 1e-2, f"{tag} rel err {err}")
        check(bool((got[dropped] == 0).all()), f"{tag} dropped row not exactly 0")
        check(torch.equal(got, again), f"{tag} two calls differ")
        kept_blocks = int((mask.view(M, F // 128, 128).amax((0, 2)) > 0).sum())
        fk = kept_blocks * 128
        nbytes = 3 * d * fk * 2 + M * d * 2 * 2 + M * F * 4
        b_ms, b_by = bound_ms(nbytes, 2 * 3 * M * d * fk)
        per_mix[name] = {
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "rel_err": err, "kept_blocks": kept_blocks,
            "ms": graph_ms(run, torch), "call_ms": time_ms(run, torch),
            "plain_ms": graph_ms(plain, torch, n=4),
            "bound_ms": b_ms, "bound_by": b_by}
    return per_mix


def gqa_cases(torch, np, g, shape, dev, rotations=GQA_ROTATIONS):
    """decode_gqa at ``shape`` (B, H, KV, hd, C), bf16, at each set of
    gqa_length_sets: held to its plain version (relative ∞-norm <= 1e-2)
    and to a second call's bits; device time on a cold cache from a CUDA
    graph of calls rotating over ``rotations`` K/V caches, SDPA's the
    same way, one call's time, the plain version's, and the byte bound."""
    from repro_torch.kernels import decode_gqa as gqa
    bf = torch.bfloat16
    B, H, KV, hd, C = (shape[k] for k in ("B", "H", "KV", "hd", "C"))
    q = torch.randn(B, H, hd, generator=g, device=dev).to(bf)
    caches = [(torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf),
               torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf))
              for _ in range(rotations)]
    # library yardstick: SDPA over the same caches, never used by the port
    caches_t = [(k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
                for k, v in caches]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4 = q[:, :, None]
    k, v = caches[0]
    per_len = {}
    for name, lens_np in gqa_length_sets(np, B, C).items():
        lengths = torch.tensor(lens_np, dtype=torch.int32, device=dev)
        amask = (torch.arange(C, device=dev)[None, :] < lengths[:, None])[:, None, None]
        got, again = gqa.decode_gqa(q, k, v, lengths), gqa.decode_gqa(q, k, v, lengths)
        want = gqa.decode_gqa_plain(q, k, v, lengths)
        lib_out = sdpa(q4, *caches_t[0], attn_mask=amask, enable_gqa=True)[:, :, 0]
        torch.cuda.synchronize()
        err, lib_err = rel_inf(got, want), rel_inf(lib_out, want)
        tag = f"decode_gqa[{H}/{KV} heads, {name}]"
        check(err <= 1e-2, f"{tag} rel err {err}")
        check(torch.equal(got, again), f"{tag} two calls differ")
        check(lib_err <= 1e-2, f"{tag} library yardstick disagrees: {lib_err}")
        kern = rotating([lambda kv=kv: gqa.decode_gqa(q, *kv, lengths) for kv in caches])
        plain = rotating([lambda kv=kv: gqa.decode_gqa_plain(q, *kv, lengths)
                          for kv in caches])
        lib = rotating([lambda kv=kv: sdpa(q4, *kv, attn_mask=amask, enable_gqa=True)
                        for kv in caches_t])
        n_valid = int(lens_np.sum())
        nbytes = 2 * n_valid * KV * hd * 2 + 2 * B * H * hd * 2 + B * 4
        b_ms, b_by = bound_ms(nbytes, 4 * n_valid * H * hd)
        per_len[name] = {
            "lengths": lens_np.tolist(), "rel_err": err,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": graph_ms(kern, torch, n=rotations),
            "call_ms": time_ms(lambda: gqa.decode_gqa(q, k, v, lengths), torch),
            "plain_ms": graph_ms(plain, torch, n=rotations),
            "library_ms": graph_ms(lib, torch, n=rotations),
            "library_call_ms": time_ms(lambda: sdpa(q4, *caches_t[0], attn_mask=amask,
                                                    enable_gqa=True), torch),
            "bound_ms": b_ms, "bound_by": b_by}
    return per_len


def phase_kernels(torch, np):
    """masked_ffn_batch and decode_gqa at the serve's decode shapes, each
    against its plain version (relative ∞-norm <= 1e-2, dropped rows
    exactly 0) and against itself (two calls, the same bits). ``ms`` is
    device time a call on a cold cache: calls captured in a CUDA graph,
    timed by CUDA events around replays. decode_gqa's calls rotate over
    GQA_ROTATIONS distinct caches (over the 50 MB L2 many times), as the
    decode step reads each layer's cache after its weights have streamed
    through; masked_ffn_batch's 425 MB of weights exceed the L2 already.
    ``call_ms`` is the median single-call time between two CUDA events,
    host path included (how these two kernels' rows were timed before)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []

    # masked_ffn_batch at the decode shape: 8 slots, SwiGLU, bf16
    M, d, F = FFN_SHAPE["M"], FFN_SHAPE["d"], FFN_SHAPE["F"]
    per_mix = ffn_cases(torch, g, M, d, F, "silu", dev)
    head = per_mix["mixed1.0/0.5/0.25"]
    out.append({"name": "masked_ffn_batch", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/masked_ffn.cu",
                "replaces": "src/repro/kernels/masked_ffn.py:107",
                "max_abs_err": max(v["max_abs_err"] for v in per_mix.values()),
                "ms": head["ms"], "call_ms": head["call_ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": None, "shape": FFN_SHAPE, "mixes": per_mix})

    # decode_gqa at the decode shape, cold caches, three sets of lengths
    per_len = gqa_cases(torch, np, g, GQA_SHAPE, dev)
    head = per_len["kernels"]
    out.append({"name": "decode_gqa", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_gqa.cu",
                "replaces": "src/repro/kernels/decode_gqa.py:21",
                "max_abs_err": max(v["max_abs_err"] for v in per_len.values()),
                "ms": head["ms"], "call_ms": head["call_ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                "library_call": "scaled_dot_product_attention(enable_gqa=True)",
                "shape": GQA_SHAPE, "lengths": per_len})
    return out


def phase_zoo_kernels(torch, np):
    """The two serving kernels at the zoo's decode shapes, as phase_kernels
    holds and times them at StableLM's: masked_ffn_batch at MiniCPM3-4B's,
    RecurrentGemma-9B's (gelu gated) and Command-R-35B's FFN, decode_gqa at
    Command-R's 64/8 heads, Granite-20B's 48/1 (virtual head groups),
    SeamlessM4T-Large v2's 16/16 of 64 and Arctic-480B's 56/8 (7 groups).
    decode_gqa's calls rotate over enough caches to read ~453 MB, as at
    StableLM's shape. Returns {kernel name: {model: cases}}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    ffn_rows = {arch: {"shape": dict(M=8, d=d, F=F, act=act),
                       "mixes": ffn_cases(torch, g, 8, d, F, act, dev)}
                for arch, (d, F, act) in ZOO_FFN_SHAPES.items()}
    gqa_rows = {}
    for arch, shape in ZOO_GQA_SHAPES.items():
        cache_bytes = 2 * shape["B"] * shape["C"] * shape["KV"] * shape["hd"] * 2
        rotations = max(GQA_ROTATIONS, -(-GQA_ROTATIONS * GQA_CACHE_BYTES // cache_bytes))
        gqa_rows[arch] = {"shape": shape, "rotations": rotations,
                          "lengths": gqa_cases(torch, np, g, shape, dev, rotations)}
    return {"masked_ffn_batch": ffn_rows, "decode_gqa": gqa_rows}


def train_masks(torch, np, C, kind, dev, M=TRAIN_SHAPE["M"], F=TRAIN_SHAPE["F"]):
    """(C, M, F) row masks from the port's own policies: every client all
    kept, ordered at rate 0.5 (whole blocks dropped), invariant at 0.75
    (scattered neurons), or "main" — the training path's mix, one client in
    eight (client 0 of 5) on the invariant 0.75 keep-map, the rest full."""
    from repro_torch.core.dropout import get_policy
    spec = [{"name": "ffn", "size": F, "out": [], "in": []}]
    inv = get_policy("invariant", spec)
    rng = np.random.RandomState(0)
    stats = [{"ffn": torch.from_numpy(np.abs(rng.randn(F)).astype(np.float32))}
             for _ in range(4)]
    inv.observe(stats, float(np.median([s["ffn"].numpy() for s in stats])))

    def row(keep):
        r = torch.zeros(F)
        r[torch.as_tensor(keep)] = 1.0
        return r
    full = torch.ones(F)
    rows = {"all_kept": [full] * C,
            "ordered0.5": [row(get_policy("ordered", spec).keep_map(0.5)["ffn"])] * C,
            "invariant0.75": [row(inv.keep_map(0.75)["ffn"])] * C,
            "main": [row(inv.keep_map(0.75)["ffn"]) if c % 8 == 0 else full
                     for c in range(C)]}[kind]
    return torch.stack(rows)[:, None, :].expand(C, M, F).contiguous().to(dev)


def train_work(torch, mask, d, gated, elem):
    """(bytes, flops) per training kernel that this mask's data needs: x/gy
    read and y/dx written once, the weights of the blocks some m-tile keeps,
    the mask, dW written whole; one product is 2·rows·d·128 FLOPs per kept
    (m-tile, f-block) tile. Also the share of tiles skipped."""
    C, M, F = mask.shape
    nmt, nfb = -(-M // 8), F // 128
    mp = torch.zeros(C, nmt * 8, F, device=mask.device)
    mp[:, :M] = mask
    kept = mp.view(C, nmt, 8, nfb, 128).amax(dim=(2, 4)) > 0       # (C, nmt, nfb)
    rows = torch.tensor([min(8, M - 8 * t) for t in range(nmt)], device=mask.device)
    product = int((kept * rows[None, :, None]).sum()) * 128 * d * 2
    nmat = 3 if gated else 2
    wbytes = int(kept.any(dim=1).sum()) * 128 * d * elem * nmat
    io, mbytes = C * M * d * elem, C * M * F * 4
    work = {"masked_ffn_train_fwd": (2 * io + wbytes + mbytes, product * nmat),
            "masked_ffn_dx": (3 * io + wbytes + mbytes, product * (5 if gated else 3)),
            "masked_ffn_dw": (2 * io + wbytes + mbytes + C * d * F * elem * nmat,
                              product * (6 if gated else 4))}
    return work, 1.0 - float(kept.float().mean())


def phase_train_kernels(torch, np, dev="cuda"):
    """The three training kernels against their plain versions at the
    fleet's shapes: C 5 and 64, fp32 gelu under four masks, and one gated
    bf16 case; and at femnist_attn's FFN shape (C 5 and 64, M 490, F 256).
    Relative ∞-norm <= 1e-4 in fp32 (1e-2 in bf16); the dW of a
    tile no row keeps is exactly 0. ``ms`` is device time per call, from
    CUDA events around a CUDA graph of calls (the kernels are a few
    microseconds, below the host's launch time, which ``host_ms`` gives:
    one call in a back-to-back loop). Each kernel also runs twice on the
    same inputs (the same bits), beside the launch shape it takes
    (``dw_launch_geometry``, or ``fwd_dx_launch_geometry`` and whether the
    weight slab stays resident)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import masked_ffn as ffn
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    d = TRAIN_SHAPE["d"]
    mlp = (TRAIN_SHAPE["M"], TRAIN_SHAPE["F"])
    cases = [(C, mlp, kind, torch.float32, "gelu", False) for C in (5, 64)
             for kind in ("main", "all_kept", "ordered0.5", "invariant0.75")]
    cases.append((5, mlp, "ordered0.5", torch.bfloat16, "gelu", True))
    # femnist_attn's FFN: 490 rows a client, F 256; and its 64-client cohort
    attn = (ATTN_SHAPE["M"], ATTN_SHAPE["F"])
    cases += [(5, attn, kind, torch.float32, "gelu", False)
              for kind in ("main", "all_kept")]
    cases.append((64, attn, "main", torch.float32, "gelu", False))
    per = {k: [] for k in TRAIN_KERNELS}
    for C, (M, F), kind, dtype, act, gated in cases:
        r = lambda *sh, fan: (torch.randn(*sh, generator=g, device=dev)
                              / fan ** 0.5).to(dtype)
        x, gy = r(C, M, d, fan=1), r(C, M, d, fan=1)
        w_in, w_out = r(C, d, F, fan=d), r(C, F, d, fan=F)
        w_gate = r(C, d, F, fan=d) if gated else None
        mask = train_masks(torch, np, C, kind, dev, M, F)
        args = (x, w_in, w_out, mask, w_gate)
        runs = {"masked_ffn_train_fwd": (
                    lambda: ffn.masked_ffn_train_fwd(*args, act=act),
                    lambda: ffn.masked_ffn_batch_plain(*args, act)),
                "masked_ffn_dx": (
                    lambda: ffn.masked_ffn_dx(gy, *args, act=act),
                    lambda: ffn.masked_ffn_dx_plain(gy, *args, act)),
                "masked_ffn_dw": (
                    lambda: ffn.masked_ffn_dw(gy, *args, act=act),
                    lambda: ffn.masked_ffn_dw_plain(gy, *args, act))}
        work, skipped = train_work(torch, mask, d, gated, x.element_size())
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        dropped = (mask.amax(dim=1).view(C, F // 128, 128).amax(dim=2) == 0
                   ).repeat_interleave(128, dim=1)                    # (C, F)
        name = (f"C{C}/M{M}/F{F}/{kind}/{str(dtype)[6:]}/{act}"
                f"{'/gated' if gated else ''}")
        for k, (kern, plain) in runs.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = [rel_inf(a, b) for a, b in zip(got, want) if b is not None]
            check(max(errs) <= tol, f"{k}[{name}] rel err {errs}")
            extra = {}
            if k == "masked_ffn_dw":
                for t, cols_first in zip(got, (False, True, False)):
                    if t is not None:
                        z = t if cols_first else t.transpose(1, 2)
                        check(bool((z[dropped] == 0).all()),
                              f"{k}[{name}] dropped dW tile not exactly 0")
                again = kern()
                check(all(torch.equal(a, b) for a, b in zip(got, again) if a is not None),
                      f"{k}[{name}]: two calls differ")
                extra["geometry"] = ffn.dw_launch_geometry(C, M, d, F, _build.sm_count(dev))
            else:
                again = kern()
                check(torch.equal(got[0], again), f"{k}[{name}]: two calls differ")
                geo = ffn.fwd_dx_launch_geometry(C, M, d, F, _build.sm_count(dev))
                extra["geometry"] = dict(geo, slab_resident=ffn.fd_slab_resident(
                    M, d, F, gated, k == "masked_ffn_dx", geo["groups"]))
            nbytes, flops = work[k]
            b_ms, b_by = bound_ms(nbytes, flops, FP32_FLOPS
                                  if dtype == torch.float32 else BF16_FLOPS)
            per[k].append({
                "case": name, "skipped_tile_share": skipped,
                "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                   for a, b in zip(got, want) if b is not None),
                "rel_err": max(errs), "ms": graph_ms(kern, torch),
                "plain_ms": graph_ms(plain, torch),
                "host_ms": time_loop_ms(kern, torch),
                "plain_host_ms": time_loop_ms(plain, torch, n=20),
                "bound_ms": b_ms, "bound_by": b_by, **extra})
    block_entry = block_mask_entry(torch, dev, g)
    src = "src/repro_torch/kernels/csrc/masked_ffn_train.cu"
    replaces = {"masked_ffn_train_fwd": "src/repro/kernels/masked_ffn.py:107",
                "masked_ffn_dx": "src/repro/kernels/masked_ffn.py:165",
                "masked_ffn_dw": "src/repro/kernels/masked_ffn.py:193"}
    out = []
    for k in TRAIN_KERNELS:
        head = per[k][0]                  # C 5, the training path's mask mix
        out.append({"name": k, "route": "cuda", "source": src,
                    "replaces": replaces[k],
                    "max_abs_err": max(c["max_abs_err"] for c in per[k]),
                    "ms": head["ms"], "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                    "library_ms": None, "shape": dict(TRAIN_SHAPE, C=5),
                    "mixes": per[k]})
    out[0]["block_mask_entry"] = block_entry
    return out


def block_mask_entry(torch, dev, g):
    """The reference's block-masked entry, ``ops.masked_ffn`` (the three
    training kernels at C = 1), at KernelMLP's FFN (M 10, d 64, F 1024,
    fp32 gelu) with the first half of the 128-neuron blocks kept (rate
    0.5): forward alone, and forward with backward (dx and the dW of both
    weights), each as device time from a CUDA graph, beside its bound and
    the plain route's time. Against the plain route <= 1e-4; the dropped
    blocks' dW exactly 0."""
    from repro_torch.kernels import masked_ffn as ffn
    from repro_torch.kernels import ops
    M, d, F = TRAIN_SHAPE["M"], TRAIN_SHAPE["d"], TRAIN_SHAPE["F"]
    r = lambda *sh, fan: (torch.randn(*sh, generator=g, device=dev)
                          / fan ** 0.5).requires_grad_()
    x, w_in, w_out = r(M, d, fan=1), r(d, F, fan=d), r(F, d, fan=F)
    gy = torch.randn(M, d, generator=g, device=dev)
    block = torch.tensor([1.0] * (F // 256) + [0.0] * (F // 256), device=dev)
    leaves = (x, w_in, w_out)

    def fwd(entry):
        with torch.no_grad():
            return entry(x, w_in, w_out, block, act="gelu")

    def fwd_bwd(entry):
        return torch.autograd.grad(entry(x, w_in, w_out, block, act="gelu"), leaves, gy)

    def plain_entry(x, w_in, w_out, block, act):
        row = block.repeat_interleave(128).expand(M, F)
        return ffn.masked_ffn_batch_plain(x, w_in, w_out, row, None, act)
    got, want = fwd_bwd(ops.masked_ffn), fwd_bwd(plain_entry)
    torch.cuda.synchronize()
    errs = [rel_inf(a, b) for a, b in zip(got, want)]
    check(max(errs) <= 1e-4, f"masked_ffn (block mask) fwd+bwd rel err {errs}")
    check(bool((got[1][:, F // 2:] == 0).all() and (got[2][F // 2:] == 0).all()),
          "masked_ffn (block mask): dropped blocks' dW not exactly 0")
    row = block.repeat_interleave(128).expand(M, F)[None].contiguous()
    work, _ = train_work(torch, row, d, False, 4)
    fb, ff = work["masked_ffn_train_fwd"]
    tb, tf = (sum(w[i] for w in work.values()) for i in (0, 1))
    b_fwd, b_fwd_by = bound_ms(fb, ff, FP32_FLOPS)
    b_all, b_all_by = bound_ms(tb, tf, FP32_FLOPS)
    return {"shape": dict(TRAIN_SHAPE, block_rate=0.5, act="gelu"),
            "rel_err": max(errs),
            "fwd_ms": graph_ms(lambda: fwd(ops.masked_ffn), torch),
            "fwd_plain_ms": graph_ms(lambda: fwd(plain_entry), torch),
            "fwd_bound_ms": b_fwd, "fwd_bound_by": b_fwd_by,
            "fwd_bwd_ms": graph_ms(lambda: fwd_bwd(ops.masked_ffn), torch),
            "fwd_bwd_plain_ms": graph_ms(lambda: fwd_bwd(plain_entry), torch),
            "fwd_bwd_bound_ms": b_all, "fwd_bwd_bound_by": b_all_by}


PAIRS = ((0, 1), (2, 3), (0, 2), (1, 3), (0, 3), (1, 2))   # heads a "half" client drops


def head_masks(torch, C, kind, dev):
    """(C, H) head masks: "main" — the femnist_attn path's mix, one client
    in eight (client 0 of 5) on 3 of 4 heads (the invariant policy's
    keep_count at rate 0.75), the rest full — or "half", every client on 2
    of 4 heads, a different pair each."""
    H = ATTN_SHAPE["H"]
    m = torch.ones(C, H)
    for c in range(C):
        if kind == "main" and c % 8 == 0:
            m[c, 1] = 0.0
        elif kind == "half":
            m[c, list(PAIRS[c % len(PAIRS)])] = 0.0
    return m.to(dev)


def attn_work(mask, M, width, hd, elem=4):
    """(bytes, flops) per head-masked kernel that this head mask's data
    needs: the kept heads' slabs of each head-partitioned input and of the
    weights, the other input of the clients that keep any head, the output
    written whole and the mask; 2 FLOPs a multiply-add over kept heads."""
    C, H = mask.shape
    N = H * hd
    kh = int((mask != 0).sum())                 # kept (client, head) pairs
    kc = int((mask != 0).any(dim=1).sum())      # clients that keep a head
    slab = kh * M * hd * elem                   # kept slabs of a (C, M, N) operand
    full = kc * M * width * elem                # a (C, M, width) operand
    w = kh * width * hd * elem                  # kept slabs of the weight
    out_mn, out_mw, out_w = C * M * N * elem, C * M * width * elem, C * width * N * elem
    flops = 2 * M * width * hd * kh
    mbytes = C * H * 4
    return {"masked_head_proj": (full + w + out_mn + mbytes, flops),
            "masked_head_proj_dx": (slab + w + out_mw + mbytes, flops),
            "masked_head_proj_dw": (full + slab + out_w + mbytes, flops),
            "masked_head_merge": (slab + w + out_mw + mbytes, flops),
            "masked_head_merge_da": (full + w + out_mn + mbytes, flops),
            "masked_head_merge_dw": (slab + full + out_w + mbytes, flops)}


def phase_attn_kernels(torch, np, dev="cuda"):
    """The six head-masked kernels against their plain versions at the
    femnist_attn shapes (C 5 and 64 clients, M 490, d 64, H 4, hd 16,
    fp32) under two head-mask mixes, at C 5, M 1100 (9 m-tiles) under the
    "half" mix, and at width 256 (C 2, M 300, 4 heads of 64), a width at
    which the slab and sum kernels once staged the whole weight and refused
    to launch. Relative ∞-norm <= 1e-4; a dropped head's output slab (y,
    da, dW columns or rows) is exactly 0; every kernel gives the same bits
    on a second call and reports its launch geometry. ``ms`` is device
    time per call from CUDA events around a CUDA graph of 20 calls;
    ``library_ms`` one ``torch.bmm`` that computes the same function with
    the head mask folded into an operand beforehand."""
    from repro_torch.kernels import masked_attn as attn
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(2)
    M0, d0, H, hd0 = (ATTN_SHAPE[k] for k in ("M", "d", "H", "hd"))
    per = {k: [] for k in ATTN_KERNELS}
    wide = ATTN_WIDE
    cases = [(5, M0, "main", d0, hd0), (5, M0, "half", d0, hd0), (64, M0, "main", d0, hd0),
             (64, M0, "half", d0, hd0), (5, ATTN_LONG_M, "half", d0, hd0),
             (wide["C"], wide["M"], "half", wide["d"], wide["hd"])]
    for C, M, kind, d, hd in cases:
        N = H * hd
        r = lambda *sh, fan: torch.randn(*sh, generator=g, device=dev) / fan ** 0.5
        x, gy_p, w_p = r(C, M, d, fan=1), r(C, M, N, fan=1), r(C, d, N, fan=d)
        a, gy_m, w_m = r(C, M, N, fan=1), r(C, M, d, fan=1), r(C, N, d, fan=N)
        mask = head_masks(torch, C, kind, dev)
        cols = (mask != 0).float().repeat_interleave(hd, dim=1)      # (C, N)
        # the library call's operands, head mask folded in ahead of time
        w_pm, gy_pm = w_p * cols[:, None, :], gy_p * cols[:, None, :]
        w_mm, a_m = w_m * cols[:, :, None], a * cols[:, None, :]
        xt, a_mt = x.transpose(1, 2), a_m.transpose(1, 2)
        runs = {
            "masked_head_proj": (lambda: attn.proj_fwd(x, w_p, mask),
                                 lambda: attn.masked_head_proj_plain(x, w_p, mask),
                                 lambda: torch.bmm(x, w_pm)),
            "masked_head_proj_dx": (lambda: attn.proj_dx(gy_p, w_p, mask),
                                    lambda: attn.masked_head_proj_dx_plain(gy_p, w_p, mask),
                                    lambda: torch.bmm(gy_p, w_pm.transpose(1, 2))),
            "masked_head_proj_dw": (lambda: attn.proj_dw(gy_p, x, mask),
                                    lambda: attn.masked_head_proj_dw_plain(gy_p, x, mask),
                                    lambda: torch.bmm(xt, gy_pm)),
            "masked_head_merge": (lambda: attn.merge_fwd(a, w_m, mask),
                                  lambda: attn.masked_head_merge_plain(a, w_m, mask),
                                  lambda: torch.bmm(a, w_mm)),
            "masked_head_merge_da": (lambda: attn.merge_da(gy_m, w_m, mask),
                                     lambda: attn.masked_head_merge_da_plain(gy_m, w_m, mask),
                                     lambda: torch.bmm(gy_m, w_mm.transpose(1, 2))),
            "masked_head_merge_dw": (lambda: attn.merge_dw(gy_m, a, mask),
                                     lambda: attn.masked_head_merge_dw_plain(gy_m, a, mask),
                                     lambda: torch.bmm(a_mt, gy_m))}
        slab = {"masked_head_proj_dw": (d, hd), "masked_head_merge_dw": (hd, d)}
        work = attn_work(mask, M, d, hd)
        dropped = (cols == 0)                                          # (C, N)
        name = (f"C{C}/{kind}" + (f"/M{M}" if M != M0 else "")
                + (f"/d{d}/hd{hd}" if d != d0 else ""))
        for k, (kern, plain, lib) in runs.items():
            got, want, libv = kern(), plain(), lib()
            torch.cuda.synchronize()
            err = rel_inf(got, want)
            check(err <= 1e-4, f"{k}[{name}] rel err {err}")
            lib_err = rel_inf(libv, want)
            check(lib_err <= 1e-4, f"{k}[{name}] library yardstick disagrees: {lib_err}")
            slabs = got if k == "masked_head_merge_dw" else got.transpose(1, 2)
            if k not in ("masked_head_proj_dx", "masked_head_merge"):
                check(bool((slabs[dropped] == 0).all()),
                      f"{k}[{name}] dropped head's slab not exactly 0")
            check(torch.equal(kern(), got), f"{k}[{name}] two calls differ in their bits")
            extra = (attn.dw_launch_geometry(C, M, H, *slab[k]) if k in HEAD_DW
                     else attn.mm_launch_geometry(k, C, M, d, H, hd))
            b_ms, b_by = bound_ms(*work[k], FP32_FLOPS)
            per[k].append({
                "case": name, "M": M, "d": d, "hd": hd, **extra,
                "skipped_head_share": float(dropped.float().mean()),
                "max_abs_err": float((got - want).abs().max()), "rel_err": err,
                "ms": graph_ms(kern, torch), "plain_ms": graph_ms(plain, torch),
                "library_ms": graph_ms(lib, torch),
                "host_ms": time_loop_ms(kern, torch),
                "plain_host_ms": time_loop_ms(plain, torch, n=20),
                "bound_ms": b_ms, "bound_by": b_by})
    src = "src/repro_torch/kernels/csrc/masked_attn.cu"
    replaces = {"masked_head_proj": 153, "masked_head_proj_dx": 171,
                "masked_head_proj_dw": 189, "masked_head_merge": 224,
                "masked_head_merge_da": 242, "masked_head_merge_dw": 260}
    out = []
    for k in ATTN_KERNELS:
        head = per[k][0]                  # C 5, the path's head-mask mix
        row = {"name": k, "route": "cuda", "source": src,
               "replaces": f"src/repro/kernels/masked_attn.py:{replaces[k]}",
               "max_abs_err": max(c["max_abs_err"] for c in per[k]),
               "ms": head["ms"], "plain_ms": head["plain_ms"],
               "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
               "library_ms": head["library_ms"],
               "library_call": "torch.bmm, head mask folded into an operand",
               "shape": dict(ATTN_SHAPE, C=5), "mixes": per[k]}
        row.update(blocks=head["blocks"])
        row.update({x: head[x] for x in ("cluster", "threads", "large") if x in head})
        out.append(row)
    return out


def rwkv_design_work(N, c, nc):
    """What csrc/rwkv_chunk.cu does for one head over nc chunks of c: fp32
    flops (2 a FMA, as executed, padded rows included) and exponentials.
    State pass, a chunk: boundaries and runs (2·c·N), k rescaled (c·N
    exponentials, 3·c·N flops), ΔS (2·c·N²). Output pass, a 16-row
    sub-block T at t0 (nt rows): its boundaries (t0·N), run (2·nt·N), r
    rescaled twice (2·nt·N exponentials, 3·nt·N flops), the diagonal
    sub-block (nt(nt-1)/2·N exponentials and 4 flops each, the bonus 3·nt·N,
    its product with v 2·16·16·N), the keys before t0 (t0·N exponentials,
    3·t0·N flops; scores and their product with v 4·16·t0·N), the inter term
    (2·16·N²). The carry: N² exponentials and 2·N² flops a chunk."""
    sb, nb = 16, -(-c // 16)
    flops = nc * (2 * c * N + 3 * c * N + 2 * c * N * N)
    exps = nc * c * N
    for T in range(nb):
        t0, nt = 16 * T, min(16, c - 16 * T)
        flops += nc * (t0 * N + 2 * nt * N + 3 * nt * N + 4 * nt * (nt - 1) // 2 * N
                       + 3 * nt * N + 2 * sb * sb * N + 3 * t0 * N + 4 * sb * t0 * N
                       + 2 * sb * N * N)
        exps += nc * (2 * nt * N + nt * (nt - 1) // 2 * N + t0 * N)
    return flops + 2 * nc * N * N, exps + nc * N * N


def rwkv_work(B, S, H, N, c, elem):
    """The least work of the WKV function from a zero state, and what the
    kernel's chunked form does on top of it. Bytes: r, k, v read in their
    type and logw, u in fp32 once, y and the final state written once.
    Operations: the per-token recurrence, for each token and head S <-
    diag(w) S + kᵀv (3·N² flops) and y = r·S + (r·(u⊙k)) v (2·N² + 4·N),
    with N decay exponentials. The chunked form (the diagnostic): the
    kernel's own count (rwkv_design_work), and the literal form's c(c-1)/2
    (t, j) pairs a chunk below the diagonal with N exponentials each, which
    the sub-block factoring avoids. Returns (bytes, flops, exponentials,
    chunked)."""
    tok = B * S * H * N
    nbytes = 3 * tok * elem + tok * 4 + H * N * 4 + tok * 4 + B * H * N * N * 4
    flops, exps = B * S * H * (5 * N * N + 4 * N), tok
    dflops, dexps = rwkv_design_work(N, c, S // c)
    chunked = {"flops": B * H * dflops, "exponentials": B * H * dexps,
               "literal_form_exponentials": B * H * (S // c) * (c * (c - 1) // 2 * N
                                                                + 2 * c * N + N)}
    chunked["fp32_flops_ms"] = chunked["flops"] / FP32_FLOPS * 1e3
    chunked["exp_ms"] = chunked["exponentials"] / SFU_EXP_PER_S * 1e3
    return nbytes, flops, exps, chunked


def phase_rwkv_kernels(torch, np, dev="cuda"):
    """The chunked RWKV-6 scan at RWKV-6-3B's prefill shape (bf16 r/k/v, logw
    over the model's decay range, u at the model's scale), at logw = -8,
    which must stay finite, and at chunk 256; y and the state against the
    plain version at relative ∞-norm <= 1e-4 (both fp32 inside, only the
    order of the sums differs), and two calls the same bits. ``ms`` is
    device time from a CUDA graph of calls, ``call_ms`` one call between
    two CUDA events (how B12 was timed up to PR 17). invariant_stats at STATS_SHAPES against its plain version at
    <= 1e-5 (fp32) and <= 5e-2 (bf16), the reference's tolerances. Bounds:
    bytes at 3.35 TB/s, fp32 flops at 67 TFLOP/s, exponentials at
    SFU_EXP_PER_S, each of the function's least work (rwkv_work); the
    largest bounds the kernel. The chunked form's own count is reported
    beside it. invariant_stats' launches are those of its checks here,
    two calls a shape (one counted launch each, the same bits), counted
    before any timing."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import invariant_stats as stats
    from repro_torch.kernels import rwkv_chunk as rwkv
    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    B, S, H, N, c = (RWKV_SCAN_SHAPE[k] for k in ("B", "S", "H", "N", "chunk"))
    r, k, v = (torch.randn(B, S, H, N, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    u = 0.1 * torch.randn(H, N, generator=g, device=dev)
    w = (torch.rand(H, N, generator=g, device=dev) * 5 - 6
         + 0.1 * torch.randn(B, S, H, N, generator=g, device=dev))
    cases = {"model_decay": (-torch.exp(w), c), "logw=-8": (torch.full_like(w, -8.0), c),
             "chunk256": (-torch.exp(w), 256)}
    per = []
    for name, (logw, cc) in cases.items():
        run = lambda: rwkv.rwkv_chunk_scan(r, k, v, logw, u, chunk=cc)
        plain = lambda: rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=cc)
        (y, st), (y2, st2), (yp, sp) = run(), run(), plain()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
              f"rwkv_chunk_scan[{name}] not finite")
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"rwkv_chunk_scan[{name}]: two calls differ")
        errs = {"y": rel_inf(y, yp), "state": rel_inf(st, sp)}
        check(max(errs.values()) <= 1e-4, f"rwkv_chunk_scan[{name}] rel err {errs}")
        nbytes, flops, exps, chunked = rwkv_work(B, S, H, N, cc, 2)
        terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                 "fp32_flops_ms": flops / FP32_FLOPS * 1e3,
                 "exp_ms": exps / SFU_EXP_PER_S * 1e3}
        per.append({"case": name, "chunk": cc, "rel_err": errs,
                    "max_abs_err": max(float((y - yp).abs().max()),
                                       float((st - sp).abs().max())),
                    "ms": graph_ms(run, torch), "call_ms": time_ms(run, torch),
                    "plain_ms": time_ms(plain, torch, n=10),
                    "bound_ms": max(terms.values()),
                    "bound_by": "bytes" if terms["bytes_ms"] >= max(terms.values())
                    else "operations", "bound_terms": terms,
                    "exponentials": exps, "flops": flops, "bytes": nbytes,
                    "chunked_form": chunked})
    head = per[0]
    out = [{"name": "rwkv_chunk_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv_chunk.cu",
            "replaces": "src/repro/kernels/rwkv_chunk.py:27",
            "max_abs_err": max(p["max_abs_err"] for p in per),
            "ms": head["ms"], "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shape": RWKV_SCAN_SHAPE, "mixes": per}]
    out.append(rwkv_bf16_kernel(torch, rwkv, r, k, v, -torch.exp(w), u))
    del r, k, v, u, w, cases

    per, stats_launches = [], 0
    for d_in, n, dt in STATS_SHAPES:
        dtype = getattr(torch, dt)
        w0 = torch.randn(d_in, n, generator=g, device=dev)
        w1 = (w0 + 0.02 * torch.randn(d_in, n, generator=g, device=dev)).to(dtype)
        w0 = w0.to(dtype)
        run = lambda: stats.invariant_stats(w0, w1)
        plain = lambda: stats.invariant_stats_plain(w0, w1)
        n0 = stats.launches.n
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        check(stats.launches.n - n0 == 2, f"invariant_stats[{d_in}x{n}/{dt}]: "
              f"{stats.launches.n - n0} launches counted for 2 calls")
        check(torch.equal(got, again), f"invariant_stats[{d_in}x{n}/{dt}]: two calls differ")
        stats_launches += stats.launches.n - n0
        err = rel_inf(got, want)
        tol = 1e-5 if dtype == torch.float32 else 5e-2
        check(err <= tol, f"invariant_stats[{d_in}x{n}/{dt}] rel err {err}")
        elem = w0.element_size()
        b_ms, b_by = bound_ms(2 * d_in * n * elem + n * 4, 4 * d_in * n, FP32_FLOPS)
        t_ms = graph_ms(run, torch)
        per.append({"case": f"{d_in}x{n}/{dt}", "rel_err": err,
                    "max_abs_err": float((got - want).abs().max()),
                    "ms": t_ms, "call_ms": time_ms(run, torch),
                    "plain_ms": graph_ms(plain, torch),
                    "host_ms": time_loop_ms(run, torch),
                    "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / t_ms,
                    "geometry": stats.launch_geometry(d_in, n, elem, _build.sm_count(dev))})
    head = per[0]
    out.append({"name": "invariant_stats", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/invariant_stats.cu",
                "replaces": "src/repro/kernels/invariant_stats.py:28",
                "max_abs_err": max(p["max_abs_err"] for p in per),
                "ms": head["ms"], "call_ms": head["call_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": None, "launches": stats_launches,
                "launches_from": "its checks in the kernels phase, before timing "
                                 "(on no main path)",
                "shape": dict(d_in=1024, n=1024, dtype="float32"), "mixes": per})
    return out


RWKV_BF16_TOL = dict(rel2=5e-4, inf=1e-2, state=1e-4)


def rwkv_bf16_kernel(torch, rwkv, r, k, v, logw, u):
    """B12's bf16 chunk form (rwkv_out_bf16_kernel) at RWKV_SCAN_SHAPE
    against its plain form: relative 2-norm <= 5e-4 and ∞-norm <= 1e-2 (a
    score whose bf16 rounding flips is a sparse error: a 1e-7 relative
    change of logw moves the plain form by ~3e-5 in 2-norm; the fp32 form
    lies ~2e-3 away, reported as ``fp32_form_rel_err_2``), the state
    1e-4, two calls the same bits; its packed r·k (mul.rn.bf16x2) the
    bits of the fp32 product rounded to bf16 for every pair of bf16 values.
    Bound: bytes, and the literal form's exponentials at SFU_EXP_PER_S
    (rwkv_work), which this form must take: each (t, j, n)'s decay is
    rounded on its own. ``share_of_bound`` is bound_ms / ms."""
    c = RWKV_SCAN_SHAPE["chunk"]
    B, S, H, N = r.shape
    run = lambda: rwkv.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=c)
    plain = lambda: rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=c,
                                               chunk_dtype=torch.bfloat16)
    (y, st), (y2, st2), (yp, sp) = run(), run(), plain()
    y32, _ = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=c)
    product = rwkv.bf16_product_check()
    torch.cuda.synchronize()
    check(product["pairs_differing"] == 0,
          f"rwkv_out_bf16_kernel's packed r·k differs from the fp32 product rounded: {product}")
    check(bool(torch.isfinite(y).all()), "rwkv_chunk_scan_bf16 not finite")
    check(torch.equal(y, y2) and torch.equal(st, st2), "rwkv_chunk_scan_bf16: two calls differ")
    errs = {"rel2": rel2(y, yp), "inf": rel_inf(y, yp), "state": rel_inf(st, sp)}
    check(all(errs[key] <= tol for key, tol in RWKV_BF16_TOL.items()),
          f"rwkv_chunk_scan_bf16 vs its plain form {errs}, limits {RWKV_BF16_TOL}")
    nbytes, _, _, chunked = rwkv_work(B, S, H, N, c, 2)
    exps = chunked["literal_form_exponentials"]
    terms = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "exp_ms": exps / SFU_EXP_PER_S * 1e3}
    b_ms = max(terms.values())
    t_ms = graph_ms(run, torch)
    return {"name": "rwkv_chunk_scan_bf16", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rwkv_chunk.cu",
            "replaces": "src/repro/models/rwkv6.py:113",
            "max_abs_err": max(float((y - yp).abs().max()), float((st - sp).abs().max())),
            "ms": t_ms, "call_ms": time_ms(run, torch),
            "plain_ms": time_ms(plain, torch, n=10), "bound_ms": b_ms,
            "bound_by": "bytes" if terms["bytes_ms"] >= b_ms else "operations",
            "bound_terms": terms, "share_of_bound": b_ms / t_ms, "library_ms": None,
            "rel_err": errs, "fp32_form_rel_err_2": rel2(yp, y32),
            "packed_product_check": product,
            "blocks": rwkv.bf16_items(B, S, H, c),
            "shape": RWKV_SCAN_SHAPE}


def plain_train(torch):
    """ops.masked_ffn_train with the plain forward, dx and dW versions."""
    from repro_torch.kernels import masked_ffn as ffn

    class PlainTrain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, wi, wo, m, wg, act):
            ctx.act = act
            ctx.save_for_backward(x, wi, wo, m, wg)
            return ffn.masked_ffn_batch_plain(x, wi, wo, m, wg, act)

        @staticmethod
        def backward(ctx, gy):
            x, wi, wo, m, wg = ctx.saved_tensors
            dx = ffn.masked_ffn_dx_plain(gy, x, wi, wo, m, wg, ctx.act)
            dwi, dwo, dwg = ffn.masked_ffn_dw_plain(gy, x, wi, wo, m, wg, ctx.act)
            return dx, dwi, dwo, None, dwg, None
    return lambda x, wi, wo, m, w_gate=None, act="silu": PlainTrain.apply(
        x, wi, wo, m.float().contiguous(), w_gate, act)


def plain_heads(torch):
    """ops.masked_head_proj and ops.masked_head_merge with the plain
    forward, d-input and dW versions."""
    from repro_torch.kernels import masked_attn as attn

    def make(fwd, d_in, d_w):
        class PlainHeads(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a, w, m):
                ctx.save_for_backward(a, w, m)
                return fwd(a, w, m)

            @staticmethod
            def backward(ctx, gy):
                a, w, m = ctx.saved_tensors
                return d_in(gy, w, m), d_w(gy, a, m), None
        return lambda a, w, m: PlainHeads.apply(a, w, m.float().contiguous())
    return (make(attn.masked_head_proj_plain, attn.masked_head_proj_dx_plain,
                 attn.masked_head_proj_dw_plain),
            make(attn.masked_head_merge_plain, attn.masked_head_merge_da_plain,
                 attn.masked_head_merge_dw_plain))


def swap_in_plain(ops):
    """Point the models' kernel calls at the plain versions; returns undo."""
    import torch
    from repro_torch.kernels import decode_gqa as gqa
    from repro_torch.kernels import masked_ffn as ffn
    from repro_torch.kernels import rwkv_chunk as rwkv
    names = ("masked_ffn_batch", "decode_gqa", "masked_ffn_train",
             "masked_head_proj", "masked_head_merge", "rwkv_chunk_scan",
             "rwkv_chunk_scan_bf16")
    saved = {n: getattr(ops, n) for n in names}
    ops.rwkv_chunk_scan_bf16 = lambda *a, **kw: rwkv.rwkv_chunk_scan_plain(
        *a, chunk_dtype=torch.bfloat16, **kw)
    ops.masked_ffn_batch = lambda x, wi, wo, m, w_gate=None, act="silu": \
        ffn.masked_ffn_batch_plain(x, wi, wo, m, w_gate, act)
    ops.decode_gqa = gqa.decode_gqa_plain
    ops.rwkv_chunk_scan = rwkv.rwkv_chunk_scan_plain
    ops.masked_ffn_train = plain_train(torch)
    ops.masked_head_proj, ops.masked_head_merge = plain_heads(torch)

    def undo():
        for n, fn in saved.items():
            setattr(ops, n, fn)
    return undo


def small_masks(torch, cfg, params, B):
    """(prefill masks, decode masks) of a small case: a decoder with dense
    FFNs decodes under per-row rate-0.5 masks (the serving layout);
    SMALL_MOE_MASKED runs under FLuID's layer masks from build_masks (r
    0.5 over expert units, whole experts dropped; stats against a second
    init) in both; the others under none."""
    from repro_torch.core import transformer_hooks as hooks
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serving import rate_masks
    from repro_torch.models import model
    if cfg.name == SMALL_MOE_MASKED:
        other = model.init_params(cfg, seed=1, device="cpu")
        m = hooks.build_masks(hooks.ffn_unit_stats(params, other, cfg), cfg, 0.5,
                              block128=False, drop_experts=True)
        return m, m
    if cfg.n_experts or cfg.is_encdec:
        return None, None
    return None, tree_map(lambda m: m[:, None, None, :].expand(-1, B, 1, -1).contiguous(),
                          rate_masks(cfg, 0.5, policy="random", seed=1))


def small_case(torch, np, arch, absorb, S, C, steps):
    """One smoke-size fp32 model: a prefill into a C-slot cache (frames of
    S positions for an encoder-decoder) and ``steps`` decode steps, under
    small_masks, on the card (kernels) and on the CPU (plain versions) from
    the same params; returns the largest logit difference, which must be
    <= 1e-3."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    cpu = model.init_params(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.cuda(), cpu)
    B = 3
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, 256, (B, S)))
    frames = torch.from_numpy((rng.randn(B, S, cfg.d_model) * 0.1).astype(np.float32))
    seq_masks, masks = small_masks(torch, cfg, cpu, B)
    on = lambda m, dev: None if m is None else tree_map(lambda t: t.to(dev), m)
    res = {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        batch = {"tokens": toks.to(dev)}
        if cfg.is_encdec:
            batch["frames"] = frames.to(dev)
        _, caches, _ = model.forward_seq(params, cfg, batch, masks=on(seq_masks, dev),
                                         want_cache=True, cache_len=C)
        tok, pos = toks[:, -1:].to(dev), torch.full((B,), S, device=dev)
        out = []
        for _ in range(steps):
            logits, caches = model.decode_step(params, cfg, caches, tok, pos,
                                               masks=on(masks, dev), mla_absorb=absorb)
            out.append(logits.float().cpu())
            tok, pos = torch.argmax(logits[:, -1], -1)[:, None], pos + 1
        res[name] = out
    errs = []
    for a, b in zip(res["cpu"], res["cuda"]):
        check(bool(torch.isfinite(b).all()), f"small[{arch}]: non-finite logits")
        errs.append(float((a - b).abs().max()))
    return max(errs)


def phase_small(torch, np):
    """SMALL_CASES' smoke-size fp32 models, card against CPU, logits
    within 1e-3: StableLM-2-12B, MiniCPM3-4B (baseline and absorbed MLA
    decode), RecurrentGemma-9B (its local-attention ring wraps), Command-R-35B,
    Granite-20B, DeepSeek-V2-Lite-16B (under FLuID's MoE masks), Arctic-480B
    and SeamlessM4T-Large v2."""
    per = {}
    for arch, absorb, S, C, steps in SMALL_CASES:
        key = arch + ("/absorb" if absorb else "")
        per[key] = small_case(torch, np, arch, absorb, S, C, steps)
        check(per[key] <= 1e-3, f"small[{key}]: cuda vs cpu logits differ by {per[key]}")
    return {"max_abs_err": max(per.values()), "per_config": per}


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
    results, summ = serve_engine(cfg, seed=0, device="cuda", params=params,
                                 **SERVE_QUEUE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()               # main path ends here
    counts = {k: counts[k] for k in SERVE_KERNELS}

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


def hold_each_launch(ops, worst, held=None):
    """Wrap the model's kernel calls so that each launch is also computed by
    its plain version on the same inputs; ``worst`` collects the largest
    relative error per kernel and ``held``, if given, counts the calls per
    kernel. Returns undo."""
    from repro_torch.kernels import decode_gqa as gqa
    from repro_torch.kernels import masked_ffn as ffn
    saved = ops.masked_ffn_batch, ops.decode_gqa
    held = {} if held is None else held

    def ffn_both(x, wi, wo, m, w_gate=None, act="silu"):
        y = saved[0](x, wi, wo, m, w_gate=w_gate, act=act)
        ref = ffn.masked_ffn_batch_plain(x, wi, wo, m, w_gate, act)
        worst["masked_ffn_batch"] = max(worst["masked_ffn_batch"], rel_inf(y, ref))
        held["masked_ffn_batch"] = held.get("masked_ffn_batch", 0) + 1
        check(bool((y[m.sum(1) == 0] == 0).all()), "step: dropped row not 0")
        return y

    def gqa_both(q, k, v, lengths):
        y = saved[1](q, k, v, lengths)
        worst["decode_gqa"] = max(worst["decode_gqa"],
                                  rel_inf(y, gqa.decode_gqa_plain(q, k, v, lengths)))
        held["decode_gqa"] = held.get("decode_gqa", 0) + 1
        return y
    ops.masked_ffn_batch, ops.decode_gqa = ffn_both, gqa_both

    def undo():
        ops.masked_ffn_batch, ops.decode_gqa = saved
    return undo


def step_state(torch, np, params, cfg):
    """A full-width decode step's inputs from a real prefill: 8 rows of a
    576-slot cache filled to 256 − 16i, rates cycling 1.0/0.5/0.25 and the
    last row dropped. An MoE or encoder-decoder model, which serve()
    serves with no masks, takes none (rates None); an encoder-decoder's
    prefill reads 256 frames of randn · 0.1, as serve() draws them.
    Returns (caches, tok, pos, masks, rates)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serving import rate_masks
    from repro_torch.models import model
    from repro_torch.models.layers import cdtype
    B, S, C = 8, 256, 576
    dev = params["final_norm"]["scale"].device
    rng = np.random.RandomState(2)
    toks = torch.from_numpy(rng.randint(0, 256, (B, S))).to(dev)
    batch = {"tokens": toks}
    if cfg.is_encdec:
        frames = rng.randn(B, S, cfg.d_model).astype(np.float32) * 0.1
        batch["frames"] = torch.from_numpy(frames).to(dev, cdtype(cfg))
    _, caches, _ = model.forward_seq(params, cfg, batch, want_cache=True, cache_len=C)
    pos = torch.tensor([S - 16 * i for i in range(B)], device=dev)
    tok = toks[torch.arange(B, device=dev), pos - 1][:, None]
    if cfg.n_experts or cfg.is_encdec:
        return caches, tok, pos, None, None
    rates = [(1.0, 0.5, 0.25)[i % 3] for i in range(B - 1)] + [0.0]
    rows = [rate_masks(cfg, r) if r > 0 else tree_map(torch.zeros_like,
                                                      rate_masks(cfg, 1.0))
            for r in rates]
    masks = tree_map(lambda *ms: torch.stack(ms, 1)[:, :, None].to(dev), *rows)
    return caches, tok, pos, masks, rates


def phase_step(torch, np, params, cfg):
    """One full-width decode step from a real prefill. Every kernel launch
    in it is held against its plain version on the same inputs (relative
    ∞-norm <= 1e-2); then the whole step is rerun with the plain versions
    swapped in. End to end the two differ by bf16 rounding compounded over
    40 layers: relative 2-norm <= 2e-2 is required, the ∞-norm is reported."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers, model
    caches, tok, pos, masks, rates = step_state(torch, np, params, cfg)
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


def phase_decode_routes(torch, np, params, cfg, state):
    """The decode route the dry-run's sequence-sharded-cache variants
    select, on the step phase's full-width StableLM-2-12B decode step, held
    against the default route (B11) at the step phase's gate (relative
    2-norm <= 2e-2 of the hidden state and the logits): grouped_decode=True
    (the grouped attention _sdpa_grouped, which launches no decode_gqa) on
    the step's own rows."""
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import layers, model
    caches, tok, pos, masks = state
    saved = tree_map(lambda t: t.clone(), caches)

    def hidden(grouped):
        tree_map(lambda c, s0: c.copy_(s0), caches, saved)
        ops.reset_launch_counts()
        h = model.decode_hidden(params, cfg, caches, tok, pos, masks=masks,
                                grouped_decode=grouped)
        return h, layers.lm_logits(params["tok"], h, cfg), ops.launch_counts()["decode_gqa"]

    hd, ld, nd = hidden(False)
    hs, ls, ns = hidden(True)
    check(nd == cfg.n_layers and ns == 0,
          f"decode_routes: decode_gqa launched {nd} (default) and {ns} (seq) times")
    seq = {"hidden_rel_err_2": rel2(hs, hd), "logits_rel_err_2": rel2(ls, ld),
           "greedy_agreement": float((ls.argmax(-1) == ld.argmax(-1)).float().mean()),
           "decode_gqa_launches": ns}
    tree_map(lambda c, s0: c.copy_(s0), caches, saved)
    del saved
    torch.cuda.synchronize()
    check(seq["hidden_rel_err_2"] <= 2e-2 and seq["logits_rel_err_2"] <= 2e-2,
          f"decode_routes: seq route vs the default route {seq}")
    return {"seq": seq}


def phase_dryrun(torch, np, zoo):
    """The meta-device dry-run (launch/dryrun.dry_step) against what the
    card ran. FLOPs: the meta count of train_zoo's dense step (StableLM-2-12B,
    8 of 40 layers, batch 4 x 256, AdamW) must equal FlopCounterMode's count
    around that step on the card. Argument bytes: the meta params and AdamW
    state must equal the growth of torch.cuda.memory_allocated() while
    train_zoo built them, within ALLOC_ROUNDING a tensor. Printed, not
    gated: the meta peak estimate beside max_memory_allocated after the two
    full steps, and a serving decode step's floor of bytes (bf16 params,
    SERVE_QUEUE's 8 rows of 576 slots) beside decode_bytes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import dryrun
    from repro_torch.models import model
    cfg = get_config(ZOO_TRAIN["arch"]).with_overrides(n_layers=ZOO_TRAIN["layers"])
    shape = InputShape("train_zoo", ZOO_TRAIN["seq"], ZOO_TRAIN["batch"], "train")
    t0 = time.perf_counter()
    terms, mem = dryrun.dry_step(cfg, shape)
    meta_s = time.perf_counter() - t0
    parts = mem["argument_breakdown"]
    built = parts["params"] + parts["opt_state"]
    card = zoo["card_counts"]
    out = {"train": {"meta_flops": terms.flops, "card_flops": card["flops"],
                     "meta_param_and_state_bytes": built, "card_allocated_bytes": card["built_bytes"],
                     "tensors": card["tensors"],
                     "meta_peak_estimate_GB": mem["peak_estimate"] / 1e9,
                     "card_max_memory_allocated_GB": card["peak_bytes"] / 1e9,
                     "peak_ratio_meta_over_card": mem["peak_estimate"] / card["peak_bytes"],
                     "saved_for_backward_GB": mem["saved_for_backward_bytes"] / 1e9,
                     "roofline": terms.to_dict(), "meta_s": meta_s}}
    check(terms.flops == card["flops"],
          f"dryrun: meta FLOPs {terms.flops} != the card's {card['flops']}")
    check(abs(built - card["built_bytes"]) <= ALLOC_ROUNDING * card["tensors"],
          f"dryrun: meta argument bytes {built} vs the card's allocation {card['built_bytes']} "
          f"({card['tensors']} tensors)")
    q = SERVE_QUEUE
    scfg = get_config("stablelm-12b").with_overrides(param_dtype="bfloat16")
    dshape = InputShape("serve_decode", q["prompt_len"] + q["gen_len"], q["batch"], "decode")
    dterms, dmem = dryrun.dry_step(scfg, dshape)
    mparams = model.init_params(scfg, device="meta")
    want = decode_bytes(scfg, mparams, q)
    check(param_bytes(tree_leaves(mparams)) == dmem["argument_breakdown"]["params"],
          "dryrun: the decode step's param bytes differ from the model's")
    out["decode"] = {"meta_bytes_min": dterms.bytes_accessed, "decode_bytes": want,
                     "ratio": dterms.bytes_accessed / want,
                     "meta_bytes_unfused": dterms.bytes_unfused, "meta_flops": dterms.flops,
                     "note": "bytes_min reads every param (the embedding table too), the "
                             "whole caches and writes one slot; decode_bytes leaves out "
                             "the embedding table and the caches"}
    return out


def rwkv_bf16_prefill(torch, np, params, cfg, dev="cuda"):
    """RWKV-6-3B at full width through make_prefill_step under the dry-run's
    rwkv_c128_bf16 variant (chunk 128, the bf16 chunk form): one prompt of
    RWKV_SCAN_SHAPE's 512 tokens. The main path: B12's bf16 form launched
    once a layer, its fp32 form never. Then the same prefill with each
    launch held against the plain bf16 form (RWKV_BF16_TOL), bitwise the
    same logits, which are finite; their gap to the fp32 chunk form's at
    chunk 128 is reported (the stack amplifies any rounding: serve_rwkv)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv_chunk as rwkv
    from repro_torch.launch import dryrun, steps
    bcfg = cfg.with_overrides(**dryrun.VARIANTS["rwkv_c128_bf16"]["cfg_overrides"])
    S = RWKV_SCAN_SHAPE["S"]
    batch = {"tokens": torch.from_numpy(
        np.random.RandomState(4).randint(0, 256, (1, S)).astype(np.int64)).to(dev)}
    prefill = steps.make_prefill_step(bcfg)
    ops.reset_launch_counts()                  # main path starts here
    lb, _ = prefill(params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()               # main path ends here
    check(counts["rwkv_chunk_scan_bf16"] == cfg.n_layers and counts["rwkv_chunk_scan"] == 0,
          f"serve_rwkv: the bf16 prefill launched {counts}")
    saved = ops.rwkv_chunk_scan_bf16
    worst = {"rel2": 0.0, "inf": 0.0, "state": 0.0, "held": 0}

    def both(r, k, v, logw, u, chunk=64, state=None):
        y, st = saved(r, k, v, logw, u, chunk=chunk, state=state)
        yp, sp = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=chunk, state=state,
                                            chunk_dtype=torch.bfloat16)
        for key, e in (("rel2", rel2(y, yp)), ("inf", rel_inf(y, yp)), ("state", rel_inf(st, sp))):
            worst[key] = max(worst[key], e)
        worst["held"] += 1
        return y, st
    ops.rwkv_chunk_scan_bf16 = both
    try:
        lh, _ = prefill(params, batch)
    finally:
        ops.rwkv_chunk_scan_bf16 = saved
    lf, _ = steps.make_prefill_step(bcfg.with_overrides(rwkv_chunk_dtype="float32"))(params, batch)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lb).all()), "serve_rwkv: the bf16 prefill's logits are not finite")
    check(torch.equal(lb, lh), "serve_rwkv: the bf16 prefill gave other bits when held")
    check(worst["held"] == cfg.n_layers and all(worst[k] <= t for k, t in RWKV_BF16_TOL.items()),
          f"serve_rwkv: bf16 launches vs the plain bf16 form {worst}, limits {RWKV_BF16_TOL}")
    line = {"variant": "rwkv_c128_bf16", "tokens": S, "launches": counts["rwkv_chunk_scan_bf16"],
            "held": worst, "logits_vs_fp32_form_rel_err_2": rel2(lb, lf)}
    return line, {"rwkv_chunk_scan_bf16": counts["rwkv_chunk_scan_bf16"]}


def phase_train_rwkv(torch, np, dev="cuda"):
    """RWKV-6-3B at full width (d 2560, 40 heads of 64, d_ff 8960, vocab
    65536) on 2 of its 32 layers, fp32 params and compute, AdamW, block
    remat: one make_train_step step of RWKV_TRAIN's batch on the card and
    the same step on the CPU from the same params (drawn on the CPU, seed
    0) and batch. The loss within 1e-4 relative, each param's gradient
    (make_grads_fn, the step's own) within 1e-3 relative 2-norm. The time
    mix trains through the plain chunked form under autograd: B12 (either
    form) launched 0 times in the step; serve_rwkv's prefills launch it."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer
    cfg = get_config(RWKV_TRAIN["arch"]).with_overrides(
        n_layers=RWKV_TRAIN["layers"], dtype="float32", param_dtype="float32")
    B, S = RWKV_TRAIN["batch"], RWKV_TRAIN["seq"]
    cpu = model.init_params(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    bcpu = train.synth_batch(np.random.RandomState(0), cfg, B, S + 1, "cpu")
    bcard = tree_map(lambda t: t.to(dev), bcpu)
    grads_of = steps.make_grads_fn(cfg)        # the step's own gradients
    (_, _), gcard = grads_of(card, bcard)
    (_, _), gcpu = grads_of(cpu, bcpu)
    step = steps.make_train_step(cfg)
    opt = make_optimizer(cfg.optimizer)
    ops.reset_launch_counts()                  # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card, _, met = step(card, opt.init(card), bcard)
    loss = float(met["loss"])
    step_ms = 1e3 * (time.perf_counter() - t0)
    counts = ops.launch_counts()               # main path ends here
    check(set(counts.values()) == {0}, f"train_rwkv: the train step launched {counts}")
    cpu, _, met_cpu = step(cpu, opt.init(cpu), bcpu)
    loss_cpu = float(met_cpu["loss"])
    errs = [rel2(a.cpu(), b) for a, b in zip(tree_leaves(gcard), tree_leaves(gcpu))
            if float(b.norm()) > 0]
    loss_rel = abs(loss - loss_cpu) / abs(loss_cpu)
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S,
           "params": model.count_params(cpu), "loss": loss, "loss_cpu": loss_cpu,
           "loss_rel_err": loss_rel, "grad_rel_err_2_worst": max(errs), "grad_leaves": len(errs),
           "step_ms": step_ms, "launches": counts,
           "params_after_step_max_abs_diff": max(float((a.cpu() - b).abs().max())
                                                 for a, b in zip(tree_leaves(card), tree_leaves(cpu)))}
    check(np.isfinite(loss) and loss_rel <= RWKV_TRAIN_TOL["loss"],
          f"train_rwkv: card vs CPU loss {out}")
    check(max(errs) <= RWKV_TRAIN_TOL["grads"], f"train_rwkv: card vs CPU gradients {out}")
    return out


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


def rel2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def hold_rwkv_launches(ops, worst):
    """Wrap ops.rwkv_chunk_scan so that each launch is also computed by its
    plain version on the same inputs, and rwkv6.tmix_seq so that each
    layer's time mix is also computed with the plain version from the same
    input; ``worst`` collects the largest relative ∞-norm errors of y and
    the state, the largest relative 2-norm error of a layer's time-mix
    output, and counts the launches. Returns undo."""
    from repro_torch.kernels import rwkv_chunk as rwkv
    from repro_torch.models import rwkv6
    saved, saved_tmix = ops.rwkv_chunk_scan, rwkv6.tmix_seq

    def both(r, k, v, logw, u, chunk=64, state=None):
        y, st = saved(r, k, v, logw, u, chunk=chunk, state=state)
        yp, sp = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=chunk, state=state)
        worst["y"] = max(worst["y"], rel_inf(y, yp))
        worst["state"] = max(worst["state"], rel_inf(st, sp))
        worst["launches"] += 1
        return y, st

    def tmix_both(p, x, cfg, shift_in=None, state_in=None):
        out = saved_tmix(p, x, cfg, shift_in, state_in)
        ops.rwkv_chunk_scan = rwkv.rwkv_chunk_scan_plain
        try:
            plain = saved_tmix(p, x, cfg, shift_in, state_in)
        finally:
            ops.rwkv_chunk_scan = both
        worst["layer_out"] = max(worst["layer_out"], rel2(out[0], plain[0]))
        return out
    ops.rwkv_chunk_scan, rwkv6.tmix_seq = both, tmix_both

    def undo():
        ops.rwkv_chunk_scan, rwkv6.tmix_seq = saved, saved_tmix
    return undo


def phase_serve_rwkv(torch, np, dev="cuda"):
    """RWKV-6-3B at full width (32 layers, d 2560, 40 heads of 64, d_ff
    8960, vocab 65536), bf16 weights from seed 0, through serve_engine:
    RWKV_QUEUE's 16 requests, prompts of exactly 512 tokens, gens 32-64, 8
    slots, chunk 8, rates cycling 1.0/0.5/0.25 with ordered masks. The
    chunked scan must launch once per layer per prefill. Then request 1's
    prefill (rate 0.5) again with every launch held against the plain
    version (relative ∞-norm <= 1e-4) and every layer's time-mix output
    against the same layer's with the plain version from the same input
    (relative 2-norm <= 2e-2, the step phase's gate, in bf16). The logits
    of that prefill are held against the prefill with the plain versions
    swapped in by the noise floor: this random-weight bf16 stack amplifies
    fp32 rounding to O(0.1) over 32 layers, so the plain scan is also run
    with 1e-7 relative noise on its y (RWKV_NOISE_SEEDS), and the kernel's
    logit gap must be at most E2E_GAP_FACTOR x the largest noisy gap, its
    greedy agreement at least the least noisy agreement less
    E2E_AGREEMENT_MARGIN. Last, the busy share of 3 decode
    steps of 8 slots. A decode step reads every weight but the embedding table, and
    reads and writes every slot's state: that is its byte bound."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv_chunk as rwkv
    from repro_torch.launch.serve import serve_engine
    from repro_torch.launch.serving import rate_masks
    from repro_torch.models import model
    cfg = get_config("rwkv6-3b")
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    q = RWKV_QUEUE
    ops.reset_launch_counts()                  # main path starts here
    t0 = time.perf_counter()
    results, summ = serve_engine(cfg, seed=0, device=dev, params=params, **q)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()               # main path ends here
    counts = {"rwkv_chunk_scan": counts["rwkv_chunk_scan"]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n, L = q["n_requests"], q["prompt_len"]
    check(len(results) == n, f"serve_rwkv: {len(results)} of {n} requests finished")
    check(summ["prefills"] == n, f"serve_rwkv: {summ['prefills']} prefills for {n} requests")
    rng = np.random.RandomState(0)             # serve_engine's draws, replayed
    prompts = []
    for rid in range(n):
        prompts.append(rng.randint(0, 256, (L,), dtype=np.int32))
        g = int(rng.randint(q["gen_len"] // 2, q["gen_len"] + 1))
        toks = results[rid]
        check(len(toks) == g, f"serve_rwkv: request {rid} has {len(toks)} of {g} tokens")
        check(bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
              f"serve_rwkv: request {rid} has out-of-vocab tokens")
    check(counts["rwkv_chunk_scan"] == cfg.n_layers * summ["prefills"],
          f"serve_rwkv: rwkv_chunk_scan launched {counts['rwkv_chunk_scan']} times, "
          f"expected {cfg.n_layers} x {summ['prefills']} prefills")

    # request 1's prefill: each launch against its plain version, then the
    # logits against the prefill with the plain versions swapped in
    toks = torch.from_numpy(prompts[1][None].astype(np.int64)).to(dev)
    masks = tree_map(lambda m: m[:, None, None].to(dev), rate_masks(cfg, q["rates"][1], seed=0))
    worst = {"y": 0.0, "state": 0.0, "launches": 0, "layer_out": 0.0}
    undo = hold_rwkv_launches(ops, worst)
    try:
        lk, _, _ = model.forward_seq(params, cfg, {"tokens": toks}, masks=masks)
    finally:
        undo()
    check(bool(torch.isfinite(lk).all()), "serve_rwkv: non-finite prefill logits")
    check(worst["launches"] == cfg.n_layers,
          f"serve_rwkv: held {worst['launches']} launches in a prefill of {cfg.n_layers} layers")
    check(max(worst["y"], worst["state"]) <= 1e-4,
          f"serve_rwkv: per-launch kernel vs plain {worst}")
    check(worst["layer_out"] <= 2e-2,
          f"serve_rwkv: a layer's time-mix output vs plain, relative 2-norm {worst}")

    def noisy_plain(seed):
        def scan(r, k, v, logw, u, chunk=64, state=None):
            y, st = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=chunk, state=state)
            gen = torch.Generator(device=y.device).manual_seed(seed)
            return y * (1 + 1e-7 * torch.randn(y.shape, generator=gen, device=y.device)), st
        return scan
    undo = swap_in_plain(ops)
    noise = []
    try:
        lp, _, _ = model.forward_seq(params, cfg, {"tokens": toks}, masks=masks)
        for seed in RWKV_NOISE_SEEDS:
            ops.rwkv_chunk_scan = noisy_plain(seed)
            ln, _, _ = model.forward_seq(params, cfg, {"tokens": toks}, masks=masks)
            noise.append((rel2(ln, lp), float((ln.argmax(-1) == lp.argmax(-1)).float().mean())))
            del ln
    finally:
        undo()
    torch.cuda.synchronize()
    e2e = {"logits_rel_err_2": rel2(lk, lp),
           "greedy_agreement": float((lk.argmax(-1) == lp.argmax(-1)).float().mean()),
           "plain_noise_1e-7_logits_rel_err_2": [a for a, _ in noise],
           "plain_noise_1e-7_greedy_agreement": [b for _, b in noise]}
    del lk, lp
    gap_limit = E2E_GAP_FACTOR * max(a for a, _ in noise)
    agree_limit = min(b for _, b in noise) - E2E_AGREEMENT_MARGIN
    check(e2e["logits_rel_err_2"] <= gap_limit,
          f"serve_rwkv: prefill logits vs plain {e2e['logits_rel_err_2']} > "
          f"{E2E_GAP_FACTOR} x the 1e-7 noise floor ({gap_limit}): {e2e}")
    check(e2e["greedy_agreement"] >= agree_limit,
          f"serve_rwkv: greedy agreement with plain {e2e['greedy_agreement']} < "
          f"the 1e-7 noise runs' least less {E2E_AGREEMENT_MARGIN} ({agree_limit}): {e2e}")

    # 3 decode steps of 8 slots from a batch-8 prefill, under the profiler
    B = q["batch"]
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (B, L))).to(dev)
    rows = [rate_masks(cfg, q["rates"][i % 3]) for i in range(B)]
    dmasks = tree_map(lambda *ms: torch.stack(ms, 1)[:, :, None].to(dev), *rows)
    logits, caches, _ = model.forward_seq(params, cfg, {"tokens": toks}, masks=dmasks,
                                          want_cache=True)
    tok = logits[:, -1].argmax(-1)[:, None]
    del logits
    prof = phase_profile(torch, params, cfg, (caches, tok, torch.full((B,), L, device=dev),
                                              dmasks))
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(caches))
    embed = params["tok"]["embed"]
    step_bytes = (sum(t.numel() * t.element_size() for t in leaves)
                  - embed.numel() * embed.element_size()
                  + B * cfg.d_model * embed.element_size() + 2 * state_bytes)
    bf16_line, bf16_counts = rwkv_bf16_prefill(torch, np, params, cfg, dev)
    steps = summ["decode_steps"]
    out = {"params": n_params, "param_gb": sum(t.numel() * t.element_size() for t in leaves) / 1e9,
           "init_s": init_s, "wall_s": wall_s,
           "prefills": summ["prefills"], "prefill_s": summ["prefill_s"],
           "prefill_ms_per_request": 1e3 * summ["prefill_s"] / summ["prefills"],
           "decode_s": summ["decode_s"], "decode_steps": steps,
           "decode_tokens": summ["decode_tokens"], "decode_tok_per_s": summ["tok_per_s"],
           "decode_ms_per_step": 1e3 * summ["decode_s"] / max(steps, 1),
           "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
           "decode_step_gb": step_bytes / 1e9, "state_gb": state_bytes / 1e9,
           "max_memory_allocated_gb": peak_gb, "allocated_before_serve_gb": base_gb,
           "launches": counts,
           "held_prefill": {"request": 1, "rate": q["rates"][1],
                            "per_launch_rel_err": {k: worst[k] for k in ("y", "state")},
                            "layer_out_rel_err_2": worst["layer_out"],
                            "launches": worst["launches"], **e2e},
           "profile": prof, "bf16_prefill": bf16_line}
    return out, {**counts, **bf16_counts}


def kernel_layers(cfg):
    """(layers whose decode step launches masked_ffn_batch, layers that
    launch decode_gqa): a dense FFN without biases (d_ff a multiple of
    128) launches B1; a full (unwindowed) GQA attention, not MLA, launches
    B11."""
    from repro_torch.models import transformer
    ffn = gqa = 0
    for seg in transformer.build_segments(cfg):
        for mixer, f in seg.unit:
            ffn += seg.repeats * (f == "dense" and not cfg.use_bias
                                  and cfg.d_ff % 128 == 0)
            gqa += seg.repeats * (mixer == "attn" and not cfg.use_mla)
    return ffn, gqa


def param_bytes(leaves):
    return sum(t.numel() * t.element_size() for t in leaves)


def reordered_plain(parts):
    """masked_ffn_batch_plain with each fp32 product summed over ``parts``
    contiguous pieces of its inner axis: the same arithmetic in another
    order, as a kernel sums."""
    from repro_torch.kernels import masked_ffn as ffn

    def mm(a, w):
        k = -(-a.shape[1] // parts)
        out = None
        for i in range(0, a.shape[1], k):
            t = a[:, i:i + k] @ w[i:i + k].float()
            out = t if out is None else out + t
        return out

    def plain(x, wi, wo, m, w_gate=None, act="silu"):
        xf = x.float()
        h = mm(xf, wi)
        h = ffn._ACTS[act](mm(xf, w_gate)) * h if w_gate is not None else ffn._ACTS[act](h)
        h = (h * m.float()).to(x.dtype)
        return mm(h.float(), wo).to(x.dtype)
    return plain


def zoo_step(torch, np, params, cfg):
    """phase_step for a zoo model: one full-width decode step from a real
    prefill (step_state), every kernel launch held against its plain
    version (relative ∞-norm <= 1e-2, dropped rows exactly 0) and counted,
    then the same step from the same caches (restored: RG-LRU's state and
    every cache are updated in place) with the plain versions swapped in:
    hidden and logits relative 2-norm <= 2e-2, phase_step's gate, unless
    the model's own fp32-order noise floor is above it. That floor is the
    largest gap between the plain step and the plain step with
    masked_ffn_batch's fp32 sums taken in ZOO_NOISE_PARTS other orders (no
    kernel in either); above 2e-2 the gate is STEP_NOISE_FACTOR x the floor
    (RecurrentGemma-9B's random bf16 stack: 2.8e-2 with no kernel at all;
    the others' floors are 1.4e-2 to 1.6e-2, under 2e-2). An MLA model also
    takes the absorbed decode from the same caches: its logits within 2e-2
    of the baseline step's. The caches are left as the step found them."""
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models import layers, model
    caches, tok, pos, masks, rates = step_state(torch, np, params, cfg)
    saved = tree_map(lambda t: t.clone(), caches)

    def restore():
        tree_map(lambda c, s0: c.copy_(s0), caches, saved)
    worst = {"masked_ffn_batch": 0.0, "decode_gqa": 0.0}
    held = {"masked_ffn_batch": 0, "decode_gqa": 0}
    undo = hold_each_launch(ops, worst, held)
    try:
        hk = model.decode_hidden(params, cfg, caches, tok, pos, masks=masks)
    finally:
        undo()
    lk = layers.lm_logits(params["tok"], hk, cfg)
    restore()
    undo = swap_in_plain(ops)
    try:
        hp = model.decode_hidden(params, cfg, caches, tok, pos, masks=masks)
        lp = layers.lm_logits(params["tok"], hp, cfg)
        noise = []
        for parts in ZOO_NOISE_PARTS:
            restore()
            ops.masked_ffn_batch = reordered_plain(parts)
            hn = model.decode_hidden(params, cfg, caches, tok, pos, masks=masks)
            noise.append(max(rel2(hn, hp), rel2(layers.lm_logits(params["tok"], hn, cfg), lp)))
    finally:
        undo()
    restore()
    torch.cuda.synchronize()
    n_ffn, n_gqa = kernel_layers(cfg)
    floor = max(noise)
    limit = 2e-2 if floor <= 2e-2 else STEP_NOISE_FACTOR * floor
    out = {"per_launch_rel_err": worst, "held_launches": held,
           "hidden_rel_err_inf": rel_inf(hk, hp), "logits_rel_err_inf": rel_inf(lk, lp),
           "hidden_rel_err_2": rel2(hk, hp), "logits_rel_err_2": rel2(lk, lp),
           "greedy_agreement": float((lk.argmax(-1) == lp.argmax(-1)).float().mean()),
           "plain_fp32_order_rel_err_2": dict(zip(ZOO_NOISE_PARTS, noise)),
           "step_limit_rel_err_2": limit,
           "positions": pos.tolist(), "rates": rates}
    if cfg.use_mla:
        la = model.decode_step(params, cfg, caches, tok, pos, masks=masks,
                               mla_absorb=True)[0]
        restore()
        out["absorb_logits_rel_err_2"] = rel2(la, lk)
        out["absorb_greedy_agreement"] = float((la.argmax(-1) == lk.argmax(-1))
                                               .float().mean())
        check(out["absorb_logits_rel_err_2"] <= 2e-2,
              f"{cfg.name} step: absorbed vs baseline MLA decode {out}")
    del saved
    check(bool(torch.isfinite(lk).all()), f"{cfg.name} step: non-finite logits")
    check(held == {"masked_ffn_batch": n_ffn, "decode_gqa": n_gqa},
          f"{cfg.name} step: held {held} launches, expected {n_ffn} and {n_gqa}")
    check(max(worst.values()) <= 1e-2, f"{cfg.name} step: per-launch kernel vs plain {worst}")
    check(out["hidden_rel_err_2"] <= limit and out["logits_rel_err_2"] <= limit,
          f"{cfg.name} step: kernel vs plain step {out}")
    return out, (caches, tok, pos, masks)


def phase_serve_zoo(torch, np, arch, queue, dev="cuda"):
    """A zoo model at full width, bf16 weights from init_params (seed 0),
    through serve_engine's queue: every request finishes with its gen
    length of in-vocab tokens (a recurrent model's prompts exactly
    prompt_len); masked_ffn_batch launched once a layer with a dense FFN a
    decode step, decode_gqa once a full GQA attention layer a step (0 for
    MLA and local attention); then zoo_step's held step and the profile of
    3 decode steps. A decode step's byte bound is every weight but the
    embedding table read once. Returns (line, main-path launch counts); the
    model is freed on return."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_engine
    from repro_torch.models import model
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()                  # main path starts here
    t0 = time.perf_counter()
    results, summ = serve_engine(cfg, seed=0, device=dev, params=params, **queue)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()               # main path ends here
    counts = {k: counts[k] for k in SERVE_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n, L, G = queue["n_requests"], queue["prompt_len"], queue["gen_len"]
    recurrent = any(m in ("rglru", "rwkv") for m in cfg.layer_kinds())
    check(len(results) == n, f"{arch}: {len(results)} of {n} requests finished")
    rng = np.random.RandomState(0)             # serve_engine's draws, replayed
    for rid in range(n):
        Lr = L if recurrent else rng.randint(max(1, L // 2), L + 1)
        rng.randint(0, 256, (Lr,), dtype=np.int32)
        g = int(rng.randint(max(1, G // 2), G + 1))
        toks = results[rid]
        check(len(toks) == g, f"{arch}: request {rid} has {len(toks)} of {g} tokens")
        check(bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()),
              f"{arch}: request {rid} has out-of-vocab tokens")
    steps = summ["decode_steps"]
    n_ffn, n_gqa = kernel_layers(cfg)
    want = {"masked_ffn_batch": n_ffn * steps, "decode_gqa": n_gqa * steps}
    check(counts == want, f"{arch}: launches {counts}, expected {want}")

    step, state = zoo_step(torch, np, params, cfg)
    prof = phase_profile(torch, params, cfg, state)
    del state
    embed = params["tok"]["embed"]
    step_bytes = param_bytes(leaves) - embed.numel() * embed.element_size()
    out = {"arch": arch, "params": sum(t.numel() for t in leaves),
           "param_gb": param_bytes(leaves) / 1e9, "init_s": init_s, "wall_s": wall_s,
           "layers": cfg.n_layers, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "prefills": summ["prefills"], "prefill_s": summ["prefill_s"],
           "prefill_ms_per_request": 1e3 * summ["prefill_s"] / summ["prefills"],
           "decode_s": summ["decode_s"], "decode_steps": steps,
           "decode_tokens": summ["decode_tokens"], "decode_tok_per_s": summ["tok_per_s"],
           "decode_ms_per_step": 1e3 * summ["decode_s"] / max(steps, 1),
           "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
           "decode_step_gb": step_bytes / 1e9,
           "max_memory_allocated_gb": peak_gb, "allocated_before_serve_gb": base_gb,
           "launches": counts, "step": step, "profile": prof}
    return out, counts


def phase_granite(torch, np, dev="cuda"):
    """Granite-20B at full width (d 6144, 48 query heads on one K/V head,
    d_ff 24576, GELU with biases), GRANITE_LAYERS deep, bf16 weights from
    init_params: one decode step from step_state's prefill launches
    decode_gqa once a layer (its FFN has biases, so it stays plain, as in
    the reference); then zoo_step holds every launch of that step against
    the plain version and the step against the plain step."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.models import model
    cfg = get_config("granite-20b").with_overrides(n_layers=GRANITE_LAYERS)
    params = model.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    caches, tok, pos, masks, _ = step_state(torch, np, params, cfg)
    ops.reset_launch_counts()                  # main path starts here
    t0 = time.perf_counter()
    logits, _ = model.decode_step(params, cfg, caches, tok, pos, masks=masks)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()               # main path ends here
    counts = {k: counts[k] for k in SERVE_KERNELS}
    check(bool(torch.isfinite(logits).all()), "granite: non-finite logits")
    n_ffn, n_gqa = kernel_layers(cfg)
    check(counts == {"masked_ffn_batch": n_ffn, "decode_gqa": n_gqa} and n_gqa == cfg.n_layers,
          f"granite: launches {counts}, expected 0 and {cfg.n_layers}")
    del caches, logits
    step, _ = zoo_step(torch, np, params, cfg)
    leaves = tree_leaves(params)
    out = {"layers": cfg.n_layers, "cut_from": get_config("granite-20b").n_layers,
           "params": sum(t.numel() for t in leaves), "param_gb": param_bytes(leaves) / 1e9,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "step_wall_ms": step_ms,
           "launches": counts, "step": step}
    return out, counts


# ---------------------------------------------------------------------------
# serve(): the reference's static batch, the path of the MoE models and the
# encoder-decoder

class RouteRecorder:
    """While active, wraps moe._route (which _moe_tokens calls through the
    module): keeps each call's token count and picks per expert, a device
    copy read after the run."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._moe, self._saved = [], moe, moe._route

        def route(p, x2d, cfg, expert_mask):
            out = self._saved(p, x2d, cfg, expert_mask)
            self.calls.append((x2d.shape[0], out[2].clone()))
            return out
        moe._route = route
        return self

    def __exit__(self, *exc):
        self._moe._route = self._saved


class StageTimer:
    """While active, wraps encdec.run_encoder and run_decoder_seq (which
    model.forward_seq calls through the module) with a synchronize on each
    side: the seconds of each call by stage."""

    def __init__(self, torch):
        self.torch, self.s = torch, {"encoder": [], "decoder": []}

    def __enter__(self):
        from repro_torch.models import encdec
        self._mod = encdec
        self._saved = {n: getattr(encdec, n) for n in ("run_encoder", "run_decoder_seq")}
        for stage, n in (("encoder", "run_encoder"), ("decoder", "run_decoder_seq")):
            setattr(encdec, n, self._timed(stage, self._saved[n]))
        return self

    def _timed(self, stage, fn):
        def run(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.s[stage].append(time.perf_counter() - t0)
            return out
        return run

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self._mod, n, fn)


def moe_layers(cfg):
    from repro_torch.models import transformer
    return sum(seg.repeats for seg in transformer.build_segments(cfg)
               for _, ffn in seg.unit if ffn == "moe")


def capacity_losses(cfg, calls, q):
    """(token, expert) assignments that get no expert output, from a
    serve() run's recorded routing: those ranked at or past their expert's
    capacity, and, apart from them, those lost to the slot cap − 1
    overwrite (an overflowing expert's pick kept at rank cap − 1). The
    prefill's totals, and each decode step's summed over the MoE layers."""
    from repro_torch.models import moe
    n_moe = moe_layers(cfg)
    T = q["batch"] * q["prompt_len"]
    n_pre = n_moe * (T // moe.token_chunk(T, cfg))
    check(len(calls) == n_pre + n_moe * q["gen_len"],
          f"{cfg.name}: {len(calls)} routing calls, expected {n_pre} + {n_moe} x {q['gen_len']}")
    lost = []
    for t, gs in calls:
        cap, g = moe.capacity(t, cfg), gs.cpu()
        lost.append((int((g - cap).clamp_min(0).sum()), int((g > cap).sum())))
    steps = [lost[n_pre + i * n_moe:n_pre + (i + 1) * n_moe] for i in range(q["gen_len"])]
    per_step = [[sum(c for c, _ in s), sum(o for _, o in s)] for s in steps]
    return {"assignments_per_step": q["batch"] * cfg.top_k * n_moe,
            "cap_per_step": moe.capacity(q["batch"], cfg),
            "prefill_lost_to_capacity": sum(c for c, _ in lost[:n_pre]),
            "prefill_lost_to_overwrite": sum(o for _, o in lost[:n_pre]),
            "prefill_assignments": T * cfg.top_k * n_moe,
            "decode_lost_to_capacity_mean": sum(c for c, _ in per_step) / len(per_step),
            "decode_lost_to_overwrite_mean": sum(o for _, o in per_step) / len(per_step),
            "per_step_capacity_overwrite": per_step}


def serve_prompts(np, cfg, q, seed=0):
    """serve()'s prompts, and an encoder-decoder's frames, replayed."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, min(cfg.vocab_size, 256), (q["batch"], q["prompt_len"]),
                       dtype=np.int32)
    frames = (rng.randn(q["batch"], q["prompt_len"], cfg.d_model).astype(np.float32) * 0.1
              if cfg.is_encdec else None)
    return toks, frames


def serve_state(torch, np, params, cfg, q):
    """serve()'s prefill again (its prompts, caches of prompt + gen slots)
    and its first decode step's token and positions: (caches, tok, pos,
    masks None), the state of phase_profile and step_twice."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.layers import cdtype
    dev = params["final_norm"]["scale"].device
    toks, frames = serve_prompts(np, cfg, q)
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    if frames is not None:
        batch["frames"] = torch.from_numpy(frames).to(dev, cdtype(cfg))
    logits, caches = make_prefill_step(cfg, cache_len=q["prompt_len"] + q["gen_len"])(
        params, batch)
    tok = torch.argmax(logits, -1)[:, None]
    return caches, tok, torch.full((q["batch"],), q["prompt_len"], device=dev), None


def step_twice(torch, params, cfg, state):
    """Two bf16 decode steps from the same caches: bitwise equal logits?
    The caches are left as found."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model
    caches, tok, pos, masks = state
    saved = tree_map(lambda t: t.clone(), caches)
    out = []
    for _ in range(2):
        out.append(model.decode_step(params, cfg, caches, tok, pos, masks=masks)[0])
        tree_map(lambda c, s0: c.copy_(s0), caches, saved)
    return bool(torch.equal(*out))


def decode_bytes(cfg, params, q):
    """Bytes a decode step must read: every weight but the embedding table.
    For an encoder-decoder, the decoder's weights less the cross-attention
    K/V projections (their outputs are cached at prefill), the output
    table, and the cross K/V caches and the self K/V caches at the
    decode's mean length."""
    from repro_torch.core.tree import tree_leaves
    embed = params["tok"]["embed"]
    if not cfg.is_encdec:
        return param_bytes(tree_leaves(params)) - embed.numel() * embed.element_size()
    dec = params["stack"]["dec"]
    cross_kv = [dec["cross"][k] for k in ("wk", "wv", "bk", "bv") if k in dec["cross"]]
    head = params["tok"].get("lm_head", embed)
    kv = 2 * cfg.n_layers * q["batch"] * cfg.n_kv_heads * cfg.head_dim * embed.element_size()
    mean_len = q["prompt_len"] + (q["gen_len"] + 1) / 2
    return (param_bytes(tree_leaves(dec)) - param_bytes(cross_kv)
            + param_bytes(tree_leaves(params["final_norm"])) + param_bytes([head])
            + kv * (q["prompt_len"] + mean_len))


def baseline_serve(torch, np, cfg, name, dev="cuda"):
    """``cfg`` at full width, bf16 weights from init_params (seed 0; an MoE
    router in fp32), through launch.serve.serve's static batch
    (BASELINE_QUEUE): the main path, its launch counts read on either side.
    Its tokens in the vocabulary; then a second run gives the same tokens,
    with an MoE model's routing recorded (capacity_losses) and an
    encoder-decoder's prefill timed by stage. Returns (line, params,
    launch counts)."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import model
    from repro_torch.models.layers import cdtype
    q = BASELINE_QUEUE
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device=dev, dtype=cdtype(cfg))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()                  # main path starts here
    t0 = time.perf_counter()
    gen, stats = serve(cfg, seed=0, device=dev, params=params, **q)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()               # main path ends here
    counts = {k: counts[k] for k in SERVE_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(gen.shape == (q["batch"], q["gen_len"]), f"{name}: generated {gen.shape}")
    check(bool(((gen >= 0) & (gen < cfg.padded_vocab)).all()), f"{name}: out-of-vocab tokens")

    extra = {}
    with RouteRecorder() as routes, StageTimer(torch) as stages:
        again, _ = serve(cfg, seed=0, device=dev, params=params, **q)
    check(bool((again == gen).all()), f"{name}: a second serve() gave other tokens")
    if cfg.n_experts:
        extra["capacity"] = capacity_losses(cfg, routes.calls, q)
    if cfg.is_encdec:
        extra["prefill_encoder_ms"] = 1e3 * sum(stages.s["encoder"])
        extra["prefill_decoder_ms"] = 1e3 * sum(stages.s["decoder"])
    step_bytes = decode_bytes(cfg, params, q)
    line = {"arch": cfg.name, "layers": cfg.n_layers,
            "cut_from": get_config(cfg.name).n_layers, "d_model": cfg.d_model,
            "params": sum(t.numel() for t in leaves), "param_gb": param_bytes(leaves) / 1e9,
            "init_s": init_s, "wall_s": wall_s, **q,
            "prefill_ms": 1e3 * stats["prefill_s"], "decode_s": stats["decode_s"],
            "decode_tok_per_s": stats["tok_per_s"],
            "decode_ms_per_step": 1e3 * stats["decode_s"] / q["gen_len"],
            "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
            "decode_step_gb": step_bytes / 1e9,
            "max_memory_allocated_gb": peak_gb, "allocated_before_serve_gb": base_gb,
            "second_run_same_tokens": True, "launches": counts, **extra}
    return line, params, counts


def capture_moe_inputs(run, picks):
    """Run ``run()`` with moe.apply_moe wrapped (the stack calls it through
    the module). Returns (the (layer params, input) of the MoE calls
    numbered in ``picks``, in call order from 0; run's result)."""
    from repro_torch.models import moe
    saved, got, n = moe.apply_moe, {}, [0]

    def wrapped(p, x, cfg, neuron_mask=None, expert_mask=None):
        if n[0] in picks:
            got[n[0]] = (p, x.detach().clone())
        n[0] += 1
        return saved(p, x, cfg, neuron_mask=neuron_mask, expert_mask=expert_mask)
    moe.apply_moe = wrapped
    try:
        out = run()
    finally:
        moe.apply_moe = saved
    return got, out


def _picks(moe, route, cap, n):
    """Per token (n, k): each pick's expert and whether it is served (kept,
    and not at rank cap − 1 of an overflowing expert)."""
    order, _, gs, _, row_e = route[:5]
    rank = moe.rank_in_expert(gs, row_e)
    served = (rank < cap) & ~((rank == cap - 1) & (gs[row_e] > cap))
    e, s = row_e.clone(), served.clone()
    e[order], s[order] = row_e, served
    return e.view(n, -1), s.view(n, -1)


def hold_moe_layer(torch, cfg, p, x):
    """One MoE layer at its real input x (B, S, d), on the card against the
    CPU port in fp32 (the layer's weights cast to fp32, TF32 off), token
    chunk by chunk as _moe_local runs it. The routing must be identical:
    sorted order, picks per expert, kept picks, and the experts whose slot
    cap − 1 is overwritten; a token's picks may differ only where its k-th
    and (k+1)-th router probabilities (CPU) are within MOE_TIE, and such
    tokens are reported. The output (shared experts included) must agree
    within MOE_LAYER_TOL (relative ∞-norm) on the tokens whose picks and
    served picks agree."""
    import dataclasses
    from repro_torch.core.tree import tree_map
    from repro_torch.models import moe
    c32 = dataclasses.replace(cfg, dtype="float32")
    pg = tree_map(lambda t: t.float(), p)
    pc = tree_map(lambda t: t.cpu(), pg)
    T, k = x.shape[0] * x.shape[1], cfg.top_k
    xg = x.float().reshape(T, -1)
    xc = xg.cpu()
    ck = moe.token_chunk(T, cfg)
    cap = moe.capacity(ck, cfg)
    same = torch.ones(T, dtype=torch.bool)
    identical, ties = True, []
    for i in range(0, T, ck):
        rg = [t.cpu() for t in moe._route(pg, xg[i:i + ck], c32, None)[:5]]
        rc = moe._route(pc, xc[i:i + ck], c32, None)[:5]
        eg, sg = _picks(moe, rg, cap, ck)
        ec, sc = _picks(moe, rc, cap, ck)
        agree = (eg == ec).all(1) & (sg == sc).all(1)
        same[i:i + ck] = agree
        flipped = torch.nonzero(~(eg.sort(1).values == ec.sort(1).values).all(1))[:, 0]
        if len(flipped):
            probs = torch.softmax(xc[i:i + ck][flipped] @ pc["router"], -1)
            top = probs.sort(-1, descending=True).values
            ties += [float(g) for g in top[:, k - 1] - top[:, k]]
        identical &= all(torch.equal(a, b) for a, b in zip(rg[:3], rc[:3])) and bool(agree.all())
    check(all(g <= MOE_TIE for g in ties),
          f"{cfg.name}: routing differs beyond near ties (k-th - (k+1)-th gaps {ties})")
    yg, aux_g = moe.apply_moe(pg, xg.view(x.shape), c32)
    yc, aux_c = moe.apply_moe(pc, xc.view(x.shape), c32)
    yg = yg.cpu().reshape(T, -1)
    err = rel_inf(yg[same], yc.reshape(T, -1)[same])
    check(err <= MOE_LAYER_TOL, f"{cfg.name}: MoE layer card vs CPU {err} at T {T}")
    del pg, pc
    return {"T": T, "chunks": T // ck, "cap": cap, "routing_identical": identical,
            "near_tie_tokens": len(ties), "near_tie_gaps": ties,
            "tokens_compared": int(same.sum()), "rel_err_inf": err,
            "aux_abs_err": abs(float(aux_g) - float(aux_c))}


def phase_serve_moe(torch, np, dev="cuda"):
    """DeepSeek-V2-Lite-16B at full width (27 layers: MLA without q-LoRA,
    a dense first layer, then 26 MoE layers of 64 routed experts of 1408,
    top-6, and 2 shared; vocab 102400), bf16 weights, through serve()'s
    static batch. No hand-written kernel is on this path, as in the
    reference: its dense d_ff 10944 is not a multiple of 128, serve()
    passes no masks, and MLA and the MoE are plain torch. Then the first
    and the last MoE layer held (hold_moe_layer) at the real inputs of
    serve()'s prefill (T 4096), of its first decode step (T 8) and of a
    forward of MOE_LONG tokens (T 10240, five chunks of 2048); two decode
    steps from the same caches bitwise equal; busy share of 3 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import model
    cfg = get_config("deepseek-v2-lite-16b")
    line, params, counts = baseline_serve(torch, np, cfg, "serve_moe", dev)
    check(set(counts.values()) == {0}, f"serve_moe: launched a kernel: {counts}")
    n_moe = moe_layers(cfg)
    picks = (0, n_moe - 1)
    holds = {}
    got, state = capture_moe_inputs(
        lambda: serve_state(torch, np, params, cfg, BASELINE_QUEUE), picks)
    holds["prefill"] = {f"moe_layer_{i}": hold_moe_layer(torch, cfg, *got[i]) for i in picks}
    caches, tok, pos, _ = state
    got, _ = capture_moe_inputs(lambda: make_serve_step(cfg)(params, caches, tok, pos), picks)
    holds["decode"] = {f"moe_layer_{i}": hold_moe_layer(torch, cfg, *got[i]) for i in picks}
    B, S = MOE_LONG
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (B, S))).to(dev)
    got, _ = capture_moe_inputs(lambda: model.forward_seq(params, cfg, {"tokens": toks}), picks)
    holds["long"] = {f"moe_layer_{i}": hold_moe_layer(torch, cfg, *got[i]) for i in picks}
    del got
    # from serve()'s prefill caches (the held step rewrote slot 512 with the
    # same values) and its first step's input
    line["two_steps_bitwise_equal"] = step_twice(torch, params, cfg, state)
    check(line["two_steps_bitwise_equal"], "serve_moe: two decode steps differ")
    line["profile"] = phase_profile(torch, params, cfg, state)
    line["held_moe_layers"] = holds
    del params, state, caches
    return line, counts


def phase_serve_static(torch, np, cfg, name, dev="cuda"):
    """An attention model on serve()'s static batch: baseline_serve, with
    decode_gqa launched once a full GQA attention layer a decode step and
    masked_ffn_batch never (no masks on this path, and SeamlessM4T's FFN has
    biases); then zoo_step's held step (every launch against its plain
    version, the step against the plain step), two decode steps from
    serve()'s caches bitwise equal, and the busy share of 3 decode steps."""
    line, params, counts = baseline_serve(torch, np, cfg, name, dev)
    n_ffn, n_gqa = kernel_layers(cfg)
    want = {"masked_ffn_batch": 0, "decode_gqa": n_gqa * BASELINE_QUEUE["gen_len"]}
    check(n_ffn == 0 and counts == want, f"{name}: launches {counts}, expected {want}")
    line["step"], _ = zoo_step(torch, np, params, cfg)
    state = serve_state(torch, np, params, cfg, BASELINE_QUEUE)
    line["two_steps_bitwise_equal"] = step_twice(torch, params, cfg, state)
    check(line["two_steps_bitwise_equal"], f"{name}: two decode steps differ")
    line["profile"] = phase_profile(torch, params, cfg, state)
    del params, state
    return line, counts


def ffn_grads(grads):
    """The FFN gradients (w_in, w_gate, w_out), stacked over the layers, of
    a one-segment model's gradient tree."""
    return dict(grads["stack"]["seg0"]["l0"]["ffn"])


def compare_routes(torch, cfg, params, batch, masks):
    """The kernel route's and the dense route's loss and gradients of one
    masked step from the same params and batch: the loss, each layer's FFN
    gradients (relative 2-norm), and a dropped block's gradient columns
    (w_in, w_gate) and rows (w_out) exactly 0 in both; the launches of
    each."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    ops.reset_launch_counts()
    (lk, _), g = steps.make_grads_fn(cfg, use_kernels=True)(params, batch, masks)
    gk = ffn_grads(g)
    del g
    torch.cuda.synchronize()
    kcounts = ops.launch_counts()
    ops.reset_launch_counts()
    (ld, _), g = steps.make_grads_fn(cfg)(params, batch, masks)
    gd = ffn_grads(g)
    del g
    torch.cuda.synchronize()
    dcounts = ops.launch_counts()
    dropped = masks[0]["l0"]["ffn"] == 0                        # (L, F)
    rel, exact = {}, True
    for k in ("w_in", "w_gate", "w_out"):
        rel[k] = [rel2(a, b) for a, b in zip(gk[k], gd[k])]
        for grads in (gk[k], gd[k]):
            for layer, drop in zip(grads, dropped):
                exact &= bool(((layer[drop] if k == "w_out" else layer[:, drop]) == 0).all())
    return {"loss_kernel": float(lk), "loss_dense": float(ld),
            "loss_rel": abs(float(lk) - float(ld)) / abs(float(ld)),
            "grad_rel2_by_layer": rel, "dropped_grads_exactly_0": exact,
            "launches_kernel": kcounts, "launches_dense": dcounts}


def zoo_kernel_times(torch, cfg, mask, dev):
    """B1's training form, B2 and B3 at the train step's shape (C 1, M
    B·S, d, F, bf16, swiglu) under one layer's mask: device time a call
    beside its bound and its plain version's, each held to the plain
    version; and the dense route's forward and backward of the same masked
    FFN (apply_ffn without the kernels, cuBLAS)."""
    from repro_torch.kernels import masked_ffn as ffn
    from repro_torch.models.layers import apply_ffn
    M, d, F = ZOO_TRAIN["batch"] * ZOO_TRAIN["seq"], cfg.d_model, cfg.d_ff
    g = torch.Generator(device=dev).manual_seed(7)
    r = lambda *sh, fan: (torch.randn(*sh, generator=g, device=dev) / fan ** 0.5)
    bf = torch.bfloat16
    x, gy = r(1, M, d, fan=1).to(bf), r(1, M, d, fan=1).to(bf)
    w = {"w_in": r(d, F, fan=d), "w_gate": r(d, F, fan=d), "w_out": r(F, d, fan=F)}
    row = mask.to(dev, torch.float32).expand(1, M, F).contiguous()
    args = (x, w["w_in"].to(bf)[None], w["w_out"].to(bf)[None], row, w["w_gate"].to(bf)[None])
    runs = {"masked_ffn_train_fwd": (lambda: ffn.masked_ffn_train_fwd(*args, act="silu"),
                                     lambda: ffn.masked_ffn_batch_plain(*args, "silu")),
            "masked_ffn_dx": (lambda: ffn.masked_ffn_dx(gy, *args, act="silu"),
                              lambda: ffn.masked_ffn_dx_plain(gy, *args, "silu")),
            "masked_ffn_dw": (lambda: ffn.masked_ffn_dw(gy, *args, act="silu"),
                              lambda: ffn.masked_ffn_dw_plain(gy, *args, "silu"))}
    work, skipped = train_work(torch, row, d, True, 2)
    out = {"shape": dict(C=1, M=M, d=d, F=F, dtype="bfloat16", act="silu", gated=True),
           "kept_blocks": int((mask.view(-1, 128).amax(1) > 0).sum()),
           "skipped_tile_share": skipped}
    for k, (kern, plain) in runs.items():
        got, want = kern(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(rel_inf(a, b) for a, b in zip(got, want) if b is not None)
        check(err <= BF16_HOLD_TOL, f"train_zoo: {k} at C 1, M {M}: rel err {err}")
        nbytes, flops = work[k]
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        out[k] = {"ms": time_ms(kern, torch, n=10), "plain_ms": time_ms(plain, torch, n=3, warmup=1),
                  "bound_ms": b_ms, "bound_by": b_by, "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                  "bound_ops_ms": flops / BF16_FLOPS * 1e3, "rel_err": err,
                  "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                     for a, b in zip(got, want) if b is not None)}
        del got, want
    p = {k: v.requires_grad_() for k, v in w.items()}
    xd = x.reshape(ZOO_TRAIN["batch"], ZOO_TRAIN["seq"], d).requires_grad_()

    def dense():
        y = apply_ffn(p, xd, cfg, neuron_mask=mask.to(dev))
        y.backward(gy.view_as(y))
    dense_fwd = lambda: apply_ffn(p, xd.detach(), cfg, neuron_mask=mask.to(dev))
    with torch.no_grad():
        out["dense_forward_ms"] = time_ms(dense_fwd, torch, n=10)
    out["dense_forward_backward_ms"] = time_ms(dense, torch, n=10)
    # a kernel step runs the forward twice a layer (remat), dx and dW once
    out["kernel_layer_ms"] = (2 * out["masked_ffn_train_fwd"]["ms"] + out["masked_ffn_dx"]["ms"]
                              + out["masked_ffn_dw"]["ms"])
    return out


def phase_adamw(torch, np, dev="cuda"):
    """AdamW's one-pass kernel (kernels/adamw.py) on the StableLM train
    cell's tree, on its largest leaf and over the whole tree: device time
    (CUDA events, median) beside the byte bound (28 B a parameter at the
    HBM rate), the plain chain's time, and torch.optim.AdamW(fused=True)
    at the same shapes as the library yardstick (the port never calls it;
    its state is given the same m and v, so it allocates none). First, one
    step of the largest leaf through the kernel is held bitwise to the
    plain chain's; every step launches the kernel once a leaf."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import adamw as adamw_kernel
    from repro_torch.models import model
    from repro_torch.optim import adamw
    h = ADAMW_HYPER
    b1, b2, eps, lr = h["b1"], h["b2"], h["eps"], h["lr"]
    cfg = get_config(ADAMW_TREE["arch"]).with_overrides(n_layers=ADAMW_TREE["layers"],
                                                        **ADAMW_TREE["overrides"])
    g = torch.Generator(device=dev).manual_seed(0)
    draw = lambda s, sd: torch.randn(s.shape, generator=g, device=dev).mul_(sd)
    specs = tree_leaves(model.param_specs(cfg))
    params, grads = [draw(s, 0.02) for s in specs], [draw(s, 1e-3) for s in specs]
    opt = adamw(b1=b1, b2=b2, eps=eps)
    state = opt.init(params)
    big = max(range(len(params)), key=lambda i: params[i].numel())

    t = torch.ones((), device=dev)
    bc = (1 - torch.pow(b1, t), 1 - torch.pow(b2, t))
    leaf = [params[big].clone(), state["m"][big].add(1e-4), state["v"][big].add(1e-8)]
    want = [x.clone() for x in leaf]
    before = adamw_kernel.launches.n
    adamw_kernel.adamw_update(leaf[0], grads[big], *leaf[1:], *bc, b1=b1, b2=b2, eps=eps,
                              weight_decay=0.0, lr=lr)
    adamw_kernel.adamw_plain(want[0], grads[big], *want[1:], *bc, b1, b2, eps, 0.0, lr)
    torch.cuda.synchronize()
    check(adamw_kernel.launches.n == before + 1, "adamw: a leaf took other than one launch")
    check(all(torch.equal(a, b) for a, b in zip(leaf, want)),
          "adamw: the kernel's update is not the plain chain's, bit for bit")
    del leaf, want

    def kernel_steps(ps, gs, ms, vs):
        st = {"m": ms, "v": vs, "t": state["t"]}
        return lambda: opt.update(gs, st, ps, lr)

    def plain_steps(ps, gs, ms, vs):
        def step():
            t.add_(1)
            c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
            for p, gg, m, v in zip(ps, gs, ms, vs):
                adamw_kernel.adamw_plain(p, gg, m, v, c1, c2, b1, b2, eps, 0.0, lr)
        return step

    def library_steps(ps, gs, ms, vs):
        for p, gg in zip(ps, gs):
            p.grad = gg
        lib = torch.optim.AdamW(ps, lr=lr, betas=(b1, b2), eps=eps, weight_decay=0.0,
                                fused=True)
        for p, m, v in zip(ps, ms, vs):
            lib.state[p] = {"step": torch.zeros((), device=dev), "exp_avg": m, "exp_avg_sq": v}
        return lib.step

    out = {"tree": {"arch": cfg.name, "layers": cfg.n_layers, **ADAMW_TREE["overrides"],
                    "leaves": len(params)},
           "largest_leaf": {"shape": list(params[big].shape)}}
    for name, sel in (("largest_leaf", [big]), ("tree", range(len(params)))):
        args = [[x[i] for i in sel] for x in (params, grads, state["m"], state["v"])]
        n = sum(p.numel() for p in args[0])
        before = adamw_kernel.launches.n
        ms = time_ms(kernel_steps(*args), torch, n=10)       # 3 warm-up calls, 10 timed
        check(adamw_kernel.launches.n == before + 13 * len(args[0]),
              f"adamw: {adamw_kernel.launches.n - before} launches for 13 steps of "
              f"{len(args[0])} leaves")
        bound = ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3
        out[name].update({"params": n, "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms,
                          "plain_ms": time_ms(plain_steps(*args), torch, n=5, warmup=1),
                          "library_ms": time_ms(library_steps(*args), torch, n=10)})
        for p in args[0]:
            p.grad = None
    out["card"] = nvidia_smi()
    del params, grads, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_zoo(torch, np, dev="cuda", regions=None):
    """StableLM-2-12B at full width on 8 of its 40 layers through the port's
    train step (fp32 params, bf16 compute, AdamW, block remat) on the
    reference's synthetic batches: 2 full steps; the invariant unit
    statistics of the FFN against a snapshot and build_masks at
    pick_rate(1.3) (81 of 108 blocks a layer); the kernel route against
    the dense route on one masked step (same params, same batch); 3 masked
    steps through B1's training form, B2 and B3 (16, 8 and 8 launches a
    step), the first with every launch held against its plain version; 2
    dense masked steps (no launch), the last with AdamW timed alone; then
    B1-B3 timed at this shape, launch.train.run_fluid through its entry
    point, and run_plain's checkpoint at smoke size reloaded bitwise. One
    more kernel step runs in a host-sync region (into ``regions``, for the
    analysis line). Returns (line, the kernel steps' launches)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import transformer_hooks as hooks
    from repro_torch.core.straggler import pick_rate
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels import adamw as adamw_kernel
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer
    cfg = get_config(ZOO_TRAIN["arch"]).with_overrides(n_layers=ZOO_TRAIN["layers"])
    B, S = ZOO_TRAIN["batch"], ZOO_TRAIN["seq"]
    n = model.count_params(model.param_specs(cfg))
    plan = {"arch": cfg.name, "layers": cfg.n_layers, "of_layers": get_config(cfg.name).n_layers,
            "params": n, "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
            "optimizer": cfg.optimizer, "remat": cfg.remat, "batch": B, "seq": S,
            "reckoned_GB": {"params": 4 * n / 1e9, "grads": 4 * n / 1e9,
                            "adamw_m": 4 * n / 1e9, "adamw_v": 4 * n / 1e9, "total": 16 * n / 1e9}}
    emit("train_zoo_plan", **plan)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    allocated0 = torch.cuda.memory_allocated()
    params = model.init_params(cfg, seed=0, device=dev)
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(params)
    card_counts = {"built_bytes": torch.cuda.memory_allocated() - allocated0,
                   "tensors": len(tree_leaves(params)) + len(tree_leaves(state))}
    rng = np.random.RandomState(0)
    snap = train.ffn_snapshot(params, cfg)
    losses, ms, counts = [], {"full": [], "kernel": [], "dense": []}, []
    zero = dict.fromkeys(ops.LAUNCHES, 0)
    n_leaves = len(tree_leaves(params))        # AdamW's launches a step, one a leaf

    def run(kind, fn, b=None, *extra):
        nonlocal params, state
        b = b if b is not None else train.synth_batch(rng, cfg, B, S + 1, dev)
        ops.reset_launch_counts()
        adamw_kernel.launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, met = fn(params, state, b, *extra)
        loss = float(met["loss"])
        ms[kind].append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        counts.append((kind, ops.launch_counts()))
        check(adamw_kernel.launches.n == n_leaves,
              f"train_zoo: a {kind} step's AdamW launched {adamw_kernel.launches.n} "
              f"times for {n_leaves} leaves")
        return counts[-1][1]

    full = steps.make_train_step(cfg)
    with FlopCounterMode(display=False) as fc:    # the dryrun phase's FLOPs
        check(run("full", full) == zero, f"train_zoo: a full step launched {counts[-1]}")
    card_counts["flops"] = fc.get_total_flops()
    check(run("full", full) == zero, f"train_zoo: a full step launched {counts[-1]}")
    card_counts["peak_bytes"] = torch.cuda.max_memory_allocated()
    stats = hooks.ffn_unit_stats(snap, params, cfg)
    del snap
    r = pick_rate(ZOO_TRAIN["slowdown"])
    masks = tree_map(lambda m: m.to(dev), hooks.build_masks(stats, cfg, r))
    nb = cfg.d_ff // 128
    kept = masks[0]["l0"]["ffn"].view(cfg.n_layers, nb, 128).amax(-1).sum(-1)
    want_kept = round(nb * r)
    check(bool((kept == want_kept).all()), f"train_zoo: kept blocks a layer {kept.tolist()}, "
          f"expected {want_kept}")
    st = stats[0]["l0"]["ffn"]
    check(bool((st > 0).all()), f"train_zoo: a calibration statistic is not > 0 "
          f"(min {float(st.min())})")
    calib = {"rate": r, "kept_blocks": kept.tolist(), "of_blocks": nb,
             "stat_min": float(st.min()), "stat_max": float(st.max())}
    # the kernel route against the dense route, on the first kernel step's batch
    b = train.synth_batch(rng, cfg, B, S + 1, dev)
    routes = compare_routes(torch, cfg, params, b, masks)
    L = cfg.n_layers
    per_step = {"masked_ffn_train_fwd": 2 * L, "masked_ffn_dx": L, "masked_ffn_dw": L,
                "masked_ffn_train_fwd_tc": 2 * L, "masked_ffn_dx_tc": L, "masked_ffn_dw_tc": L}
    check(routes["launches_dense"] == zero,
          f"train_zoo: the dense route launched {routes['launches_dense']}")
    check(all(routes["launches_kernel"][k] == v for k, v in per_step.items()),
          f"train_zoo: the kernel route launched {routes['launches_kernel']}, expected {per_step}")
    check(routes["loss_rel"] <= ZOO_LOSS_TOL, f"train_zoo: kernel vs dense loss {routes['loss_rel']}")
    worst = max(max(v) for v in routes["grad_rel2_by_layer"].values())
    check(worst <= ZOO_GRAD_TOL, f"train_zoo: kernel vs dense FFN gradients {worst}")
    check(routes["dropped_grads_exactly_0"], "train_zoo: a dropped block's gradient is not 0")
    gc.collect()
    # three masked steps through the kernels: the first held, the last profiled
    kern = steps.make_train_step(cfg, with_masks=True, use_kernels=True)
    with HoldLaunches(torch) as hold:
        c = run("kernel", kern, b, masks)
    held = hold.check("train_zoo", c, TRAIN_KERNELS, tol=BF16_HOLD_TOL)
    run("kernel", kern, None, masks)
    busy = busy_share(torch, lambda: run("kernel", kern, None, masks),
                      watch=("train_fwd", "train_dx", "train_dw", "train_fd_reduce"))
    # a programmatic dependent (the f-block reduce) is counted from its early
    # start, overlapping its primary: the share without it
    wait_ms = sum(w["calls"] * w["us_per_call"] for w in busy.get("watched", [])
                  if "reduce" in w["kernel"]) / 1e3
    if busy["device_ms"] is not None:
        busy["device_busy_share_without_dependents"] = (
            (busy["device_ms"] - wait_ms) / busy["wall_ms"])
    for kind, c in counts:
        want = ({k: per_step.get(k, 0) for k in zero} if kind == "kernel" else zero)
        check(c == want, f"train_zoo: a {kind} step launched {c}, expected {want}")
    launches = {k: sum(c[k] for kind, c in counts if kind == "kernel") for k in TRAIN_KERNELS}
    # one more kernel step in a host-sync region, on a batch of its own
    # (the analysis line reports it; its launches stay off this line)
    sync_region(torch, {} if regions is None else regions,
                "make_train_step[stablelm-12b, 8 layers, use_kernels]", kern, params, state,
                train.synth_batch(np.random.RandomState(1), cfg, B, S + 1, dev), masks, dev=dev)
    # two dense masked steps: the second as its gradients, then AdamW alone
    dense = steps.make_train_step(cfg, with_masks=True)
    check(run("dense", dense, None, masks) == zero, "train_zoo: the dense masked step launched")
    b = train.synth_batch(rng, cfg, B, S + 1, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss, _), grads = steps.make_grads_fn(cfg)(params, b, masks)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.update(grads, state, params, cfg.learning_rate)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    losses.append(float(loss))
    ms["dense"].append(1e3 * (t2 - t0))
    adamw_ms = 1e3 * (t2 - t1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(params))
    check(all(np.isfinite(losses)) and finite, f"train_zoo: not finite (losses {losses})")
    check(losses[-1] < losses[0], f"train_zoo: loss did not fall: {losses}")
    step_s = {k: v[-1] / 1e3 for k, v in ms.items()}
    step_s["kernel"] = ms["kernel"][1] / 1e3           # neither held nor profiled
    flops = 6 * n * B * S
    smi = nvidia_smi()
    timing = {"card": smi, "ms_a_step": {k: 1e3 * v for k, v in step_s.items()},
              "ms_by_step": ms,
              "tokens_per_s": {k: B * S / v for k, v in step_s.items()},
              "model_flop_share": {k: flops / v / BF16_FLOPS for k, v in step_s.items()},
              "adamw_ms": adamw_ms, "kernel_step_busy": busy}
    layer_mask = masks[0]["l0"]["ffn"][0].clone()
    del params, state, masks, stats
    gc.collect()
    torch.cuda.empty_cache()
    main_s = time.perf_counter() - t_phase
    kern_times = zoo_kernel_times(torch, cfg, layer_mask, dev)
    kern_times["card"] = smi
    gc.collect()
    torch.cuda.empty_cache()
    # launch.train's entry points: run_fluid at this width, run_plain's
    # checkpoint at smoke size (a full-width one would be 12.6 GB)
    fl_stats, fl_masks = [], []
    orig = {name: getattr(hooks, name) for name in ("ffn_unit_stats", "build_masks")}

    def recorded(name, out):
        return lambda *a, **kw: out.append(orig[name](*a, **kw)) or out[-1]
    hooks.ffn_unit_stats, hooks.build_masks = (recorded("ffn_unit_stats", fl_stats),
                                               recorded("build_masks", fl_masks))
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        fparams, flog = train.run_fluid(cfg, ZOO_FLUID["steps"], B, S,
                                        calibrate_every=ZOO_FLUID["calibrate_every"],
                                        straggler_slowdown=ZOO_TRAIN["slowdown"],
                                        log_every=ZOO_FLUID["steps"], device=dev)
        torch.cuda.synchronize()
        fluid_s = time.perf_counter() - t0
    finally:
        hooks.ffn_unit_stats, hooks.build_masks = orig["ffn_unit_stats"], orig["build_masks"]
    check(ops.launch_counts() == zero, f"train_zoo: run_fluid launched {ops.launch_counts()}")
    del fparams
    gc.collect()
    torch.cuda.empty_cache()
    check(len(fl_stats) == ZOO_FLUID["steps"] // ZOO_FLUID["calibrate_every"],
          f"train_zoo: run_fluid calibrated {len(fl_stats)} times")
    fl_kept = []
    for st, mk in zip(fl_stats, fl_masks):
        check(bool((st[0]["l0"]["ffn"] > 0).all()), "train_zoo: run_fluid: a statistic is not > 0")
        k = mk[0]["l0"]["ffn"].view(cfg.n_layers, nb, 128).amax(-1).sum(-1)
        check(bool((k == want_kept).all()), f"train_zoo: run_fluid kept {k.tolist()}")
        fl_kept.append(k.tolist())
    fl_losses = [loss for loss, _, _ in flog]
    check(all(np.isfinite(fl_losses)), f"train_zoo: run_fluid losses {fl_losses}")
    ck = ROOT / "build" / "chip_smoke_ckpt" / "smoke"
    scfg = get_config(ZOO_TRAIN["arch"]).smoke()
    sparams, slosses = train.run_plain(scfg, ZOO_CKPT["steps"], ZOO_CKPT["batch"],
                                       ZOO_CKPT["seq"], log_every=ZOO_CKPT["steps"],
                                       ckpt=str(ck), device=dev)
    back = load_checkpoint(str(ck), device=dev)["params"]
    got, want = tree_leaves(back), tree_leaves(sparams)
    bitwise = len(got) == len(want) and all(torch.equal(a, w) for a, w in zip(got, want))
    check(bitwise, "train_zoo: the checkpoint did not reload bitwise")
    line = {"plan": plan, "main_path_s": main_s, "losses": losses, "calibration": calib,
            "card_counts": card_counts,
            "kernel_vs_dense": routes, "held": held, "launches_a_kernel_step": per_step,
            "steps": {k: len(v) for k, v in ms.items()}, **timing,
            "peak_GB": peak, "peak_over_reckoning": peak / plan["reckoned_GB"]["total"],
            "kernels_at_shape": kern_times,
            "run_fluid": {"s": fluid_s, "losses": fl_losses, "kept_blocks": fl_kept,
                          "stat_min": [float(st[0]["l0"]["ffn"].min()) for st in fl_stats]},
            "run_plain_ckpt": {"config": "smoke", "losses": slosses, "reloaded_bitwise": bitwise,
                               "leaves": len(tree_leaves(back))}}
    return line, launches


class RoundRecorder:
    """While active, wraps the server's and the sequential and fleet
    backends' run_round: keeps each round's wall seconds, its training
    seconds, SGD step count (the cohort's steps on the fleet, the sum of
    the clients' steps on the sequential backend), client steps and
    keep-maps (synchronised before each clock reading)."""

    def __init__(self, torch):
        from repro_torch.core.fluid import FluidServer
        from repro_torch.fl.rounds import FleetBackend, SequentialBackend
        self.torch, self.log, self.round_s = torch, [], []
        self.orig = {FluidServer: FluidServer.run_round,
                     FleetBackend: FleetBackend.run_round,
                     SequentialBackend: SequentialBackend.run_round}

    def _timed(self, fn):
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def __enter__(self):
        (server_cls, srv), *backends = self.orig.items()

        def server_round(server, *a, **kw):
            res, dt = self._timed(lambda: srv(server, *a, **kw))
            self.round_s.append(dt)
            return res

        def backend_round(bk):
            def run_round(backend, params, keep_maps, rates):
                res, dt = self._timed(lambda: bk(backend, params, keep_maps, rates))
                per_client = [c.local_epochs * (c.n_samples // c.eff_batch_size)
                              for c in backend.clients]
                steps = (backend.engine.steps if hasattr(backend, "engine")
                         else sum(per_client))
                self.log.append({
                    "train_s": dt, "steps": steps, "client_steps": sum(per_client),
                    "clients": len(backend.clients),
                    "ids": [c.id for c in backend.clients],
                    "backend": type(backend).__name__,
                    "keep_maps": {c: {g: k.copy() for g, k in km.items()}
                                  for c, km in keep_maps.items()}})
                return res
            return run_round
        server_cls.run_round = server_round
        for cls, bk in backends:
            cls.run_round = backend_round(bk)
        return self

    def __exit__(self, *exc):
        for cls, fn in self.orig.items():
            cls.run_round = fn


def fl_run(torch, workload, backend, n_clients, rounds, dev="cuda",
           use_kernels=False, policy="invariant", n_data=2000):
    """One experiment through the port's entry point, straggler 0. Returns
    (sim, history, per-round log, wall seconds, final params as leaves,
    read before any later round)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl.simulation import (CohortConfig, SimulationConfig,
                                           run_experiment)
    cfg = SimulationConfig(
        workload=workload, backend=backend, use_kernels=use_kernels,
        policy=policy, device=dev,
        cohort=CohortConfig(n_clients=n_clients, straggler_ids=(0,), n_data=n_data))
    with RoundRecorder(torch) as rec:
        t0 = time.perf_counter()
        sim, hist = run_experiment(cfg, rounds=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for r, dt in zip(rec.log, rec.round_s):
        r["round_s"] = dt
    return sim, list(hist), rec.log, wall, tree_leaves(sim.server.params)


def same_keep_maps(np, kx, ky):
    return kx.keys() == ky.keys() and all(
        kx[c].keys() == ky[c].keys()
        and all(np.array_equal(kx[c][g], ky[c][g]) for g in kx[c]) for c in kx)


def hold_same_plans(name, a, b):
    """Two fl_run results pick the same stragglers and rates and reach the
    same round times every round (all three follow from the clients' RNG
    streams and the speed model, whatever the training's arithmetic)."""
    (_, ha, *_), (_, hb, *_) = a, b
    check(len(ha) == len(hb), f"{name}: {len(ha)} rounds against {len(hb)}")
    for x, y in zip(ha, hb):
        check(x.stragglers == y.stragglers and x.rates == y.rates,
              f"{name}: round {x.round} plan differs")
        check(x.round_time == y.round_time,
              f"{name}: round {x.round} time {x.round_time} against {y.round_time}")


def params_diff(a, b):
    return max(float((p - q).abs().max()) for p, q in zip(a[4], b[4]))


def hold_same_runs(np, name, a, b, atol=5e-4):
    """Two fl_run results reach identical stragglers, rates, keep-maps and
    round times every round, and final params within ``atol``; returns
    the params' largest difference."""
    hold_same_plans(name, a, b)
    for x, rx, ry in zip(a[1], a[2], b[2]):
        check(same_keep_maps(np, rx["keep_maps"], ry["keep_maps"]),
              f"{name}: round {x.round} keep-maps differ")
    diff = params_diff(a, b)
    check(diff <= atol, f"{name}: params differ by {diff} (limit {atol})")
    return diff


def ms_per_step(log, key="steps"):
    """Training ms per step over the rounds after the first (which pays
    the first calls' set-up)."""
    rest = log[1:] or log
    return 1e3 * sum(r["train_s"] for r in rest) / sum(r[key] for r in rest)


def skip_shares(log, F):
    """Share of (m-tile, f-block) tiles the kernels skip, per round: over
    the whole cohort, and over the stragglers alone. A client's rows share
    its keep-map, so a block it keeps no neuron of is skipped in every
    m-tile."""
    nfb = F // 128
    out = []
    for r in log:
        skipped = [nfb - len({int(i) // 128 for i in km["ffn"]})
                   for km in r["keep_maps"].values()]
        out.append({"cohort": sum(skipped) / (r["clients"] * nfb),
                    "stragglers": (sum(skipped) / (len(skipped) * nfb)
                                   if skipped else None)})
    return out


def busy_share(torch, fn, watch=()):
    """Device busy share of one call of fn, and device ms by kernel: the
    top 8, and every kernel whose name holds a string of ``watch``, with
    its share of the device time. Sums the profiler's raw device events
    by name (``key_averages`` takes seconds on a round of ~10^5 ops)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            n, us = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    dev_us = sum(us for _, us in by_name.values())
    kern = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    row = lambda k, n, us: {"kernel": k[:120], "calls": n, "us_per_call": us / max(n, 1)}
    top = [row(k, n, us) for k, (n, us) in kern[:8]]
    if not dev_us:                     # the profiler saw no device activity
        return {"wall_ms": wall_us / 1e3, "device_ms": None,
                "device_busy_share": None, "top": []}
    watched = [row(k, n, us) | {"device_share": us / dev_us}
               for k, (n, us) in kern if any(w in k for w in watch)]
    return {"wall_ms": wall_us / 1e3, "device_ms": dev_us / 1e3,
            "device_busy_share": dev_us / wall_us, "top": top,
            **({"watched": watched} if watch else {})}


def head_skip_shares(log, H):
    """Share of (client, head) slabs the head-masked kernels skip, per
    round: over the whole cohort, and over the stragglers alone."""
    out = []
    for r in log:
        skipped = [H - len(km["heads"]) for km in r["keep_maps"].values()]
        out.append({"cohort": sum(skipped) / (r["clients"] * H),
                    "stragglers": (sum(skipped) / (len(skipped) * H)
                                   if skipped else None)})
    return out


def fl_phase(torch, np, name, workload, per_step, dev="cuda"):
    """FLuID training through the port's entry point: ``workload`` on the
    fleet backend with the kernels, the paper's 5 clients with straggler
    0, n_data 2000, 6 rounds. Each kernel in ``per_step`` must launch that
    many times per SGD step. The same experiment with the plain versions
    swapped in must give identical stragglers, rates, keep-maps and round
    times, and final params within 5e-4 (the reference's
    fleet-vs-sequential tolerance). Then one more round under the
    profiler, 3 rounds each under the ordered and random policies for the
    skip shares, and a 64-client cohort for 2 rounds. Returns the phase's
    line, the launch counts, and the 5- and 64-client runs (the dense
    fleet is held to them in train_dense)."""
    from repro_torch.kernels import ops
    F = {"femnist_kernel": TRAIN_SHAPE["F"], "femnist_attn": ATTN_SHAPE["F"]}[workload]

    def experiment(n_clients, rounds, policy="invariant"):
        return fl_run(torch, workload, "fleet", n_clients, rounds, dev,
                      use_kernels=True, policy=policy)

    ops.reset_launch_counts()                  # main path starts here
    run5 = experiment(5, 6)
    counts = ops.launch_counts()               # main path ends here
    sim, hist, log, wall, params = run5
    steps = sum(r["steps"] for r in log)
    for k, n in per_step.items():
        check(counts[k] == n * steps,
              f"{name}: {k} launched {counts[k]} times, expected {n} per SGD "
              f"step ({n} x {steps})")
    check(all(bool(torch.isfinite(p).all()) for p in params), f"{name}: non-finite params")
    check(any(h.stragglers for h in hist), f"{name}: dropout never engaged")
    acc = hist[-1].accuracy
    check(acc == acc and acc > 1 / 62, f"{name}: final accuracy {acc} not above chance")

    undo = swap_in_plain(ops)
    try:
        plain = experiment(5, 6)
    finally:
        undo()
    diff = hold_same_runs(np, f"{name} (kernels against plain)", run5, plain)
    _, phist, plog, pwall, _ = plain

    # one more round of the same cohort under the profiler
    watch = (("head_slab_kernel", "head_sum_kernel", "head_dw_kernel")
             if workload == "femnist_attn" else ())
    prof5 = busy_share(torch, lambda: sim.server.run_round(), watch)
    logs = {"invariant": log}
    for pol in ("ordered", "random"):
        logs[pol] = experiment(5, 3, pol)[2]
    skips = {"skipped_tile_share": {p: skip_shares(lg, F) for p, lg in logs.items()}}
    if workload == "femnist_attn":
        skips["skipped_head_share"] = {p: head_skip_shares(lg, ATTN_SHAPE["H"])
                                       for p, lg in logs.items()}
    run64 = experiment(64, 2)
    s64, h64, log64, wall64, _ = run64
    prof64 = busy_share(torch, lambda: s64.server.run_round(), watch)
    train_s = [r["train_s"] for r in log]
    out = {
        "workload": workload, "cohort": 5, "rounds": 6, "n_data": 2000,
        "steps_per_round": log[0]["steps"],
        "wall_s": wall, "plain_wall_s": pwall,
        "round_s": [r["round_s"] for r in log],
        "plain_round_s": [r["round_s"] for r in plog],
        "round_train_s": train_s, "plain_round_train_s": [r["train_s"] for r in plog],
        "ms_per_sgd_step": ms_per_step(log),
        "plain_ms_per_sgd_step": ms_per_step(plog),
        "round_times_sim": [h.round_time for h in hist],
        "stragglers": [h.stragglers for h in hist],
        "rates": [{str(c): r for c, r in h.rates.items()} for h in hist],
        "accuracy": [h.accuracy for h in hist],
        "plain_accuracy": [h.accuracy for h in phist],
        "params_max_abs_diff_vs_plain": diff, "launches": counts,
        "profile_round": prof5, **skips,
        "cohort64": {"rounds": 2, "steps_per_round": log64[0]["steps"],
                     "wall_s": wall64, "round_s": [r["round_s"] for r in log64],
                     "round_train_s": [r["train_s"] for r in log64],
                     "ms_per_sgd_step": 1e3 * log64[-1]["train_s"] / log64[-1]["steps"],
                     "accuracy": [h.accuracy for h in h64],
                     "profile_round": prof64}}
    return out, counts, {5: (run5, prof5), 64: (run64, prof64)}


def phase_train(torch, np, dev="cuda"):
    """femnist_kernel (KernelMLP): each masked-FFN training kernel launches
    once per SGD step."""
    return fl_phase(torch, np, "train", "femnist_kernel", dict(FLEET_PER_STEP), dev)


def phase_train_attn(torch, np, dev="cuda"):
    """femnist_attn (KernelAttnClassifier): each head-masked projection
    kernel launches 3 times per SGD step (Q, K, V), each merge kernel once
    (O), each masked-FFN training kernel once."""
    return fl_phase(torch, np, "train_attn", "femnist_attn",
                    {**FLEET_PER_STEP, **ATTN_KERNELS}, dev)


# rounds, and the accuracy a run must end above (chance). Shakespeare's LSTM
# at the paper's lr 0.001 stays at 0.75-1% accuracy for 20 rounds on both
# backends (below 1/80), as the reference's does; its gate is the test loss
# falling, which every run must show.
PAPER_WORKLOADS = {"femnist": (6, 1 / 62), "cifar10": (3, 1 / 10),
                   "shakespeare": (3, None), "synth": (3, 1 / 10)}


def eval_loss(torch, sim, params):
    """Mean cross-entropy of ``params`` on the simulation's test set."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl.client import make_loss
    dev = tree_leaves(params)[0].device
    with torch.no_grad():
        return float(make_loss(sim.model_cls)(
            params, torch.as_tensor(sim.ds.x_test, device=dev),
            torch.as_tensor(sim.ds.y_test, device=dev)))


def run_summary(run):
    """Round seconds, ms per SGD step and accuracy of one fl_run."""
    _, hist, log, wall, _ = run
    return {"wall_s": wall, "round_s": [r["round_s"] for r in log],
            "round_train_s": [r["train_s"] for r in log],
            "steps_per_round": log[0]["steps"],
            "client_steps_per_round": log[0]["client_steps"],
            "ms_per_sgd_step": ms_per_step(log),
            "ms_per_client_step": ms_per_step(log, "client_steps"),
            "accuracy": [h.accuracy for h in hist]}


def phase_train_paper(torch, np, dev="cuda"):
    """The paper's own workloads through the port's entry point, the
    reference's default path: femnist (CNN, 6 rounds), cifar10 (VGG-9),
    shakespeare (LSTM) and synth (MLP; 3 rounds each), 5 clients,
    straggler 0, n_data 2000, on the sequential backend (one client at a
    time, the straggler on an extracted sub-model) and on the dense fleet.
    Both runs pick the same stragglers and rates and reach the same round
    times, lower the test loss, and end above chance (shakespeare: see
    PAPER_WORKLOADS); their keep-maps and params are compared and
    reported. A sequential SGD step is one client's; a fleet step is the
    cohort's.

    The fleet is held to the sequential backend as the reference holds its
    own (tests/test_fleet.py:153), and with identical keep-maps too, at
    that test's size: 4 clients, n_data 240, 3 rounds, params within 5e-4.
    At the paper's size the keep-maps and params are reported, not held:
    a straggler's sub-model is masked on the fleet and extracted on the
    sequential backend, so its fp32 sums differ in order; where a max-pool
    window or a ReLU input sits within that rounding of a tie, the
    gradient takes another path, the CNNs' training amplifies it, and the
    invariant policy ranks neurons by update statistics 1-5% apart
    (PERF.md, Findings, PR 20)."""
    out = {}
    for workload, (rounds, chance) in PAPER_WORKLOADS.items():
        name = f"train_paper: {workload}"
        small = [fl_run(torch, workload, b, 4, 3, dev, n_data=240)
                 for b in ("sequential", "fleet")]
        small_diff = hold_same_runs(np, f"{name} at the reference's size, fleet "
                                    f"against sequential", *small)
        seq = fl_run(torch, workload, "sequential", 5, rounds, dev)
        flt = fl_run(torch, workload, "fleet", 5, rounds, dev)
        check(type(seq[0].server.backend).__name__ == "SequentialBackend"
              and not flt[0].server.backend.engine.use_kernels,
              f"{name}: ran on the wrong backends")
        check(any(h.stragglers for h in seq[1]), f"{name}: dropout never engaged")
        loss0 = eval_loss(torch, seq[0], seq[0].model_cls.init(0, device=dev))
        losses = {}
        for run, path in ((seq, "sequential"), (flt, "fleet")):
            check(all(bool(torch.isfinite(p).all()) for p in run[4]),
                  f"{name} {path}: non-finite params")
            losses[path] = eval_loss(torch, run[0], run[0].server.params)
            check(losses[path] < loss0, f"{name} {path}: test loss "
                  f"{losses[path]} not below the initial {loss0}")
            acc = run[1][-1].accuracy
            check(chance is None or acc > chance, f"{name} {path}: final "
                  f"accuracy {acc} not above chance ({chance})")
        hold_same_plans(f"{name} fleet against sequential", seq, flt)
        # the card's own noise floor: the same sequential run again
        again = fl_run(torch, workload, "sequential", 5, rounds, dev)
        hold_same_plans(f"{name} sequential against itself", seq, again)
        same = [same_keep_maps(np, a["keep_maps"], b["keep_maps"])
                for a, b in zip(seq[2], flt[2])]
        out[workload] = {
            "rounds": rounds, "stragglers": [h.stragglers for h in seq[1]],
            "rates": [{str(c): r for c, r in h.rates.items()} for h in seq[1]],
            "round_times_sim": [h.round_time for h in seq[1]],
            "keep_maps_equal_by_round": same,
            "params_max_abs_diff_fleet_vs_sequential": params_diff(seq, flt),
            "sequential_repeat": {
                "keep_maps_equal_by_round": [
                    same_keep_maps(np, a["keep_maps"], b["keep_maps"])
                    for a, b in zip(seq[2], again[2])],
                "params_max_abs_diff": params_diff(seq, again)},
            "test_loss": {"initial": loss0, **losses},
            "reference_size_params_max_abs_diff": small_diff,
            "sequential": run_summary(seq), "fleet": run_summary(flt)}
    return out


def phase_train_dense(torch, np, kernel_runs, dev="cuda"):
    """femnist_kernel and femnist_attn on the dense fleet (torch and cuBLAS
    calls, no hand-written kernel), at 5 clients (6 rounds) and 64 (2
    rounds), each held to the kernel fleet's run of the same config from
    train / train_attn (``kernel_runs``): the same plans, keep-maps and
    round times, params within 5e-4. Then one more round under the
    profiler, as the kernel runs had. ms per SGD step and busy share stand
    beside the kernel fleet's."""
    out = {}
    for workload, by_cohort in kernel_runs.items():
        for n_clients, rounds in ((5, 6), (64, 2)):
            kern, kprof = by_cohort[n_clients]
            dense = fl_run(torch, workload, "fleet", n_clients, rounds, dev)
            check(not dense[0].server.backend.engine.use_kernels,
                  f"train_dense: {workload} ran the kernel path")
            diff = hold_same_runs(np, f"train_dense: {workload} at "
                                  f"{n_clients} clients, dense against kernels",
                                  kern, dense)
            dprof = busy_share(torch, lambda: dense[0].server.run_round())
            out[f"{workload}/{n_clients}"] = {
                "rounds": rounds, "steps_per_round": dense[2][0]["steps"],
                "params_max_abs_diff_dense_vs_kernels": diff,
                "dense_ms_per_sgd_step": ms_per_step(dense[2]),
                "kernel_ms_per_sgd_step": ms_per_step(kern[2]),
                "dense_round_s": [r["round_s"] for r in dense[2]],
                "dense_accuracy": [h.accuracy for h in dense[1]],
                "dense_profile_round": {k: dprof[k] for k in
                                        ("wall_ms", "device_ms", "device_busy_share", "top")},
                "kernel_profile_round": {k: kprof[k] for k in
                                         ("wall_ms", "device_ms", "device_busy_share")}}
    return out


# population and async layer (fl/population.py, fl/shard_fleet.py,
# fl/async_rounds.py): the store and cohort sizes of the reference's
# BENCH_population (smallest cohort) and launch/async_fl's defaults
POP_CFG = dict(n_clients=100_000, cohort_size=200, workload="femnist_kernel",
               backend="fleet", use_kernels=True, n_partitions=64,
               samples_per_partition=100, straggler_frac_pop=0.1)
POP_ROUNDS, POP_DRIFT_AT, POP_SHARDS, POP_BIG_COHORT = 4, 2, 4, 1000
ASYNC_ARGS = ["--workload", "femnist_kernel", "--drop-prob", "0.05",
              "--flash-crowd", "3:20"]
ASYNC_BUFFERS = 10
ATTN_ASYNC = dict(buffer_k=8, concurrency=16, flash_crowds=((1, 20),), buffers=3)
# kernels against plain on the population and async paths: each launch
# within the kernels phase's fp32 tolerance, and the runs' final params
# within 1e-6 (their measured gap is 3e-8 to 9e-8)
HOLD_TOL, POP_PARAM_TOL = 1e-4, 1e-6
# the timing rounds (buffers) that follow the gated runs, nothing wrapped
POP_TIMED_ROUNDS, ASYNC_TIMED_BUFFERS = 3, 5


class CallTimer:
    """While active, wraps methods: each call's seconds (synchronised on
    both sides) and ``info(self, *args)`` go to ``calls[label]``."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets
        self.calls = {label: [] for label in targets}

    def __enter__(self):
        self.orig = []
        for label, (cls, attr, info) in self.targets.items():
            fn = cls.__dict__[attr]
            self.orig.append((cls, attr, fn))

            def wrapped(obj, *a, _fn=fn, _label=label, _info=info, **kw):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = _fn(obj, *a, **kw)
                self.torch.cuda.synchronize()
                self.calls[_label].append(
                    (time.perf_counter() - t0, _info(obj, *a, **kw) if _info else None))
                return res
            setattr(cls, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for cls, attr, fn in self.orig:
            setattr(cls, attr, fn)

    def seconds(self, label):
        return sum(s for s, _ in self.calls[label])


class HoldLaunches:
    """While active, each launch of the masked-FFN training kernels (B1's
    training form, B2, B3) and of the six head-masked kernels (B4-B9) is
    also computed by its plain version on the same inputs. The plain
    versions launch no kernel, so the launch counts stay the path's. Per
    kernel: the launches held, the client counts C they ran at, the worst
    relative ∞-norm and absolute errors, and the rows of the backward
    launches whose incoming gradient is all zero (a padding slot, or a
    client's zero-weighted tail step), whose outputs must be exactly 0."""

    def __init__(self, torch):
        from repro_torch.kernels import masked_attn as attn
        from repro_torch.kernels import masked_ffn as ffn

        def ffn_plain(fn):
            return lambda *a, act: fn(*a, act)
        # name: (module, the function its autograd Function calls, plain
        # version, whether it is a backward kernel)
        self.targets = {
            "masked_ffn_train_fwd": (ffn, "masked_ffn_train_fwd",
                                     ffn_plain(ffn.masked_ffn_batch_plain), False),
            "masked_ffn_dx": (ffn, "masked_ffn_dx", ffn_plain(ffn.masked_ffn_dx_plain), True),
            "masked_ffn_dw": (ffn, "masked_ffn_dw", ffn_plain(ffn.masked_ffn_dw_plain), True),
            "masked_head_proj": (attn, "proj_fwd", attn.masked_head_proj_plain, False),
            "masked_head_proj_dx": (attn, "proj_dx", attn.masked_head_proj_dx_plain, True),
            "masked_head_proj_dw": (attn, "proj_dw", attn.masked_head_proj_dw_plain, True),
            "masked_head_merge": (attn, "merge_fwd", attn.masked_head_merge_plain, False),
            "masked_head_merge_da": (attn, "merge_da", attn.masked_head_merge_da_plain, True),
            "masked_head_merge_dw": (attn, "merge_dw", attn.masked_head_merge_dw_plain, True)}
        self.held = {k: {"n": 0, "C": set(), "rel_err": 0.0, "max_abs_err": 0.0,
                         "zero_grad_rows": 0} for k in self.targets}

    def _held(self, name, fn, plain, backward):
        def call(*a, **kw):
            got, want = fn(*a, **kw), plain(*a, **kw)
            pairs = [(x, y) for x, y in zip(got if isinstance(got, tuple) else (got,),
                                            want if isinstance(want, tuple) else (want,))
                     if y is not None]
            h = self.held[name]
            h["n"] += 1
            h["C"].add(a[0].shape[0])
            h["rel_err"] = max(h["rel_err"], *(rel_inf(x, y) for x, y in pairs))
            h["max_abs_err"] = max(h["max_abs_err"], *(
                float((x.float() - y.float()).abs().max()) for x, y in pairs))
            if backward:                       # a[0] is the incoming gradient
                zero = a[0].flatten(1).abs().amax(1) == 0
                h["zero_grad_rows"] += int(zero.sum())
                check(all(bool((x[zero] == 0).all()) for x, _ in pairs),
                      f"{name}: a row with zero incoming gradient has a nonzero output")
            return got
        return call

    def __enter__(self):
        self.orig = []
        for name, (mod, attr, plain, backward) in self.targets.items():
            fn = getattr(mod, attr)
            self.orig.append((mod, attr, fn))
            setattr(mod, attr, self._held(name, fn, plain, backward))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.orig:
            setattr(mod, attr, fn)

    def check(self, name, counts, kernels, tol=HOLD_TOL):
        """Every launch of ``kernels`` was held, each within ``tol``;
        returns their records."""
        out = {}
        for k in kernels:
            h = self.held[k]
            check(h["n"] == counts[k],
                  f"{name}: {k}: {h['n']} of {counts[k]} launches held against plain")
            check(h["rel_err"] <= tol,
                  f"{name}: {k}: rel err {h['rel_err']} against plain at C {sorted(h['C'])}")
            out[k] = {**h, "C": sorted(h["C"])}
        return out


def sgd_timer(torch, extra=None):
    """CallTimer over the cohort program (``FleetEngine._run``: one call
    launches each kernel once per SGD step), the round's host batch build
    and its invariant stats, plus ``extra``."""
    from repro_torch.fl.fleet import CohortResult, FleetEngine
    return CallTimer(torch, {
        "sgd": (FleetEngine, "_run", lambda e, *a: (e.steps, len(e.clients))),
        "stacked_data": (FleetEngine, "_stacked_data", None),
        "stats": (CohortResult, "non_straggler_stats", None),
        **(extra or {})})


def check_launches(name, counts, timer, per_step):
    """Each kernel of ``per_step`` launched that many times per SGD step of
    every cohort program the timer saw; returns the step count."""
    steps = sum(n for _, (n, _) in timer.calls["sgd"])
    for k, n in per_step.items():
        check(counts[k] == n * steps,
              f"{name}: {k} launched {counts[k]} times, expected {n} per SGD "
              f"step ({n} x {steps})")
    return steps


def wall_rounds(torch, sim, n):
    """Wall seconds of each of ``n`` more rounds (buffers) of ``sim``, with
    nothing wrapped and nothing checked: one synchronize at each end."""
    out = []
    torch.cuda.synchronize()
    for _ in range(n):
        t0 = time.perf_counter()
        sim.run_round()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def round_rate(clients, secs):
    """ms a round and clients/s over rounds of ``clients`` clients."""
    return {"round_s": secs, "ms_per_round": 1e3 * sum(secs) / len(secs),
            "clients_per_s": clients * len(secs) / sum(secs)}


def part_shares(torch, sim, n, extra=None):
    """``n`` more rounds (buffers) of ``sim`` under sgd_timer, which
    synchronises on both sides of each timed part (so no part overlaps
    another, and these rounds run slower than wall_rounds'): ms per SGD
    step of the cohort program, and the ms a round and share of the
    round of the host batch build and of the invariant stats. Returns
    (parts, timer)."""
    with sgd_timer(torch, extra) as timer:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            sim.run_round()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    sgd = timer.calls["sgd"]
    stacked, stats = timer.seconds("stacked_data"), timer.seconds("stats")
    return {"rounds": n, "synced_ms_per_round": 1e3 * total / n,
            "ms_per_sgd_step": 1e3 * sum(s for s, _ in sgd) / sum(k for _, (k, _) in sgd),
            "stacked_data_ms_per_round": 1e3 * stacked / n,
            "stacked_data_share": stacked / total,
            "stats_ms_per_round": 1e3 * stats / n, "stats_share": stats / total}, timer


def leaves_of(sim):
    from repro_torch.core.tree import tree_leaves
    return tree_leaves(sim.server.params)


def store_equal(np, a, b):
    from repro_torch.fl.population import ClientStore
    import dataclasses
    return all(np.array_equal(getattr(a, f.name), getattr(b, f.name),
                              equal_nan=True)
               for f in dataclasses.fields(ClientStore))


def hold_same_histories(name, ha, hb, clock=False):
    check(len(ha) == len(hb), f"{name}: {len(ha)} rounds against {len(hb)}")
    for x, y in zip(ha, hb):
        check(x.stragglers == y.stragglers and x.rates == y.rates,
              f"{name}: round {x.round} plan differs")
        check(x.round_time == y.round_time,
              f"{name}: round {x.round} time {x.round_time} against {y.round_time}")
        check(not clock or (x.clock, x.staleness_max, x.staleness_mean)
              == (y.clock, y.staleness_max, y.staleness_mean),
              f"{name}: round {x.round} clock or staleness differs")


def max_diff(a, b):
    return max(float((p - q).abs().max()) for p, q in zip(a, b))


def pop_run(torch, rounds, dev="cuda", drift_at=None, **over):
    """A population run through ``build_population``: ``rounds`` rounds,
    the last evaluated; before round ``drift_at`` a sampled full-model
    client of the next cohort slows to 2x base. Returns (sim, per-round
    log of RoundRecorder, timer, drift victim)."""
    from repro_torch.fl.population import PopulationConfig, build_population
    sim = build_population(PopulationConfig(**{**POP_CFG, **over, "device": dev}))
    victim = None
    with RoundRecorder(torch) as rec, sgd_timer(torch) as timer:
        for r in range(rounds):
            if r == drift_at:
                ids = sim.cohort_ids()
                victim = int(next(
                    c for c in ids if sim.store.rates_of([c])[0] == 1.0
                    and sim.store.speeds_of([c])[0] < 1.2 * sim.cfg.base_speed))
                sim.set_speed(victim, 2 * sim.cfg.base_speed)
            sim.run_round(eval_now=r == rounds - 1)
    return sim, rec.log, timer, victim


def store_op_ms(np, sim, reps=20):
    """Host ms of the store's per-round ops over the whole registry."""
    store, size = sim.store, sim.cfg.cohort_size
    out = {}
    t0 = time.perf_counter()
    for r in range(reps):
        noise = sim.cohort_noise(100 + r)
    out["cohort_noise_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        ids = store.sample_cohort(noise, size)
    out["sample_cohort_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    lat = np.linspace(9.0, 14.0, size, dtype=np.float32)
    rates = np.ones(size, np.float32)
    t0 = time.perf_counter()
    for _ in range(reps):
        store.update_from_round(ids, lat, rates)
    out["update_from_round_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    out["store_size"] = store.capacity
    return out


def stats_forms(torch, sim, dev, turns=4):
    """The round's invariant stats two ways on one cohort result of
    ``sim``'s next cohort: batched over the clients (the fleet's
    ``non_straggler_stats``) and one ``neuron_stats`` call a client, each
    brought to the host, in turns (A, B, B, A, ...). Returns the ms of
    each and their largest relative difference."""
    from repro_torch.core import invariant as inv
    from repro_torch.core.tree import tree_map
    from repro_torch.fl.rounds import make_backend
    be = make_backend("fleet", sim.model_cls, sim._materialize(sim.cohort_ids()),
                      sim.model_cls.UNIT_SPECS, use_kernels=True, device=dev)
    params = sim.server.params
    res = be.run_round(params, {}, {})
    specs = sim.model_cls.UNIT_SPECS

    def per_client():
        return [{g: v.cpu() for g, v in inv.neuron_stats(
            params, tree_map(lambda p, d: p + d[i], params, res.deltas), specs).items()}
            for i in range(len(res.client_ids))]
    forms = {"batched": lambda: res.non_straggler_stats(params), "per_client": per_client}
    ms = {k: [] for k in forms}
    out = {}
    for t in range(turns):
        for k in (("batched", "per_client") if t % 2 == 0 else ("per_client", "batched")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[k] = forms[k]()
            ms[k].append(1e3 * (time.perf_counter() - t0))
    rel = max(float(((a[g] - b[g]).abs() / b[g].abs().clamp_min(1e-30)).max())
              for a, b in zip(out["batched"], out["per_client"]) for g in b)
    return {"clients": len(res.client_ids), "batched_ms": ms["batched"],
            "per_client_ms": ms["per_client"], "max_rel_diff": rel}


def phase_population(torch, np, dev="cuda"):
    """The population layer on the card: a 100 000-client store, cohorts
    of 200 sampled per round, femnist_kernel on the kernel fleet, 4
    rounds with a drift before round 2. Gates: each masked-FFN training
    kernel launched once per SGD step, and each launch held against its
    plain version on the same inputs (HoldLaunches); dropout engaged and
    the drifted client flagged; finite params; the same run with the plain
    versions swapped in gives identical cohorts, stragglers, rates,
    keep-maps and round times and params within 1e-6; the sharded fleet (4
    shards, every launch held) the same plans, params within 1e-6, and
    shard partials that sum left to right to its numerator bitwise. Then
    one round at cohort 1000, every launch held. The times come from
    rounds that follow the gated ones: ms a round and clients/s with
    nothing wrapped, the parts' shares from rounds timed part by part."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.fl.rounds import make_backend
    from repro_torch.kernels import ops
    name = "population"
    cohort = POP_CFG["cohort_size"]
    per_step = dict(FLEET_PER_STEP)
    ops.reset_launch_counts()                  # main path starts here
    with HoldLaunches(torch) as hold:
        sim, log, timer, victim = pop_run(torch, POP_ROUNDS, dev, drift_at=POP_DRIFT_AT)
    counts = ops.launch_counts()               # main path ends here
    steps = check_launches(name, counts, timer, per_step)
    held = hold.check(name, counts, TRAIN_KERNELS)
    hist, params = list(sim.server.history), [p.clone() for p in leaves_of(sim)]
    check(all(bool(torch.isfinite(p).all()) for p in params), f"{name}: non-finite params")
    check(any(h.stragglers for h in hist), f"{name}: dropout never engaged")
    check(all(victim not in h.stragglers for h in hist[:POP_DRIFT_AT + 1])
          and victim in hist[POP_DRIFT_AT + 1].stragglers
          and sim.store.rates_of([victim])[0] < 1.0,
          f"{name}: client {victim}, slowed before round {POP_DRIFT_AT}, "
          f"was not flagged after it")

    undo = swap_in_plain(ops)
    try:
        psim, plog, *_ = pop_run(torch, POP_ROUNDS, dev, drift_at=POP_DRIFT_AT)
        for x, y in zip(log, plog):
            check(x["ids"] == y["ids"] and same_keep_maps(np, x["keep_maps"], y["keep_maps"]),
                  f"{name}: kernels and plain cohorts or keep-maps differ")
        hold_same_histories(f"{name} (kernels against plain)", hist, psim.server.history)
        plain_diff = max_diff(params, leaves_of(psim))
        check(plain_diff <= POP_PARAM_TOL,
              f"{name}: kernels against plain params differ by {plain_diff}")
        plain_s = wall_rounds(torch, psim, POP_TIMED_ROUNDS)
        plain_parts, _ = part_shares(torch, psim, 2)
    finally:
        undo()
    del psim

    ops.reset_launch_counts()
    with HoldLaunches(torch) as shold:
        ssim, slog, stimer, _ = pop_run(torch, POP_ROUNDS, dev, drift_at=POP_DRIFT_AT,
                                        backend="sharded_fleet", n_shards=POP_SHARDS)
    shard_counts = ops.launch_counts()
    check({r["backend"] for r in slog} == {"ShardedFleetBackend"},
          f"{name}: the sharded run took another backend")
    shard_steps = check_launches(f"{name} sharded", shard_counts, stimer, per_step)
    shard_held = shold.check(f"{name} sharded", shard_counts, TRAIN_KERNELS)
    check(len(stimer.calls["sgd"]) == POP_SHARDS * POP_ROUNDS,
          f"{name}: {len(stimer.calls['sgd'])} shard programs, expected "
          f"{POP_SHARDS} a round")
    for x, y in zip(log, slog):
        check(x["ids"] == y["ids"] and same_keep_maps(np, x["keep_maps"], y["keep_maps"]),
              f"{name}: sharded and fleet cohorts or keep-maps differ")
    hold_same_histories(f"{name} (sharded against fleet)", hist, ssim.server.history)
    shard_diff = max_diff(params, leaves_of(ssim))
    check(shard_diff <= POP_PARAM_TOL,
          f"{name}: sharded against fleet params differ by {shard_diff}")
    # one more sharded cohort program: its partials against its numerator
    clients = ssim._materialize(ssim.cohort_ids())
    ids = [c.id for c in clients]
    rates = {c: float(r) for c, r in zip(ids, ssim.store.rates_of(ids)) if r < 1.0}
    be = make_backend("sharded_fleet", ssim.model_cls, clients, ssim.model_cls.UNIT_SPECS,
                      n_shards=POP_SHARDS, use_kernels=True, device=dev)
    res = be.run_round(ssim.server.params,
                       {c: ssim.server.policy.keep_map(r) for c, r in rates.items()}, rates)
    pr_num, pr_w = res.shard_partials

    def chain(a):
        acc = a[0]
        for i in range(1, a.shape[0]):
            acc = acc + a[i]
        return acc
    check(all(torch.equal(x, y) for x, y in zip(tree_leaves(tree_map(chain, pr_num)),
                                                tree_leaves(res.num)))
          and torch.equal(chain(pr_w), res.w_per_mask),
          f"{name}: shard partials do not sum to the numerator bitwise")
    del be, res
    shard_s = wall_rounds(torch, ssim, POP_TIMED_ROUNDS)
    del ssim

    round_s = wall_rounds(torch, sim, POP_TIMED_ROUNDS)
    parts, _ = part_shares(torch, sim, 2)
    prof = busy_share(torch, lambda: sim.run_round())
    store_ms = store_op_ms(np, sim)
    del sim

    ops.reset_launch_counts()
    with HoldLaunches(torch) as bhold:
        bsim, _, btimer, _ = pop_run(torch, 1, dev, cohort_size=POP_BIG_COHORT)
    big_counts = ops.launch_counts()
    check_launches(f"{name} cohort {POP_BIG_COHORT}", big_counts, btimer, per_step)
    big_held = bhold.check(f"{name} cohort {POP_BIG_COHORT}", big_counts, TRAIN_KERNELS)
    check(all(bool(torch.isfinite(p).all()) for p in leaves_of(bsim)),
          f"{name}: cohort {POP_BIG_COHORT}: non-finite params")
    big_s = wall_rounds(torch, bsim, 1)
    big_parts, _ = part_shares(torch, bsim, 1)
    bprof = busy_share(torch, lambda: bsim.run_round())
    stats_ab = stats_forms(torch, bsim, dev)
    return {
        "config": {**POP_CFG, "rounds": POP_ROUNDS, "drift_before_round": POP_DRIFT_AT},
        "steps_per_round": log[0]["steps"], "timed_rounds": POP_TIMED_ROUNDS,
        **round_rate(cohort, round_s), "parts": parts,
        "round_times_sim": [h.round_time for h in hist],
        "n_stragglers": [len(h.stragglers) for h in hist],
        "rates_used": [sorted(set(h.rates.values())) for h in hist],
        "drift_victim": victim, "accuracy": hist[-1].accuracy,
        "held_against_plain": held,
        "plain": {**round_rate(cohort, plain_s), "parts": plain_parts},
        "params_max_abs_diff_vs_plain": plain_diff,
        "sharded": {"n_shards": POP_SHARDS, **round_rate(cohort, shard_s),
                    "params_max_abs_diff_vs_fleet": shard_diff,
                    "held_against_plain": shard_held,
                    "launches": shard_counts, "sgd_steps": shard_steps},
        "profile_round": prof, "store_ops": store_ms,
        f"cohort{POP_BIG_COHORT}": {
            **round_rate(POP_BIG_COHORT, big_s), "parts": big_parts,
            "held_against_plain": big_held, "launches": big_counts,
            "profile_round": bprof, "stats_forms": stats_ab},
        "launches": counts, "sgd_steps": steps}


def async_run(torch, np, argv, buffers, dev="cuda", **acfg):
    """launch/async_fl's config from ``argv`` (its defaults otherwise),
    with the kernels on (and AsyncConfig fields overridden by ``acfg``),
    ``buffers`` buffers. Checks at every dispatch that no client in flight
    is sampled again. Returns (sim, timer)."""
    import dataclasses
    from repro_torch.fl.async_rounds import AsyncBufferedBackend
    from repro_torch.fl.population import build_population
    from repro_torch.launch import async_fl
    args = async_fl.make_parser().parse_args(argv + ["--device", dev])
    cfg = dataclasses.replace(async_fl.build_cfg(args), use_kernels=True)
    if acfg:
        cfg = dataclasses.replace(cfg, async_cfg=dataclasses.replace(cfg.async_cfg, **acfg))
    sim = build_population(cfg)
    resampled = []
    orig = AsyncBufferedBackend.set_dispatch

    def set_dispatch(backend, clients):
        resampled.extend({c.id for c in clients} & backend.in_flight_ids)
        orig(backend, clients)
    group = {"group": (AsyncBufferedBackend, "_dispatch_chunk",
                       lambda be, params, chunk, km, rates, members: members is not None)}
    with sgd_timer(torch, group) as timer:
        AsyncBufferedBackend.set_dispatch = set_dispatch
        try:
            for b in range(buffers):
                sim.run_round(eval_now=b == buffers - 1)
        finally:
            AsyncBufferedBackend.set_dispatch = orig
    check(not resampled, f"async: clients {sorted(resampled)[:8]} sampled while in flight")
    check(set(np.flatnonzero(sim.store.in_flight).tolist()) == sim.backend.in_flight_ids,
          "async: the store's in-flight set is not the backend's")
    return sim, timer


def hold_async_against_plain(np, name, a, b):
    """Two async runs: the same clock, arrivals, staleness, plans,
    keep-maps and store, params within POP_PARAM_TOL; returns the params'
    gap."""
    (sa, *_), (sb, *_) = a, b
    hold_same_histories(name, sa.server.history, sb.server.history, clock=True)
    check(sa.backend.last_arrived == sb.backend.last_arrived
          and sa.backend.in_flight_ids == sb.backend.in_flight_ids,
          f"{name}: arrivals differ")
    check(store_equal(np, sa.store, sb.store), f"{name}: stores differ")
    diff = max_diff(leaves_of(sa), leaves_of(sb))
    check(diff <= POP_PARAM_TOL, f"{name}: params differ by {diff}")
    return diff


def phase_async(torch, np, dev="cuda"):
    """The async buffered backend on the card: launch/async_fl's defaults
    (20 000 clients, buffer_k 16, concurrency 128, staleness exponent 0.5,
    client tail 0.6) on femnist_kernel with the kernels, drop_prob 0.05
    and a flash crowd of 20 at step 3 (a padded dispatch group), 10
    buffers. Gates: each masked-FFN kernel launched once per SGD step of
    every dispatch group, and each launch held against its plain version
    on the same inputs, a padding slot's rows exactly 0; stale arrivals
    and survived dropouts; the store's in-flight set is the backend's, and
    no client is sampled while in flight; the plain versions give the same
    clock, arrivals, staleness and plans, params within 1e-6. A
    zero-spread run (buffer_k = concurrency = cohort 16, pass-through
    arrivals, no tail, 3 rounds) equals the kernel fleet bitwise. A short
    femnist_attn run (K 8, concurrency 16, a flash crowd of 20 at step 1,
    3 buffers) holds the head-masked kernels under padding against their
    plain versions in the same two ways. The times come from buffers that
    follow the gated ones."""
    from repro_torch.core.straggler import ArrivalModel
    from repro_torch.fl.async_rounds import AsyncBufferedBackend, AsyncConfig
    from repro_torch.fl.population import PopulationConfig, build_population
    from repro_torch.kernels import ops
    name = "async"
    per_step = dict(FLEET_PER_STEP)
    ops.reset_launch_counts()                  # main path starts here
    with HoldLaunches(torch) as hold:
        run = async_run(torch, np, ASYNC_ARGS, ASYNC_BUFFERS, dev)
    counts = ops.launch_counts()               # main path ends here
    sim, timer = run
    steps = check_launches(name, counts, timer, per_step)
    held = hold.check(name, counts, TRAIN_KERNELS)
    hist, be = list(sim.server.history), sim.backend
    check(all(n == be.cfg.buffer_k for _, (_, n) in timer.calls["sgd"]),
          f"{name}: a dispatch group not of buffer_k clients")
    padded = sum(1 for _, pad in timer.calls["group"] if pad)
    check(padded > 0, f"{name}: no padded dispatch group")
    check(held["masked_ffn_dw"]["zero_grad_rows"] > 0, f"{name}: no padding row held")
    check(any(h.staleness_max > 0 for h in hist), f"{name}: no stale arrival")
    check(be.total_drops > 0, f"{name}: no dropout survived")
    check(any(h.stragglers for h in hist), f"{name}: dropout never engaged")
    check(all(bool(torch.isfinite(p).all()) for p in leaves_of(sim)),
          f"{name}: non-finite params")

    undo = swap_in_plain(ops)
    try:
        plain = async_run(torch, np, ASYNC_ARGS, ASYNC_BUFFERS, dev)
    finally:
        undo()
    plain_diff = hold_async_against_plain(np, f"{name} (kernels against plain)", run, plain)
    del plain

    # zero spread: async at buffer_k = concurrency = cohort equals the fleet
    zero = dict(POP_CFG, n_clients=20_000, cohort_size=16, device=dev)
    fleet = build_population(PopulationConfig(**zero))
    fleet.run(3)
    asy = build_population(PopulationConfig(**{**zero, "backend": "async"}, async_cfg=AsyncConfig(
        buffer_k=16, concurrency=16, arrival=ArrivalModel())))
    asy.run(3)
    hf, ha = fleet.server.history, asy.server.history
    zero_ok = {
        "params": all(torch.equal(a, b) for a, b in zip(leaves_of(fleet), leaves_of(asy))),
        "store": store_equal(np, fleet.store, asy.store),
        "plans": all(x.stragglers == y.stragglers and x.rates == y.rates
                     and x.round_time == y.round_time and x.threshold == y.threshold
                     for x, y in zip(hf, ha)),
        # left to right, as the clock adds them (Python's sum of floats
        # compensates, so it can differ in the last place)
        "clock_is_barrier_sum": [h.clock for h in ha]
        == list(itertools.accumulate(h.round_time for h in hf))}
    check(all(zero_ok.values()), f"{name}: zero-spread async against the kernel fleet: {zero_ok}")
    check(any(h.stragglers for h in hf), f"{name}: zero-spread run never dropped")
    del fleet, asy

    # femnist_attn under padding, kernels against plain
    attn_argv = ["--workload", "femnist_attn", "--drop-prob", "0.05"]
    acfg = {k: v for k, v in ATTN_ASYNC.items() if k != "buffers"}
    ops.reset_launch_counts()
    with HoldLaunches(torch) as ahold:
        attn = async_run(torch, np, attn_argv, ATTN_ASYNC["buffers"], dev, **acfg)
    attn_counts = ops.launch_counts()
    attn_steps = check_launches(f"{name} femnist_attn", attn_counts, attn[1],
                                {**per_step, **ATTN_KERNELS})
    attn_held = ahold.check(f"{name} femnist_attn", attn_counts,
                            (*TRAIN_KERNELS, *ATTN_KERNELS))
    check(any(pad for _, pad in attn[1].calls["group"]),
          f"{name} femnist_attn: no padded dispatch group")
    check(all(attn_held[k]["zero_grad_rows"] > 0 for k in HEAD_DW),
          f"{name} femnist_attn: no padding row held")
    undo = swap_in_plain(ops)
    try:
        attn_plain = async_run(torch, np, attn_argv, ATTN_ASYNC["buffers"], dev, **acfg)
    finally:
        undo()
    attn_diff = hold_async_against_plain(np, f"{name} femnist_attn (kernels against plain)",
                                         attn, attn_plain)
    del attn, attn_plain

    clock = sim.clock                          # after the gated buffers
    buf_s = wall_rounds(torch, sim, ASYNC_TIMED_BUFFERS)
    group = {"group": (AsyncBufferedBackend, "_dispatch_chunk", None)}
    parts, ptimer = part_shares(torch, sim, ASYNC_TIMED_BUFFERS, group)
    group_s = [s for s, _ in ptimer.calls["group"]]
    prof = busy_share(torch, lambda: sim.run_round())
    return {
        "config": {"argv": ASYNC_ARGS, "buffers": ASYNC_BUFFERS, "buffer_k": be.cfg.buffer_k,
                   "concurrency": be.cfg.concurrency, "n_clients": sim.cfg.n_clients},
        "virtual_clock_s": clock, "timed_buffers": ASYNC_TIMED_BUFFERS, "buffer_s": buf_s,
        "buffers_per_wall_s": len(buf_s) / sum(buf_s),
        "parts": {**parts, "dispatch_groups": len(group_s),
                  "ms_per_dispatch_group": 1e3 * sum(group_s) / len(group_s)},
        "padded_groups": padded,
        "staleness_max": [h.staleness_max for h in hist],
        "n_stragglers": [len(h.stragglers) for h in hist],
        "dropouts_survived": be.total_drops, "dispatched": be.n_dispatched,
        "in_flight": len(be.in_flight_ids), "accuracy": hist[-1].accuracy,
        "held_against_plain": held, "params_max_abs_diff_vs_plain": plain_diff,
        "zero_spread": {**zero_ok, "rounds": 3, "clock_s": ha[-1].clock},
        "femnist_attn": {**ATTN_ASYNC, "flash_crowds": list(ATTN_ASYNC["flash_crowds"]),
                         "params_max_abs_diff_vs_plain": attn_diff,
                         "held_against_plain": attn_held,
                         "launches": attn_counts, "sgd_steps": attn_steps},
        "profile_buffer": prof, "launches": counts, "sgd_steps": steps}


# ---------------------------------------------------------------------------
# analysis: the dropped-dW NaN-poison contracts through B1-B9 at the zoo's
# widths, the no-host-sync regions, mask-as-data on the card

ANALYSIS_FFN_M = 8                         # rows of x at full width (bf16)
ANALYSIS_ATTN = dict(B=1, S=8)            # batch and sequence at full width (bf16)
ANALYSIS_FLEET = dict(n_clients=5, n_data=2000)   # the train phase's cohort
ANALYSIS_DECODE = dict(batch=8, prompt_len=512, gen_len=17, rates=(1.0, 0.5, 0.25))


def sync_region(torch, regions, name, fn, *args, dev="cuda"):
    """fn(*args) in a region no host sync may enter
    (analysis/contracts.host_sync_region: the recorder, and on the card
    torch.cuda.set_sync_debug_mode("error")); fails on any sync. Its
    seconds and launches go to ``regions`` (name -> line), for the
    analysis line."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vs, out = contracts.sync_violations("no-host-sync", name, fn, *args, device=dev)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    check(not vs, f"analysis: {'; '.join(map(str, vs))}")
    regions[name] = {"s": time.perf_counter() - t0,
                     "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}
    return out


def sync_decode(torch, np, params, cfg, regions):
    """StableLM-2-12B's ServeEngine at full width: every decode chunk of a
    short mixed-rate queue in a host-sync region (the chunk's program, as
    the reference's jitted chunk; its inputs go to the card and its tokens
    come back outside)."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import ops
    from repro_torch.launch.serving import ServeEngine, ServeRequest, rate_masks
    q = ANALYSIS_DECODE
    eng = ServeEngine(cfg, params, batch_size=q["batch"], max_prompt_len=q["prompt_len"],
                      max_gen_len=q["gen_len"], device="cuda")
    rng = np.random.RandomState(0)
    for i in range(q["batch"]):
        r = q["rates"][i % len(q["rates"])]
        eng.submit(ServeRequest(rng.randint(0, 256, (q["prompt_len"],), dtype=np.int32),
                                gen_len=q["gen_len"],
                                masks=None if r >= 1.0 else rate_masks(cfg, r)))
    name = "ServeEngine._decode_program[stablelm-12b]"
    before = ops.launch_counts()
    t0 = time.perf_counter()
    with contracts.watching_syncs(eng, "_decode_program", name, "cuda") as found:
        results = eng.run()
    torch.cuda.synchronize()
    after = ops.launch_counts()
    check(not found, f"analysis: {'; '.join(map(str, found))}")
    check(len(results) == q["batch"], f"analysis: the decode region served {len(results)} "
          f"of {q['batch']} requests")
    regions[name] = {"s": time.perf_counter() - t0, "chunks": eng.stats["chunks"],
                     "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


def analysis_ffn_cases(torch):
    """(label, F, kind, d, M, dtype) of dw-zero-ffn on the card: the
    reference's cases (d 16, M 8, fp32), then every zoo arch's (d_model, F,
    ffn_kind) in bf16 and the kernel fleet's FFNs (d 64), M 8."""
    from repro_torch.analysis import contracts
    from repro_torch.configs.base import all_configs
    cases = [(f"ref {arch}", F, kind, 16, 8, torch.float32)
             for (F, kind), arch in sorted(contracts._ffn_cases().items())]
    seen = set()
    for arch, cfg in sorted(all_configs().items()):
        for F in sorted({cfg.d_ff, cfg.moe_ff}):
            if (cfg.d_model, F) not in seen:
                seen.add((cfg.d_model, F))
                cases.append((arch, F, cfg.ffn_kind, cfg.d_model, ANALYSIS_FFN_M,
                              torch.bfloat16))
    cases += [("kernel_mlp", 1024, "gelu", 64, ANALYSIS_FFN_M, torch.bfloat16),
              ("kernel_attn", 256, "gelu", 64, ANALYSIS_FFN_M, torch.bfloat16)]
    return cases


def analysis_attn_cases(torch):
    """(label, H, hd, d, B, S, dtype) of dw-zero-attn on the card: the
    reference's (B 1, S 4, d 16, hd 8, fp32) for every zoo head count and
    4, then every arch's (H, hd, d_model) in bf16."""
    from repro_torch.analysis import contracts
    from repro_torch.analysis.kernel_contracts import head_layouts
    cases = [(f"ref H={H}", H, 8, 16, 1, 4, torch.float32) for H in contracts.zoo_head_counts()]
    cases += [(arch, H, hd, d, ANALYSIS_ATTN["B"], ANALYSIS_ATTN["S"], torch.bfloat16)
              for (H, hd, d), (arch, _) in head_layouts().items()]
    return cases


def phase_analysis(torch, np, regions):
    """repro_torch.analysis on the card: dw-zero-ffn through B1-B3 and
    dw-zero-attn through B4-B9 at the reference's cases and at every zoo
    arch's full width (each case a line: shape, ms of its poisoned forward
    and backward, the verdicts); the kernel-fleet cohort program and
    combine in a host-sync region (with those the serve and train_zoo
    phases ran: ``regions``); mask-as-data of StableLM-2-12B's masked
    train step (smoke size) under three masks. Every launch here goes on
    this phase's line, none on the kernels summary's."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import _build, ops
    smi = nvidia_smi()
    before = ops.launch_counts()
    bad = []

    def report(kind, label, shape, res, vs):
        ms = time_ms(res["run"], torch, n=5, warmup=1) if "run" in res else None
        line = {"analysis_case": kind, "case": label, **shape, "ms": ms,
                "finite": res.get("finite"), "refused": res.get("refused"),
                "dropped_zero": res.get("dropped_zero"), "kept_err": res.get("kept_err"),
                "violations": [str(v) for v in vs], "card": smi}
        print(json.dumps(line), flush=True)
        bad.extend(vs)
        return {"case": label, **shape, "ms": ms}
    ffn = []
    for label, F, kind, d, M, dtype in analysis_ffn_cases(torch):
        res = contracts.ffn_poison_case(F, kind, "cuda", d=d, M=M, dtype=dtype)
        where = f"masked_ffn[F={F}, {kind}, d={d}, {str(dtype)[6:]}] ({label})"
        ffn.append(report("dw-zero-ffn", label, {"F": F, "kind": kind, "d": d, "M": M,
                                                 "dtype": str(dtype)[6:]},
                          res, contracts.ffn_case_violations(where, res, dtype)))
    attn = []
    for label, H, hd, d, B, S, dtype in analysis_attn_cases(torch):
        res = contracts.attn_poison_case(H, "cuda", B=B, S=S, d=d, hd=hd, dtype=dtype)
        where = f"masked_attention[H={H}, hd={hd}, d={d}, {str(dtype)[6:]}] ({label})"
        attn.append(report("dw-zero-attn", label, {"H": H, "hd": hd, "d": d, "B": B, "S": S,
                                                   "dtype": str(dtype)[6:]},
                           res, contracts.attn_case_violations(where, res, dtype)))
    gc.collect()
    torch.cuda.empty_cache()
    program, args = contracts.fleet_sync_program("cuda", **ANALYSIS_FLEET)
    program(*args)                         # warm, outside the region
    sync_region(torch, regions, "fleet cohort program + combine[femnist_kernel, 5 clients]",
                program, *args)
    calls = []
    built = (sorted(_build._libs), _build._digest())
    vs = contracts.check_train_step_mask_as_data(device="cuda", calls=calls)
    bad.extend(vs)
    check(built == (sorted(_build._libs), _build._digest()),
          "analysis: mask-as-data built or loaded a kernel")
    after = ops.launch_counts()
    check(not bad, "analysis: " + "; ".join(map(str, bad[:6])))
    for name in ("ServeEngine._decode_program[stablelm-12b]",
                 "make_train_step[stablelm-12b, 8 layers, use_kernels]"):
        check(name in regions, f"analysis: the {name} region did not run")
    return {"card": smi, "dw_zero_ffn": ffn, "dw_zero_attn": attn,
            "no_host_sync": regions,
            "mask_as_data_train": {"steps": len(calls), "ops_a_step": len(calls[0]["ops"]),
                                   "launches_a_step": {k: v for k, v in calls[0]["launches"].items()
                                                       if v}},
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


# ---------------------------------------------------------------------------
# the paper phase: the example twins (examples/*_torch.py) and the paper's
# experiment drivers (scripts/paper_experiments_torch.py) on the card

# The phase keeps to ~240 s: Table 2 runs 12 rounds (the validation pass
# 20, whose 12 runs took 164 s on an H100), Fig 4a and 4b their drivers'
# default 6 and 12 rounds (the validation pass 10 and 16)
PAPER_COHORT = dict(n_data=2000)    # CohortConfig's default, 5 clients: the paper's scale
PAPER_TABLE2 = dict(rates=(0.75, 0.5), rounds=12, seeds=(0, 1))
PAPER_FIG4 = dict(fig4a=6, fig4b=12)                              # rounds
PAPER_TABLE3 = dict(rounds=6, thresholds=(0.002, 0.005, 0.01, 0.02, 0.05))
PAPER_SMALL = dict(fig6=dict(rounds=20, n_data=800),              # the validation pass's sizes
                   fig5=dict(n_clients=10, rounds=10, n_data=1200),
                   insight=dict())                                # its defaults: 15 rounds, 1500
PAPER_DET = dict(rate=0.75, rounds=6)     # Table 2's femnist run, invariant, twice per setting
FEMNIST_CHANCE = 1 / 62
FL_TWINS = ("quickstart", "compare_dropout_methods", "dynamic_stragglers", "fluid_datacenter")
# per launch, relative ∞-norm: the twin serves the example's bf16 smoke
# config, so the bf16 tolerance of every held launch (phase_small's 1e-3
# holds fp32 logits)
SERVE_TWIN_TOL = 1e-2


def load_file(name, rel):
    """The module at ``rel`` in the checkout, imported under ``name``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args):
    """(fn(*args), the lines it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    return res, buf.getvalue().splitlines()


def paper_twins(torch, np, dev="cuda"):
    """The five example twins through their main() at the reference's own
    sizes. The four FL and train twins launch no hand-written kernel (the
    sequential backend and the dense train step), and the dynamic one's
    assertion holds; the serve twin serves StableLM-2-12B's smoke config
    through B1 and B11, every launch held against its plain version."""
    from repro_torch.kernels import ops
    out = {}
    for name in FL_TWINS:
        twin = load_file(f"{name}_torch", f"examples/{name}_torch.py")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            res, lines = printed(twin.main, ["--device", dev])
        except AssertionError as e:
            raise SmokeFailure(f"paper: {name}_torch: {e}") from e
        counts = ops.launch_counts()
        check(set(counts.values()) == {0}, f"paper: {name}_torch launched a kernel: {counts}")
        out[name] = {"s": time.perf_counter() - t0, "lines": lines}
        if name == "compare_dropout_methods":
            out[name]["accuracy"] = res
        elif name == "fluid_datacenter":
            out[name]["modelled_full_fluid"] = list(res[:2])
            check(all(np.isfinite(loss) for loss, _, _ in res[2]),
                  "paper: fluid_datacenter_torch: non-finite loss")
    twin = load_file("serve_example_torch", "examples/serve_example_torch.py")
    worst = {"masked_ffn_batch": 0.0, "decode_gqa": 0.0}
    held = {}
    ops.reset_launch_counts()                  # the serve twin's path starts here
    t0 = time.perf_counter()
    undo = hold_each_launch(ops, worst, held)
    try:
        (results, summ), lines = printed(twin.main, ["--device", dev])
    finally:
        undo()
    counts = {k: ops.launch_counts()[k] for k in SERVE_KERNELS}    # and ends here
    from repro_torch.configs import get_config
    layers = get_config("stablelm-12b").smoke().n_layers
    for k in SERVE_KERNELS:
        check(counts[k] == layers * summ["decode_steps"] and held.get(k) == counts[k],
              f"paper: serve_example_torch {k}: {counts[k]} launches, {held.get(k)} held, "
              f"expected {layers} x {summ['decode_steps']} decode steps")
    check(max(worst.values()) <= SERVE_TWIN_TOL,
          f"paper: serve_example_torch per-launch kernel vs plain {worst}")
    check(sorted(results) == list(range(5)), "paper: serve_example_torch lost a request")
    out["serve_example"] = {"s": time.perf_counter() - t0, "lines": lines,
                            "launches": counts, "held": held, "per_launch_rel_err": worst,
                            "decode_steps": summ["decode_steps"]}
    return out


def recording_sims(pe, built):
    """Wrap the drivers' ``_sim`` so every simulation they build is kept."""
    inner = pe._sim

    def _sim(*a, **kw):
        sim = inner(*a, **kw)
        built.append(sim)
        return sim
    pe._sim = _sim
    return lambda: setattr(pe, "_sim", inner)


def hold_sims(torch, name, built, accuracy=True):
    """Every parameter of every simulation finite; each final accuracy
    (where the run evaluated) above chance. Returns the accuracies."""
    from repro_torch.core.tree import tree_leaves
    accs = []
    for sim in built:
        check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(sim.server.params)),
              f"paper: {name}: non-finite params")
        acc = sim.server.history[-1].accuracy
        if accuracy and acc == acc:
            check(acc > FEMNIST_CHANCE, f"paper: {name}: final accuracy {acc} not above "
                  f"chance ({FEMNIST_CHANCE})")
            accs.append(acc)
    return accs


def determinism_run(torch, pe, dev):
    """Table 2's femnist run (invariant, r 0.75, 5 clients, n_data 2000):
    keep-maps by round, final params, ms a client SGD step."""
    from repro_torch.core.tree import tree_leaves
    with RoundRecorder(torch) as rec:
        sim = pe._sim("femnist", method="invariant", fixed_rate=PAPER_DET["rate"],
                      seed=0, device=dev, **PAPER_COHORT)
        hist = sim.server.run(PAPER_DET["rounds"], eval_every=PAPER_DET["rounds"])
    return {"keep_maps": [r["keep_maps"] for r in rec.log],
            "params": [p.clone() for p in tree_leaves(sim.server.params)],
            "ms_per_client_step": ms_per_step(rec.log, "client_steps"),
            "accuracy": hist[-1].accuracy}


def repeat_of(np, a, b):
    same_km = [same_keep_maps(np, x, y) for x, y in zip(a["keep_maps"], b["keep_maps"])]
    diff = max(float((p - q).abs().max()) for p, q in zip(a["params"], b["params"]))
    return {"keep_maps_equal_by_round": same_km,
            "params_bitwise": all(bool((p == q).all()) for p, q in zip(a["params"], b["params"])),
            "params_max_abs_diff": diff,
            "ms_per_client_step": [a["ms_per_client_step"], b["ms_per_client_step"]],
            "accuracy": [a["accuracy"], b["accuracy"]]}


def paper_determinism(torch, np, pe, dev="cuda"):
    """The same run twice under the default cuDNN flags, then twice under
    cudnn.deterministic = True with benchmark = False (the flags restored
    after): whether keep-maps and params repeat bitwise, and the ms of a
    client SGD step under each. The deterministic pair must repeat bitwise
    (it did on the H100; the default pair parts in round 2)."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    out = {"default_flags": {"deterministic": saved[0], "benchmark": saved[1]}}
    out["default"] = repeat_of(np, determinism_run(torch, pe, dev),
                               determinism_run(torch, pe, dev))
    try:
        cudnn.deterministic, cudnn.benchmark = True, False
        out["deterministic"] = repeat_of(np, determinism_run(torch, pe, dev),
                                         determinism_run(torch, pe, dev))
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    check((cudnn.deterministic, cudnn.benchmark) == saved, "paper: cuDNN flags not restored")
    det = out["deterministic"]
    check(det["params_bitwise"] and all(det["keep_maps_equal_by_round"]),
          f"paper: the deterministic cuDNN runs did not repeat bitwise: {det}")
    return out


def paper_drivers(torch, np, pe, dev="cuda"):
    """The seven drivers: Table 2, Fig 4a, Fig 4b and Table 3 at the
    paper's scale (5 clients, n_data 2000), Fig 6, Fig 5 and the
    one-shot-pruning probe at the validation pass's sizes; each gated by
    the reference's own claims or identities."""
    out = {}
    built = []
    undo = recording_sims(pe, built)
    try:
        t0 = time.perf_counter()
        t2 = pe.table2_accuracy(n_data=PAPER_COHORT["n_data"], device=dev, **PAPER_TABLE2)
        accs = hold_sims(torch, "table2", built)
        check(len(accs) == len(built) == 3 * len(PAPER_TABLE2["rates"]) * len(PAPER_TABLE2["seeds"]),
              "paper: table2: a run did not evaluate")
        by_rate = {}
        for r in PAPER_TABLE2["rates"]:
            mean = {m: t2[(m, r)][0] for m in pe.METHODS}
            by_rate[str(r)] = {
                **{m: {"mean": t2[(m, r)][0], "std": t2[(m, r)][1]} for m in pe.METHODS},
                "invariant_ge_ordered_ge_random":
                    mean["invariant"] >= mean["ordered"] >= mean["random"]}
        out["table2"] = {"s": time.perf_counter() - t0, "seeds": list(PAPER_TABLE2["seeds"]),
                         "rounds": PAPER_TABLE2["rounds"], **PAPER_COHORT, "by_rate": by_rate,
                         "per_run_accuracy": accs}
        built.clear()

        t0 = time.perf_counter()
        f4a = pe.fig4a_straggler_time(rounds=PAPER_FIG4["fig4a"], device=dev, **PAPER_COHORT)
        hold_sims(torch, "fig4a", built, accuracy=False)
        check(f4a["within_10pct"], f"paper: fig4a: straggler time not within 10% of T_target {f4a}")
        out["fig4a"] = {"s": time.perf_counter() - t0, "rounds": PAPER_FIG4["fig4a"], **f4a}
        built.clear()

        t0 = time.perf_counter()
        f4b = pe.fig4b_dynamic_stragglers(rounds=PAPER_FIG4["fig4b"], device=dev, **PAPER_COHORT)
        hold_sims(torch, "fig4b", built, accuracy=False)
        check(f4b["t_fluid"] < f4b["t_static_straggler"] and f4b["t_fluid"] < f4b["t_baseline"],
              f"paper: fig4b: FLuID not faster than the static and baseline runs {f4b}")
        _, static, fluid = built
        switch = PAPER_FIG4["fig4b"] // 2
        stragglers = {arm: [h.stragglers for h in sim.server.history[switch + 1:]]
                      for arm, sim in (("static", static), ("fluid", fluid))}
        check(all(s == [0] for s in stragglers["static"]),
              f"paper: fig4b: the static arm left client 0: {stragglers['static']}")
        check(stragglers["fluid"][-1] == [3], f"paper: fig4b: FLuID did not move to client 3: "
              f"{stragglers['fluid']}")
        out["fig4b"] = {"s": time.perf_counter() - t0, "rounds": PAPER_FIG4["fig4b"], **f4b,
                        "stragglers_after_switch": stragglers}
        built.clear()

        t0 = time.perf_counter()
        t3 = pe.table3_threshold(rounds=PAPER_TABLE3["rounds"], device=dev,
                                 thresholds=PAPER_TABLE3["thresholds"], **PAPER_COHORT)
        hold_sims(torch, "table3", built, accuracy=False)
        fr = [t3[th] for th in PAPER_TABLE3["thresholds"]]
        check(all(a <= b for a, b in zip(fr, fr[1:])), f"paper: table3: fractions fall {t3}")
        out["table3"] = {"s": time.perf_counter() - t0, "rounds": PAPER_TABLE3["rounds"],
                         "fractions": {str(th): v for th, v in t3.items()}}
        built.clear()

        t0 = time.perf_counter()
        f6 = pe.fig6_invariant_evolution(device=dev, **PAPER_SMALL["fig6"])
        hold_sims(torch, "fig6", built, accuracy=False)
        check(all(0.0 <= f <= 1.0 for f in f6["invariant_frac_by_round"]),
              f"paper: fig6: a fraction outside [0, 1] {f6}")
        out["fig6"] = {"s": time.perf_counter() - t0, **PAPER_SMALL["fig6"], **f6}
        built.clear()

        t0 = time.perf_counter()
        f5 = pe.fig5_scalability(device=dev, **PAPER_SMALL["fig5"])
        hold_sims(torch, "fig5", built)
        out["fig5"] = {"s": time.perf_counter() - t0, **PAPER_SMALL["fig5"], **f5}
        built.clear()

        t0 = time.perf_counter()
        ins = pe.insight_oneshot_pruning(device=dev, **PAPER_SMALL["insight"])
        hold_sims(torch, "insight", built, accuracy=False)
        check(ins["full"] > FEMNIST_CHANCE,
              f"paper: insight: the full model's accuracy {ins['full']} not above chance")
        out["insight"] = {"s": time.perf_counter() - t0, **ins}
        built.clear()
    finally:
        undo()
    return out


def phase_paper(torch, np, dev="cuda"):
    """The five example twins and the paper's seven experiment drivers on
    the card, then cuDNN's determinism on Table 2's run. Only the serve
    twin reaches a hand-written kernel (B1 and B11, each launch held; its
    counts on this line); the twins' and drivers' FL runs launch none."""
    from repro_torch.kernels import ops
    smi = nvidia_smi()
    out = {"card": smi, "twins": paper_twins(torch, np, dev)}
    pe = load_file("paper_experiments_torch", "scripts/paper_experiments_torch.py")
    ops.reset_launch_counts()
    out["drivers"] = paper_drivers(torch, np, pe, dev)
    t0 = time.perf_counter()
    out["cudnn_determinism"] = paper_determinism(torch, np, pe, dev)
    out["cudnn_determinism"]["s"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(set(counts.values()) == {0}, f"paper: the drivers launched a kernel: {counts}")
    out["launches"] = out["twins"]["serve_example"]["launches"]
    return out


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
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
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
        kernels = (phase_kernels(torch, np) + phase_train_kernels(torch, np)
                   + phase_attn_kernels(torch, np) + phase_rwkv_kernels(torch, np))
        zoo = phase_zoo_kernels(torch, np)
        for kern in kernels:
            if kern["name"] in zoo:
                kern["zoo"] = zoo[kern["name"]]
        stats_launches = next(k["launches"] for k in kernels if k["name"] == "invariant_stats")
        emit("kernels", kernels=kernels)
        emit("small", **phase_small(torch, np))
        serve, counts, params, cfg = phase_serve(torch, np)
        emit("serve", **serve)
        step, state = phase_step(torch, np, params, cfg)
        emit("step", **step)
        emit("decode_routes", **phase_decode_routes(torch, np, params, cfg, state))
        emit("profile", **phase_profile(torch, params, cfg, state))
        regions = {}                           # host-sync regions, for the analysis line
        sync_decode(torch, np, params, cfg, regions)
        del params, state
        torch.cuda.empty_cache()
        serve_rwkv, rwkv_counts = phase_serve_rwkv(torch, np)
        emit("serve_rwkv", **serve_rwkv)
        torch.cuda.empty_cache()
        # the zoo's other mixers at full width, one model on the card at a time
        serving = {"serve": counts}
        for phase, arch, queue in (("serve_mla", "minicpm3-4b", SERVE_QUEUE),
                                   ("serve_griffin", "recurrentgemma-9b", RWKV_QUEUE)):
            line, serving[phase] = phase_serve_zoo(torch, np, arch, queue)
            emit(phase, **line)
            gc.collect()
            torch.cuda.empty_cache()
        granite, serving["granite"] = phase_granite(torch, np)
        emit("granite", **granite)
        gc.collect()
        torch.cuda.empty_cache()
        line, serving["serve_cmdr"] = phase_serve_zoo(torch, np, "command-r-35b", SERVE_QUEUE)
        emit("serve_cmdr", **line)
        gc.collect()
        torch.cuda.empty_cache()
        # the MoE models and the encoder-decoder on serve()'s static batch
        line, _ = phase_serve_moe(torch, np)
        emit("serve_moe", **line)
        gc.collect()
        torch.cuda.empty_cache()
        for phase, cfg in (("serve_arctic", get_config("arctic-480b").with_overrides(
                               n_layers=ARCTIC_LAYERS)),
                           ("serve_seamless", get_config("seamless-m4t-large-v2"))):
            line, serving[phase] = phase_serve_static(torch, np, cfg, phase)
            emit(phase, **line)
            gc.collect()
            torch.cuda.empty_cache()
        # the zoo train step at StableLM-2-12B's width, every serving model freed
        line, zoo_counts = phase_train_zoo(torch, np, regions=regions)
        emit("train_zoo", **line)
        gc.collect()
        torch.cuda.empty_cache()
        emit("dryrun", **phase_dryrun(torch, np, line))
        emit("adamw", **phase_adamw(torch, np))
        emit("train_rwkv", **phase_train_rwkv(torch, np))
        gc.collect()
        torch.cuda.empty_cache()
        train, train_counts, train_runs = phase_train(torch, np)
        emit("train", **train)
        train_attn, attn_counts, attn_runs = phase_train_attn(torch, np)
        emit("train_attn", **train_attn)
        # the paper's workloads and the dense fleet reach no hand-written
        # kernel, as in the reference
        ops.reset_launch_counts()
        paper = phase_train_paper(torch, np)
        check(set(ops.launch_counts().values()) == {0},
              f"train_paper launched a kernel: {ops.launch_counts()}")
        emit("train_paper", **paper, launches=ops.launch_counts())
        dense = phase_train_dense(torch, np, {"femnist_kernel": train_runs,
                                              "femnist_attn": attn_runs})
        check(set(ops.launch_counts().values()) == {0},
              f"train_dense launched a kernel: {ops.launch_counts()}")
        emit("train_dense", **dense, launches=ops.launch_counts())
        del train_runs, attn_runs
        torch.cuda.empty_cache()
        # the population and async layer: their launch counts stay on their
        # own lines
        emit("population", **phase_population(torch, np))
        torch.cuda.empty_cache()
        emit("async", **phase_async(torch, np))
        torch.cuda.empty_cache()
        # repro_torch.analysis on the card: its launches stay on its own line
        emit("analysis", **phase_analysis(torch, np, regions))
        # the example twins and the paper's drivers: their launches (the
        # serve twin's) stay on their own line
        torch.cuda.empty_cache()
        emit("paper", **phase_paper(torch, np))
        # launches: serving's kernels summed over the serve phases (StableLM,
        # MiniCPM3, RecurrentGemma, Command-R, Arctic, SeamlessM4T; DeepSeek's
        # launches none) and Granite's step, the chunked
        # scan's from serve_rwkv (its bf16 form's from serve_rwkv's bf16 prefill), the FFN training kernels' from train and
        # train_zoo, the head-masked kernels' from train_attn; invariant_stats
        # is on no main path, so its count is that of its checks in the
        # kernels phase
        train_paths = {"train": train_counts, "train_zoo": zoo_counts}
        launches = {**{k: sum(c[k] for c in serving.values()) for k in SERVE_KERNELS},
                    **rwkv_counts,
                    **{k: train_counts[k] + zoo_counts[k] for k in TRAIN_KERNELS},
                    **{k: attn_counts[k] for k in ATTN_KERNELS},
                    "invariant_stats": stats_launches}
        check(set(launches) == {k["name"] for k in kernels},
              "the kernels phase and the main paths cover different kernels")
    except SmokeFailure as e:
        emit("failed", error=str(e))
        return 1
    by_path = {k: {p: c[k] for p, c in paths.items()}
               for paths, names in ((serving, SERVE_KERNELS), (train_paths, TRAIN_KERNELS))
               for k in names}
    emit("total", seconds=time.perf_counter() - t_start)
    summary = [{k: v for k, v in kern.items()
                if k not in ("mixes", "shape", "lengths", "rel_err", "library_call",
                             "block_mask_entry", "zoo")}
               | {"launches": launches[kern["name"]]}
               | ({"launches_by_path": by_path[kern["name"]]} if kern["name"] in by_path else {})
               for kern in kernels]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
