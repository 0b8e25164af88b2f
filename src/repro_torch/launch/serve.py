"""Serving driver (port of ``repro/launch/serve.py``). Default path: a
queue of requests with cycling dropout rates and ragged prompt/gen lengths
(prompts of exactly ``--prompt-len`` tokens for a recurrent model) through
one ``ServeEngine``. ``--baseline`` runs the reference's synchronous path,
``serve``: one batch in lockstep, a prefill and then one greedy token a
step. MoE and encoder–decoder models take only that path, as in the
reference.

    python -m repro_torch.launch.serve                  # smoke config, on the card
    python -m repro_torch.launch.serve --full-config    # StableLM-2-12B, bf16 weights
    python -m repro_torch.launch.serve --device cpu     # smoke config on the CPU
    python -m repro_torch.launch.serve --arch rwkv6-3b --full-config   # RWKV-6-3B
    python -m repro_torch.launch.serve --arch minicpm3-4b --full-config --mla-absorb
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --full-config
    python -m repro_torch.launch.serve --arch command-r-35b --full-config
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --full-config --baseline
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --full-config --baseline
    python -m repro_torch.launch.serve --arch arctic-480b --baseline --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.serving import ServeEngine, ServeRequest, rate_masks
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model as model_lib
from repro_torch.models.layers import cdtype


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, batch=2, prompt_len=16, gen_len=16, mla_absorb=False, seed=0,
          greedy=True, device="cuda", params=None):
    """The reference's static batch: ``batch`` prompts of prompt_len tokens
    drawn from ``np.random.RandomState(seed)`` (below min(vocab, 256)), and
    for an encoder–decoder frames of randn · 0.1 (batch, prompt_len, d) in
    the compute dtype; a prefill into caches of prompt_len + gen_len
    positions, then gen_len greedy decode steps. Returns (generated tokens
    (batch, gen_len), {'prefill_s', 'decode_s', 'tok_per_s'}). ``params``
    defaults to ``init_params(cfg, seed, device, dtype=cfg.dtype)``.
    ``device`` defaults to "cuda" and raises without a card."""
    if not greedy:
        raise NotImplementedError("serve decodes greedily, as the reference does")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve(device='cuda') needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    if params is None:
        params = model_lib.init_params(cfg, seed, device, dtype=cdtype(cfg))
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, min(cfg.vocab_size, 256), (batch, prompt_len), dtype=np.int32)
    batch_in = {"tokens": torch.from_numpy(toks).to(device)}
    if cfg.is_encdec:
        frames = rng.randn(batch, prompt_len, cfg.d_model).astype(np.float32) * 0.1
        batch_in["frames"] = torch.from_numpy(frames).to(device, cdtype(cfg))
    prefill = make_prefill_step(cfg, cache_len=prompt_len + gen_len)
    step = make_serve_step(cfg, mla_absorb=mla_absorb)

    t0 = time.perf_counter()
    logits, caches = prefill(params, batch_in)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = torch.argmax(logits, -1)[:, None]
    t0 = time.perf_counter()
    for t in range(gen_len):
        pos = torch.full((batch,), prompt_len + t, dtype=torch.int64, device=device)
        logits, caches = step(params, caches, tok, pos)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok[:, 0].cpu().numpy())
    t_decode = time.perf_counter() - t0
    gen = np.stack(out, 1).astype(np.int32)
    return gen, {"prefill_s": t_prefill, "decode_s": t_decode,
                 "tok_per_s": batch * gen_len / max(t_decode, 1e-9)}


def serve_engine(cfg, batch=4, prompt_len=16, gen_len=16, n_requests=None,
                 rates=(1.0, 0.5), mla_absorb=False, seed=0, device="cuda",
                 params=None):
    """Queue n_requests with cycling dropout rates (ordered masks) and
    ragged prompt/gen lengths drawn from ``np.random.RandomState(seed)``
    (prompts of exactly prompt_len for a recurrent model) through one
    ServeEngine; returns (results, summary). ``params``
    defaults to ``init_params(cfg, seed, device, dtype=cfg.dtype)``."""
    if params is None:
        params = model_lib.init_params(cfg, seed, device, dtype=cdtype(cfg))
    eng = ServeEngine(cfg, params, batch_size=batch,
                      max_prompt_len=prompt_len, max_gen_len=gen_len,
                      mla_absorb=mla_absorb, device=device)
    rng = np.random.RandomState(seed)
    mask_of = {r: (None if r >= 1.0 else rate_masks(cfg, r, seed=seed))
               for r in rates}
    n_requests = n_requests or 2 * batch
    for i in range(n_requests):
        L = prompt_len if eng.recurrent else int(
            rng.randint(max(1, prompt_len // 2), prompt_len + 1))
        toks = rng.randint(0, min(cfg.vocab_size, 256), (L,), dtype=np.int32)
        g = int(rng.randint(max(1, gen_len // 2), gen_len + 1))
        eng.submit(ServeRequest(toks, gen_len=g,
                                masks=mask_of[rates[i % len(rates)]]))
    results = eng.run()
    return results, eng.summary()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--n-requests", type=int, default=None)
    ap.add_argument("--rates", default="1.0,0.5",
                    help="comma-separated sub-model sizes cycled across "
                    "requests (1.0 = full model)")
    ap.add_argument("--baseline", action="store_true",
                    help="synchronous static-batch decode (no engine)")
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke()
    if args.baseline:
        gen, stats = serve(cfg, args.batch, args.prompt_len, args.gen_len,
                           mla_absorb=args.mla_absorb, device=args.device)
        print("generated tokens:\n", gen)
        print({k: round(v, 3) for k, v in stats.items()})
        return
    rates = tuple(float(r) for r in args.rates.split(","))
    results, summary = serve_engine(
        cfg, args.batch, args.prompt_len, args.gen_len,
        n_requests=args.n_requests, rates=rates, mla_absorb=args.mla_absorb,
        device=args.device)
    for rid in sorted(results):
        print(f"request {rid}: {results[rid].tolist()}")
    print({k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in summary.items()})


if __name__ == "__main__":
    main()
