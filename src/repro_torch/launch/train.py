"""Training driver (port of ``repro/launch/train.py``).

Two modes:
  * plain training of any registered arch on synthetic LM data
    (``--arch stablelm-12b --steps 50``);
  * **FLuID datacenter training** (``--fluid``): one client shard is an
    emulated straggler that trains the masked sub-model built from
    invariant FFN-unit statistics, re-derived every ``calibrate_every``
    steps (Algorithm 1 transplanted to the datacenter).

Runs on the card unless ``device="cpu"`` (``--device cpu``) is asked for,
the smoke config unless ``--full-config``, as the reference. The
reference's mesh has no counterpart yet (one device).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --fluid --steps 12
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import transformer_hooks as hooks
from repro_torch.core.straggler import pick_rate
from repro_torch.core.tree import tree_map
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as model_lib
from repro_torch.models import transformer
from repro_torch.models.layers import cdtype
from repro_torch.optim import make_optimizer

FFN_KEYS = ("w_in", "w_gate", "w_out")   # the leaves ffn_unit_stats reads
MOE_KEYS = ("w_in",)                     # ... of an MoE layer's experts


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} needs a CUDA device and none is "
                           f"available; pass device='cpu' to train on the CPU")
    return device


def synth_batch(rng, cfg, batch, seq, device="cuda"):
    """Synthetic LM data with learnable bigram structure: the reference's
    draws from ``rng`` (a numpy RandomState) in the reference's order, so
    the tokens are the reference's bit for bit."""
    v = min(cfg.vocab_size, 512)
    base = rng.randint(0, v, size=(batch, seq), dtype=np.int32)
    # locally predictable drift; int32, as jnp.asarray gives the reference
    tokens = (np.cumsum(base, axis=1) % v).astype(np.int32)
    out = {"tokens": torch.from_numpy(tokens[:, :-1].copy()).to(device),
           "targets": torch.from_numpy(tokens[:, 1:].copy()).to(device)}
    if cfg.is_encdec:
        frames = rng.randn(batch, seq - 1, cfg.d_model).astype(np.float32) * 0.1
        out["frames"] = torch.from_numpy(frames).to(device, cdtype(cfg))
    return out


def ffn_snapshot(params, cfg):
    """Clones of the FFN leaves ``hooks.ffn_unit_stats`` reads, in its
    params layout: a dense FFN's or channel mix's three matrices, an MoE
    layer's experts' w_in alone. The optimizer updates params in place, so
    the previous calibration's weights must be copied, not aliased."""
    out = {}
    for si, seg in enumerate(transformer.build_segments(cfg)):
        sp = params["stack"][f"seg{si}"]
        out[f"seg{si}"] = {
            f"l{i}": {key: {k: w.clone() for k, w in sp[f"l{i}"][key].items()
                            if k in (MOE_KEYS if key == "moe" else FFN_KEYS)}
                      for key in ("ffn", "cmix", "moe") if key in sp[f"l{i}"]}
            for i in range(len(seg.unit))}
    return {"stack": out}


def run_plain(cfg, steps, batch, seq, log_every=10, ckpt=None, device="cuda"):
    device = _device(device)
    params = model_lib.init_params(cfg, 0, device)
    opt = make_optimizer(cfg.optimizer)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg)
    rng = np.random.RandomState(0)
    losses = []
    for i in range(steps):
        b = synth_batch(rng, cfg, batch, seq + 1, device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d} loss {loss:.4f} "
                  f"({time.perf_counter() - t0:.2f}s)", flush=True)
    if ckpt:
        save_checkpoint(ckpt, {"params": params},
                        meta={"steps": steps, "final_loss": losses[-1]})
    return params, losses


def run_fluid(cfg, steps, batch, seq, rate=None, calibrate_every=5,
              straggler_slowdown=1.3, log_every=5, device="cuda"):
    """Datacenter FLuID: one client shard is slow; every calibration step
    the server re-derives its sub-model from the invariant unit statistics
    of the FFN weights against the previous calibration's. Returns (params,
    log of (loss, t_full, t_fluid) a step, in modelled time units)."""
    device = _device(device)
    params = model_lib.init_params(cfg, 0, device)
    opt = make_optimizer(cfg.optimizer)
    opt_state = opt.init(params)
    full_step = make_train_step(cfg)
    masked_step = make_train_step(cfg, with_masks=True)
    rng = np.random.RandomState(0)

    r = rate or pick_rate(straggler_slowdown)
    masks = None
    prev = ffn_snapshot(params, cfg)
    log = []
    for i in range(steps):
        b = synth_batch(rng, cfg, batch, seq + 1, device)
        if masks is None:
            params, opt_state, metrics = full_step(params, opt_state, b)
        else:
            params, opt_state, metrics = masked_step(params, opt_state, b, masks)
        if (i + 1) % calibrate_every == 0:
            stats = hooks.ffn_unit_stats(prev, params, cfg)
            # build_masks gives host tensors: one copy to the card a calibration
            masks = tree_map(lambda m: m.to(device), hooks.build_masks(stats, cfg, r))
            prev = ffn_snapshot(params, cfg)
        loss = float(metrics["loss"])
        t_full = 1.0 * straggler_slowdown          # modelled step time units
        t_fluid = 1.0 * straggler_slowdown * (r if masks is not None else 1)
        log.append((loss, t_full, t_fluid))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d} loss {loss:.4f} sub-model r={r} "
                  f"{'masked' if masks is not None else 'full'}", flush=True)
    return params, log


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-smoke) config")
    ap.add_argument("--fluid", action="store_true")
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke().with_overrides(grad_accum=1)
    if args.fluid:
        run_fluid(cfg, args.steps, args.batch, args.seq, rate=args.rate,
                  device=args.device)
    else:
        run_plain(cfg, args.steps, args.batch, args.seq, ckpt=args.ckpt,
                  device=args.device)


if __name__ == "__main__":
    main()
