#!/usr/bin/env python3
"""Paper-validation pass on the PyTorch port -> build/paper_validation_torch.json
(incremental; twin of experiments/run_paper_validation.py).

Reproduces the claims of: Table 2 (accuracy: Random/Ordered/Invariant x
r), Fig 4a (straggler time), Fig 4b (dynamic stragglers), Fig 5
(scalability), Fig 6 (invariant evolution), Table 3 (threshold sweep), in
the reference's sequence and at its sizes; ``--full`` for the bigger pass.
Results are flushed after every experiment, beside torch's version and the
card's name and power limit as nvidia-smi reports them.

    python3 scripts/run_paper_validation_torch.py                 # on the card
    python3 scripts/run_paper_validation_torch.py --device cpu --out build/pv_cpu.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import torch  # noqa: E402

import paper_experiments_torch as pe  # noqa: E402

OUT = "build/paper_validation_torch.json"


def card():
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return smi.stdout.strip() or None


def run(device="cuda", full=False, out=OUT):
    """The validation pass; returns the results dict it wrote to ``out``."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} needs a CUDA device and none is "
                           f"available; pass --device cpu")
    results = {"device": device, "torch": torch.__version__,
               "card": card() if torch.device(device).type == "cuda" else None}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    t0 = time.perf_counter()

    def flush(name, value):
        results[name] = value
        results["wall_s"] = round(time.perf_counter() - t0, 1)
        with open(out, "w") as f:
            json.dump(results, f, indent=2, default=str)
        print(name, "done", results["wall_s"], flush=True)

    flush("fig6_invariant_evolution",
          pe.fig6_invariant_evolution(rounds=20, n_data=800, device=device))
    flush("fig4a_straggler_time",
          pe.fig4a_straggler_time(rounds=10, n_data=600, device=device))
    flush("fig4b_dynamic",
          pe.fig4b_dynamic_stragglers(rounds=16, n_data=500, device=device))
    flush("table3_threshold",
          pe.table3_threshold(rounds=6, n_data=600,
                              thresholds=(0.002, 0.005, 0.01, 0.02, 0.05),
                              device=device))

    rates = (0.95, 0.75, 0.5) if full else (0.75, 0.5)
    t2 = {f"{m}@r{r}": v for (m, r), v in pe.table2_accuracy(
        rates=rates, rounds=30 if full else 20,
        n_data=1500 if full else 1000,
        seeds=(0, 1) if full else (0,), device=device).items()}
    flush("table2_accuracy_femnist", t2)

    flush("fig5_scalability",
          pe.fig5_scalability(n_clients=16 if full else 10,
                              rounds=15 if full else 10,
                              n_data=2000 if full else 1200, device=device))

    t2s = {f"{m}@r{r}": v for (m, r), v in pe.table2_accuracy(
        workload="shakespeare", rates=(0.75,), rounds=15, n_data=1000,
        seeds=(0,), device=device).items()}
    flush("table2_accuracy_shakespeare", t2s)
    print("written", out)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="The paper-validation pass on the PyTorch port")
    ap.add_argument("--full", action="store_true", help="the bigger pass")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--out", default=OUT, help=f"results file (default {OUT})")
    args = ap.parse_args(argv)
    return run(device=args.device, full=args.full, out=args.out)


if __name__ == "__main__":
    main()
