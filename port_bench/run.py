"""Runs one cell of the port's benchmark once:

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Makes the weights and inputs from the seed, warms up the cell's own shapes,
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints one JSON line: the end-to-end metrics (trace 0)
or the per-layer metrics read from torch.profiler (trace 1). Exits with a
code other than 0, printing no result, without enough CUDA devices, or if a
module of JAX or of the JAX package was loaded.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PB = Path(__file__).resolve().parent
sys.path[:0] = [str(PB), str(PB.parent / "src")]

from harness import cell  # noqa: E402


def _process_start_epoch():
    """When this process started, by the kernel's record; else the first
    line of this file."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        btime = next(int(x.split()[1]) for x in Path("/proc/stat").read_text().splitlines()
                     if x.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time() - (time.perf_counter() - _T0)


START = _process_start_epoch()


def seconds_since_start(t_perf: float) -> float:
    """Seconds from the process's start to perf_counter time t_perf."""
    return time.time() - (time.perf_counter() - t_perf) - START


def card():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = cell.benchmark()
    w, c, t = cell.resolve(bench, a.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    driver = importlib.import_module(f"drivers.{t['driver']}")
    run = driver.run(w, c, t, a.seed, a.seconds, bool(a.trace), seconds_since_start)
    run.device_name, run.card = torch.cuda.get_device_name(0), card()
    line = assemble(bench, w, run, bool(a.trace))
    bad = cell.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for name, value, limit in run.rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


def assemble(bench, w, run, trace):
    metrics = {}
    for m in cell.metrics_for(bench, w["name"], trace):
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.device_name, "count": w["chips"],
              "memory_peak_bytes": run.peak_bytes}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device, "card": run.card}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.rows}
    return line


if __name__ == "__main__":
    sys.exit(main())
