"""Reads the numbers that a training cell's limits are set from, on the
card, for the drivers that define ``reading`` (``train_moe_step``):

    python3 port_bench/train_readings.py --workload <name> --seeds 1,2,3 \\
        --sides program,control --out <file.jsonl>

One JSON line a (side, seed), each with every number ``correct`` compares.
Sides: ``program`` (the program's set-up and checked steps against the
reference) and the driver's ``SIDES``: the reference in fp8 (``control``)
or with a planted fault, put in the program's place. The benchmark's own
runs do not run this.
"""
import argparse
import importlib
import json
import sys
import time
from pathlib import Path

PB = Path(__file__).resolve().parent
sys.path[:0] = [str(PB), str(PB.parent / "src")]

import torch  # noqa: E402

from harness import cell  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program")
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    w, c, t = cell.resolve(cell.benchmark(), a.workload)
    driver = importlib.import_module(f"drivers.{t['driver']}")
    device = torch.device("cuda")
    for seed in [int(s) for s in a.seeds.split(",")]:
        for side in a.sides.split(","):
            t0 = time.perf_counter()
            rec = driver.reading(c, t, seed, side, device)
            rec.update(workload=a.workload, seed=seed, side=side,
                       seconds=time.perf_counter() - t0)
            line = json.dumps(rec)
            print(line, flush=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
