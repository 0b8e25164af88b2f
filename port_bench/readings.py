"""Reads the numbers that a cell's limits are set from, on the card:

    python3 port_bench/readings.py --workload <name> --seeds 1,2,3 \\
        --sides program,control,half_batch --out <file.jsonl>

One JSON line a (side, seed), each with every number ``correct`` compares.
Sides of a training cell: ``program`` (the program's set-up and checked
steps against the reference), the controls put in the program's place
(``control``: the reference in fp8 throughout; ``control_ffn``: in fp8 in
the checked steps' FFN matmuls alone) and the faults planted in the fp32
reference put in the program's place (``half_batch``, ``unchanged``). A serving cell reads, for
each seed, one wave of the program and, on the same sample of requests,
the control (the token fp8 puts first at each position) and a served token
altered where it is produced (each request's last token moved by one).
The benchmark's own runs do not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

PB = Path(__file__).resolve().parent
sys.path[:0] = [str(PB), str(PB.parent / "src")]

import torch  # noqa: E402

from drivers import common, serve_engine, train_step  # noqa: E402
from harness import cell, traffic as gen  # noqa: E402


SIDES = {"control": dict(precision="fp8"),
         "control_ffn": dict(masked_precision="fp8_ffn"),
         "half_batch": dict(fault="half_batch"), "unchanged": dict(fault="unchanged")}


def train_reading(c, t, seed, side_name, device):
    if side_name == "program":
        side = train_step.ProgramSide(c, t, seed, device)
    else:
        side = train_step.ReferenceSide(c, t, seed, device, **SIDES[side_name])
    prog = train_step.drive(side, gen.TrainFeed(t, seed, device), t)
    side.free()
    ref = train_step.ReferenceSide(c, t, seed, device)
    r = train_step.drive(ref, gen.TrainFeed(t, seed, device), t)
    ref.free()
    nums = train_step.numbers(t, prog, r)
    pc, rc = prog["checked"], r["checked"]
    keeps = (prog["keep"], r["keep"])

    def pairs(a, b):
        (aw, al), (bw, bl) = train_step.split_norms(a), train_step.split_norms(b)
        if al:
            al, bl = train_step.common_block_norms(al, bl, *keeps)
        return {p: [aw.get(p, al.get(p)), bw.get(p, bl.get(p))] for p in (*bw, *bl)}
    return dict(nums, leaves={"first_grad": pairs(prog["first_grad"], r["first_grad"]),
                              "grad": pairs(pc["grad"], rc["grad"]),
                              "change": pairs(pc["change"], rc["change"])},
                **train_step.details(prog, r))


def serve_reading(c, t, seed, device):
    engine, clients, masks = serve_engine.build(c, t, seed, device)
    finished = serve_engine.send_wave(engine, c, t, seed, 0, masks)
    engine.params = engine.caches = engine.bank = engine = None
    common.free()
    good = serve_engine.answered(c, finished)
    picked = gen.sample(seed, good, t["check_requests"])
    keeps = {k: keep for k, _, keep in clients}
    ref = serve_engine.reference_logits(c, seed, picked, keeps, device)
    served = serve_engine.served_tokens(picked, device)
    ctrl = serve_engine.reference_logits(c, seed, picked, keeps, device, precision="fp8")
    ends = torch.tensor([len(f["out"]) for f in picked]).cumsum(0) - 1
    altered = served.clone()
    altered[ends.to(device)] = (altered[ends.to(device)] + 1) % c["vocab_size"]
    return {"unanswered": len(finished) - len(good),
            "logit_gap": serve_engine.token_gap(ref, served),
            "control_gap": serve_engine.token_gap(ref, ctrl.argmax(-1)),
            "token_fault_gap": serve_engine.token_gap(ref, altered),
            "served_tokens": int(served.numel())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program")
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    w, c, t = cell.resolve(cell.benchmark(), a.workload)
    device = torch.device("cuda")
    for seed in [int(s) for s in a.seeds.split(",")]:
        for side in a.sides.split(","):
            t0 = time.perf_counter()
            if t["driver"] == "train_step":
                rec = train_reading(c, t, seed, side, device)
            else:
                rec = serve_reading(c, t, seed, device)
            rec.update(workload=a.workload, seed=seed, side=side,
                       seconds=time.perf_counter() - t0)
            line = json.dumps(rec)
            print(line, flush=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
