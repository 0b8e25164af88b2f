"""Reads the program's own spans (``repro_torch.tracing``) on the card, in a
run of a cell as the benchmark makes it:

    python3 port_bench/spans.py --workload <name> --seed <n> --seconds <s> \\
        --mode traced|recorder|setup|setup_profiled [--out <file.jsonl>]

``traced``: the benchmark's traced run (``run.py --trace 1``) with the
program's recorder on over the window. Prints the run's per-layer metrics
and breakdown as ``run.py`` does, with its idle gaps named by program span,
the span metrics of ``harness/attribution.READERS``, and where the time
goes: device time charged to each program span, a train step's phases
against its busy time, a decode step's issue, sync and retire against
``decode_step_ms``, and each request's queue wait, time to first token and
latency.

``recorder``: the benchmark's untraced run (``--trace 0``) with the
recorder on over the window and the profiler off: its end-to-end metrics,
to hold against ``run.py --trace 0`` on the same seed for the recorder's
cost.

``setup``: the untraced run with the recorder on from the start: the
set-up's spans on the host clock. ``setup_profiled``: the same, with a
training cell's first full step under the profiler (CUDA activity): its
device time by phase, and the seconds the profiler took to start and stop
around it.

One JSON line a run, on standard output and appended to ``--out``. The
benchmark's own runs do not run this.
"""
import argparse
import importlib
import json
import statistics
import sys
import time
from pathlib import Path

PB = Path(__file__).resolve().parent
sys.path[:0] = [str(PB), str(PB.parent / "src")]

import run as bench  # noqa: E402  (the benchmark's entry point, port_bench/run.py)
from drivers import common  # noqa: E402
from harness import attribution, cell  # noqa: E402
from harness.trace import Trace, gaps  # noqa: E402
from repro_torch import tracing  # noqa: E402


class Recording:
    """What a run's recorder kept: ``before`` the window (set-up, when the
    recorder is on from the start), ``window`` inside it."""

    def __init__(self, from_start: bool):
        self.from_start, self.before, self.window = from_start, [], []

    def set_aside(self):
        self.before += tracing.drain()


class ProgramWindow(common.Window):
    """The benchmark's window with the program's recorder on inside it."""

    def __init__(self, trace, rec):
        super().__init__(trace)
        self.rec = rec

    def __enter__(self):
        if self.rec.from_start:
            self.rec.set_aside()
        else:
            tracing.drain()
        tracing.enable()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        tracing.disable()
        self.rec.window = tracing.drain()
        return False

    def read_trace(self):
        if self.prof is None:
            return None
        return attribution.AttributedTrace.from_profiler(self.prof, self.span.kept,
                                                         self.rec.window)


def _dist_ms(values):
    if not values:
        return None
    v = sorted(1e3 * x for x in values)
    q = statistics.quantiles(v, n=10) if len(v) > 1 else [v[0]] * 9
    return {"n": len(v), "median": statistics.median(v), "p90": q[8], "max": v[-1]}


def train_split(tr):
    """A step's device time by program span, against its busy time."""
    steps = tr.count("train.step")
    if not steps:
        return None
    by = {str(k): 1e3 * v / steps for k, v in tr.busy_by_span().items()}
    three = sum(by.get(p, 0.0) for p in ("train.forward", "train.backward",
                                         "train.optimizer"))
    busy = 1e3 * tr.busy_s() / steps
    return {"steps": steps, "busy_ms": busy, "by_span_ms": by, "three_ms": three,
            "three_over_busy": three / busy if busy else None,
            "outside_ms": by.get("None", 0.0),
            "host_ms": {p: 1e3 * tr.span_seconds(p) / steps for p in
                        ("train.step", "train.forward", "train.backward", "train.optimizer")}}


def idle_named(tr):
    """The idle gaps by program span, all of them; and those under the
    benchmark's ``decode_chunk`` with no host operation (the ledger's
    largest bucket), with the share of them a program span names."""
    bench_only = Trace([], {k: v for k, v in tr.spans.items()
                            if not k.startswith(("serve.", "train."))}, [])
    total = named = 0.0
    by = {}
    for a, b in gaps([(s, e) for _, s, e in tr.device], tr.lo, tr.hi):
        mid = 0.5 * (a + b)
        host, prog = tr._host_at(mid)[:100], tr._span_at(mid)
        by[f"{prog} / {host}"] = by.get(f"{prog} / {host}", 0.0) + b - a
        if bench_only._span_at(mid) == "decode_chunk" and host == "no host operation":
            total += b - a
            named += (b - a) if prog.startswith("serve.") else 0.0
    return {"decode_chunk_no_host_s": total, "named_by_program_s": named,
            "share": named / total if total else None,
            "idle_by_span": sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])}


def serve_split(run):
    tr, steps = run.trace, run.stats["decode_steps"]
    if not steps:
        return None
    ms = {p: 1e3 * tr.span_seconds(f"serve.{p}") / steps
          for p in ("chunk_issue", "chunk_sync", "retire", "decode_chunk", "admit",
                    "prefill", "bank_row", "insert")}
    step_ms = 1e3 * run.stats["decode_s"] / steps
    reqs = tr.requests().values()
    return {"decode_steps": steps, "decode_step_ms": step_ms, "per_step_ms": ms,
            "issue_sync_retire_over_step": (ms["chunk_issue"] + ms["chunk_sync"]
                                            + ms["retire"]) / step_ms,
            "busy_by_span_s": {str(k): v for k, v in tr.busy_by_span().items()},
            "requests": {
                "queued": _dist_ms([r["queued"][1] - r["queued"][0] for r in reqs
                                    if "queued" in r]),
                "ttft": _dist_ms([r["prefill"][1] - r["request"][0] for r in reqs
                                  if "prefill" in r]),
                "latency": _dist_ms([r["request"][1] - r["request"][0] for r in reqs])},
            "idle": idle_named(tr)}


def by_name_s(spans):
    out = {}
    for p in spans:
        n, s = out.get(p.name, (0, 0.0))
        out[p.name] = (n + 1, s + (p.end - p.start) * 1e-9)
    return {k: {"n": n, "s": s} for k, (n, s) in out.items()}


def profile_first_full_step(rec, report, side_cls):
    """Wraps ``side_cls.full_step`` so that its first call runs under the
    profiler (CUDA activity); puts that step's device time by phase, and
    the seconds the profiler took to start and to stop, in ``report``.
    Returns what undoes the wrap."""
    full = side_cls.full_step

    def first(self, b):
        if "first_step" in report:
            return full(self, b)
        import torch
        from torch.profiler import ProfilerActivity, profile
        common.sync()
        rec.set_aside()
        prof = profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                                   else ProfilerActivity.CPU])
        c0 = time.perf_counter()
        with prof:
            c1 = time.perf_counter()
            t0 = time.time_ns()
            loss = full(self, b)
            t1 = time.time_ns()
            c2 = time.perf_counter()
        c3 = time.perf_counter()
        program = tracing.drain()
        rec.before += program
        tr = attribution.AttributedTrace.from_profiler(
            prof, [("window", t0 * 1e-9, t1 * 1e-9)], program)
        report["first_step"] = dict(split=train_split(tr), wall_s=(t1 - t0) * 1e-9,
                                    profiler_start_s=c1 - c0, profiler_stop_s=c3 - c2,
                                    unlinked=tr.unlinked, ops=len(tr.device))
        return loss
    side_cls.full_step = first
    return lambda: setattr(side_cls, "full_step", full)


def measure(w, c, t, seed, seconds, mode, device="cuda"):
    """One run of the cell in ``mode``; its JSON line (a dict)."""
    import torch
    rec, report, undo = Recording(mode.startswith("setup")), {}, []
    window = common.Window
    common.Window = lambda trace: ProgramWindow(trace, rec)
    driver = importlib.import_module(f"drivers.{t['driver']}")
    try:
        if mode.startswith("setup"):
            tracing.enable()
            if mode == "setup_profiled" and t["driver"] == "train_step":
                undo.append(profile_first_full_step(rec, report, driver.ProgramSide))
        trace = mode == "traced"
        run = driver.run(w, c, t, seed, seconds, trace, bench.seconds_since_start,
                         device=device)
    finally:
        common.Window = window
        tracing.disable()
        tracing.drain()
        for u in undo:
            u()
    run.device_name = torch.cuda.get_device_name(0) if device == "cuda" else device
    run.card = bench.card() if device == "cuda" else None
    line = bench.assemble(cell.benchmark(), w, run, trace)
    line.update(workload=w["name"], seed=seed, mode=mode,
                window_spans=by_name_s(rec.window))
    if trace:
        tr = run.trace
        line["span_metrics"] = {n: r(run) for n, r in attribution.READERS.items()}
        line["unlinked_ops"], line["device_ops"] = tr.unlinked, len(tr.device)
        line["where"] = train_split(tr) if run.kind == "train" else serve_split(run)
    if mode.startswith("setup"):
        line["setup_spans"] = by_name_s(rec.before)
        line["setup_steps"] = [
            {"host_ms": 1e3 * (p.end - p.start) * 1e-9,
             "phases_ms": {q.name: 1e3 * (q.end - q.start) * 1e-9
                           for q in rec.before if q.parent == p.id}}
            for p in rec.before if p.name == "train.step"]
        line.update(report)
    return line


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", required=True,
                    choices=("traced", "recorder", "setup", "setup_profiled"))
    ap.add_argument("--out")
    a = ap.parse_args()
    w, c, t = cell.resolve(cell.benchmark(), a.workload)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    line = measure(w, c, t, a.seed, a.seconds, a.mode)
    bad = cell.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    text = json.dumps(line)
    print(text, flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
