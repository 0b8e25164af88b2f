"""Async buffered FL launcher (port of ``repro/launch/async_fl.py``):
``python -m repro_torch.launch.async_fl``.

Builds a ``PopulationConfig`` + ``AsyncConfig`` + ``ArrivalModel`` from
flags, runs the asynchronous buffered backend against a ``ClientStore``,
and prints per-buffer progress (virtual clock, staleness, stragglers).
``--backend fleet`` runs the synchronous barrier with the same population
and latency distribution, for comparison. The cohorts train on
``--device`` (the card by default):

    python -m repro_torch.launch.async_fl                      # on the card
    python -m repro_torch.launch.async_fl --device cpu \\
        --clients 2000 --cohort 16 --buffer-k 8 --concurrency 32 \\
        --rounds 10 --tail-sigma 0.6 --drop-prob 0.05
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.straggler import ArrivalModel
from repro_torch.fl.async_rounds import AsyncConfig
from repro_torch.fl.population import PopulationConfig, build_population


def build_cfg(args) -> PopulationConfig:
    async_cfg = None
    if args.backend == "async":
        async_cfg = AsyncConfig(
            buffer_k=args.buffer_k,
            concurrency=args.concurrency,
            staleness_exponent=args.staleness_exponent,
            arrival=ArrivalModel(drop_prob=args.drop_prob,
                                 reconnect_mean=args.reconnect_mean,
                                 seed=args.seed),
            flash_crowds=tuple(
                (int(s), int(n)) for s, n in
                (p.split(":") for p in args.flash_crowd)),
        )
    return PopulationConfig(
        n_clients=args.clients, cohort_size=args.cohort,
        workload=args.workload, backend=args.backend,
        policy=args.policy, straggler_frac_pop=args.straggler_frac,
        tail_sigma=args.tail_sigma, n_partitions=args.partitions,
        samples_per_partition=args.samples, async_cfg=async_cfg,
        seed=args.seed, device=args.device)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.async_fl",
        description="Run FLuID rounds with the async buffered backend "
                    "(or the synchronous fleet barrier for comparison).")
    ap.add_argument("--backend", choices=("async", "fleet"),
                    default="async")
    ap.add_argument("--clients", type=int, default=20_000)
    ap.add_argument("--cohort", type=int, default=32,
                    help="sync cohort size (fleet backend only)")
    ap.add_argument("--rounds", type=int, default=20,
                    help="barrier rounds (fleet) / drained buffers (async)")
    ap.add_argument("--workload", default="synth")
    ap.add_argument("--policy", default="invariant")
    ap.add_argument("--partitions", type=int, default=64)
    ap.add_argument("--samples", type=int, default=100,
                    help="samples per data partition")
    ap.add_argument("--straggler-frac", type=float, default=0.1)
    ap.add_argument("--tail-sigma", type=float, default=0.6,
                    help="client lognormal latency tail (both backends)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the cohorts train (cuda, or cpu for the "
                         "kernels' plain versions)")
    # async-only knobs
    ap.add_argument("--buffer-k", type=int, default=16)
    ap.add_argument("--concurrency", type=int, default=128)
    ap.add_argument("--staleness-exponent", type=float, default=0.5)
    ap.add_argument("--drop-prob", type=float, default=0.0,
                    help="per-dispatch mid-round dropout probability")
    ap.add_argument("--reconnect-mean", type=float, default=30.0)
    ap.add_argument("--flash-crowd", action="append", default=[],
                    metavar="STEP:EXTRA",
                    help="dispatch EXTRA clients beyond the concurrency "
                         "target at server step STEP (repeatable)")
    ap.add_argument("--eval-every", type=int, default=5)
    return ap


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    sim = build_population(build_cfg(args))
    for step in range(args.rounds):
        ev = args.eval_every and (step + 1) % args.eval_every == 0
        log = sim.run_round(eval_now=bool(ev))
        clock = getattr(sim, "clock", None)
        line = (f"step {step:3d}  time {log.round_time:7.2f}s"
                if clock is None else
                f"buffer {step:3d}  clock {clock:8.2f}s"
                f"  stale max {log.staleness_max:3.0f}")
        line += f"  stragglers {len(log.stragglers):3d}"
        if ev:
            line += f"  acc {log.accuracy:.4f}"
        print(line)
    if args.backend == "async":
        print(f"done: {args.rounds} buffers x K={args.buffer_k}, "
              f"virtual clock {sim.clock:.2f}s, "
              f"dropouts survived {sim.backend.total_drops}, "
              f"in flight {len(sim.backend.in_flight_ids)}")
    else:
        tot = sum(h.round_time for h in sim.server.history)
        print(f"done: {args.rounds} barrier rounds, "
              f"simulated wall-clock {tot:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
