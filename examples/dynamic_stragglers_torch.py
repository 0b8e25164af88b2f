"""Paper Fig 4b on the PyTorch port: FLuID re-adapts when the straggler
changes at runtime (twin of examples/dynamic_stragglers.py).

Halfway through training, client 0 (the original straggler) recovers and
client 3 degrades (emulating a background process on the phone). FLuID's
per-epoch recalibration detects the change and re-targets the sub-model.

Run:  PYTHONPATH=src python examples/dynamic_stragglers_torch.py [--device cpu]
"""
import argparse

from repro_torch.fl.simulation import (CohortConfig, SimulationConfig,
                                       build_simulation)


def run(device="cuda", n_data=500, rounds_per_phase=4):
    """The reference's two phases; returns the RoundLog of every printed
    round. Raises AssertionError if recalibration misses client 3."""
    sim = build_simulation(SimulationConfig(
        workload="femnist", policy="invariant", seed=0,
        cohort=CohortConfig(n_clients=5, straggler_ids=(0,), n_data=n_data),
        device=device))

    hist = []
    print("phase 1: client 0 is the straggler")
    for _ in range(rounds_per_phase):
        h = sim.server.run_round()
        print(f"  round {h.round}: stragglers={h.stragglers} rates={h.rates}")
        hist.append(h)

    print("\n>>> runtime shift: client 0 recovers, client 3 degrades <<<\n")
    sim.set_speed(0, 10.0)
    sim.set_speed(3, 13.5)

    print("phase 2: FLuID recalibrates")
    for _ in range(rounds_per_phase):
        h = sim.server.run_round()
        print(f"  round {h.round}: stragglers={h.stragglers} rates={h.rates}")
        hist.append(h)

    assert sim.server.plan.stragglers == [3], "recalibration failed"
    print("\nFLuID now targets client 3 — dynamic adaptation works (Fig 4b).")
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser(description="Fig 4b's dynamic stragglers on the PyTorch port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
