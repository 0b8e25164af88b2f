"""Paper Table 2 (small scale) on the PyTorch port: Random vs Ordered vs
Invariant Dropout (twin of examples/compare_dropout_methods.py).

Trains the same federated workload with each dropout policy at a fixed
sub-model size and prints final test accuracy. Invariant Dropout picks the
neurons whose updates stay below the calibrated threshold for the majority
of non-straggler clients — the paper's core claim is that this ordering
(Invariant >= Ordered >= Random) holds across sizes.

Run:  PYTHONPATH=src python examples/compare_dropout_methods_torch.py [rounds] [--device cpu]
"""
import argparse

from repro_torch.fl.simulation import (CohortConfig, SimulationConfig,
                                       build_simulation)


def run(device="cuda", rounds=15, rate=0.75, n_data=1200):
    """The reference's three runs; returns {method: final accuracy}."""
    print(f"sub-model size r={rate}, {rounds} rounds, 5 clients, 1 straggler")
    out = {}
    for method in ("random", "ordered", "invariant"):
        sim = build_simulation(SimulationConfig(
            workload="femnist", policy=method, fixed_rate=rate, seed=0,
            cohort=CohortConfig(n_clients=5, straggler_ids=(0,), n_data=n_data),
            device=device))
        hist = sim.server.run(rounds, eval_every=rounds)
        out[method] = hist[-1].accuracy
        print(f"  {method:10s} final accuracy = {hist[-1].accuracy:.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Table 2 at small scale on the PyTorch port")
    ap.add_argument("rounds", nargs="?", type=int, default=15)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(device=args.device, rounds=args.rounds)


if __name__ == "__main__":
    main()
