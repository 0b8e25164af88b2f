"""Quickstart on the PyTorch port (twin of examples/quickstart.py).

Builds a 5-client federated simulation on synthetic FEMNIST with one
straggler, runs a few rounds of Invariant-Dropout FLuID, and prints the
straggler's round time converging to the next-slowest client (paper Fig 4a)
plus the growing invariant-neuron fraction (paper Fig 6).

Run:  PYTHONPATH=src python examples/quickstart_torch.py               # on the card
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.fl.simulation import (CohortConfig, SimulationConfig,
                                       build_simulation)


def run(device="cuda", n_data=600, rounds=8):
    """The reference's run; returns the RoundLog of every printed round."""
    sim = build_simulation(SimulationConfig(
        workload="femnist",
        policy="invariant",
        cohort=CohortConfig(
            n_clients=5,
            straggler_ids=(0,),  # client 0 is ~30% slower (paper Fig 2a regime)
            n_data=n_data,
        ),
        device=device,
    ))

    print(f"{'round':>5} {'round_time':>10} {'straggler':>9} {'target':>7} "
          f"{'r':>5} {'th':>8} {'inv%':>5} {'acc':>5}")
    hist = []
    for i in range(rounds):
        h = sim.server.run_round(eval_now=(i % 4 == 3))
        r = h.rates.get(0, 1.0) if h.rates else 1.0
        print(f"{h.round:>5} {h.round_time:>10.2f} {h.straggler_time:>9.2f} "
              f"{h.t_target:>7.2f} {r:>5.2f} {h.threshold:>8.5f} "
              f"{h.invariant_frac:>5.2f} {h.accuracy:>5.2f}")
        hist.append(h)

    print("\nThe straggler now trains a sub-model sized ~1/speedup; its round "
          "time matches the next-slowest client within ~10% (paper Fig 4a).")
    return hist


def main(argv=None):
    ap = argparse.ArgumentParser(description="FLuID quickstart on the PyTorch port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
