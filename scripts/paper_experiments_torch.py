"""Paper-experiment drivers on the PyTorch port — one function per FLuID
table/figure (twin of benchmarks/paper_experiments.py: the same names,
signatures, defaults and return dicts, plus ``device``).

Each returns a dict of results; scripts/run_paper_validation_torch.py runs
the validation pass over them. Every driver trains on ``device``, which
defaults to "cuda" and raises without a card; pass device="cpu" to run on
the CPU. The accuracies are measured; the round times are the simulation's
modelled seconds (the clients' speed model), not the device's.

    cd scripts && PYTHONPATH=../src python -c \\
        "import paper_experiments_torch as pe; print(pe.fig4a_straggler_time(device='cpu'))"
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import invariant as inv
from repro_torch.core import submodel as sm
from repro_torch.core.dropout import DropoutPolicy
from repro_torch.core.tree import tree_map
from repro_torch.fl.simulation import (CohortConfig, SimulationConfig,
                                       build_simulation)

METHODS = ("random", "ordered", "invariant")


def _sim(workload, *, n_clients=5, straggler_ids=(0,), method="invariant",
         fixed_rate=None, straggler_frac=None, n_data=400, slow_factor=1.3,
         seed=0, device="cuda"):
    """All paper drivers build through one typed-config helper."""
    return build_simulation(SimulationConfig(
        workload=workload, policy=method, fixed_rate=fixed_rate,
        straggler_frac=straggler_frac, seed=seed, device=device,
        cohort=CohortConfig(n_clients=n_clients, straggler_ids=straggler_ids,
                            n_data=n_data, slow_factor=slow_factor)))


def table2_accuracy(workload="femnist", rates=(0.75,), rounds=8,
                    n_clients=5, n_data=600, seeds=(0,),
                    device="cuda") -> Dict:
    """Table 2: accuracy of Random/Ordered/Invariant at fixed sub-model
    sizes (straggler trains the r-sized sub-model). Keyed by (method, r):
    (mean, std) over the seeds."""
    out = {}
    for r in rates:
        for m in METHODS:
            accs = []
            for s in seeds:
                sim = _sim(workload, n_clients=n_clients, method=m,
                           fixed_rate=r, n_data=n_data, seed=s, device=device)
                hist = sim.server.run(rounds, eval_every=rounds)
                accs.append(hist[-1].accuracy)
            out[(m, r)] = (float(np.mean(accs)), float(np.std(accs)))
    return out


def fig4a_straggler_time(workload="femnist", rounds=6, n_data=400,
                         slow_factor=1.3, seed=0, device="cuda") -> Dict:
    """Fig 4a: straggler round time lands near T_target after FLuID."""
    sim = _sim(workload, n_data=n_data, slow_factor=slow_factor, seed=seed,
               device=device)
    hist = sim.server.run(rounds)
    before = [h for h in hist if not h.rates]
    after = [h for h in hist if h.rates]
    return {
        "t_straggler_before": float(np.mean([h.round_time for h in before])),
        "t_straggler_after": float(np.mean([h.straggler_time
                                            for h in after])),
        "t_target": float(np.mean([h.t_target for h in after])),
        "within_10pct": bool(np.mean([h.straggler_time for h in after])
                             <= 1.10 * np.mean([h.t_target for h in after])),
    }


def fig4b_dynamic_stragglers(workload="femnist", rounds=12, n_data=400,
                             seed=0, device="cuda") -> Dict:
    """Fig 4b: a different client becomes slow mid-run; FLuID re-adapts.
    Compares total time: no-dropout vs static-straggler vs dynamic FLuID.
    The static arm freezes the plan by replacing the server's FluidConfig
    (a dataclass, read every round) with one that never recalibrates: the
    store keeps client 0's rate, so client 0 goes on training the
    sub-model."""
    def run(method, dynamic_policy):
        sim = _sim(workload, method=method, n_data=n_data, seed=seed,
                   device=device)
        total, switched = 0.0, False
        for i in range(rounds):
            if i == rounds // 2 and not switched:
                sim.set_speed(0, 10.0)
                sim.set_speed(3, 13.5)
                switched = True
                if dynamic_policy == "static":
                    # freeze the plan: keep treating client 0 as straggler
                    sim.server.cfg = sim.server.cfg.__class__(
                        **{**sim.server.cfg.__dict__,
                           "calibrate_every": 10_000})
            h = sim.server.run_round()
            total += h.round_time
        return total
    t_none = run("none", "dynamic")
    t_static = run("invariant", "static")
    t_fluid = run("invariant", "dynamic")
    return {"t_baseline": t_none, "t_static_straggler": t_static,
            "t_fluid": t_fluid,
            "speedup_vs_baseline": t_none / t_fluid,
            "speedup_vs_static": t_static / t_fluid}


def fig6_invariant_evolution(workload="femnist", rounds=10, n_data=400,
                             seed=0, device="cuda") -> Dict:
    """Fig 6 / App A.1: invariant fraction grows over training."""
    sim = _sim(workload, n_data=n_data, seed=seed, device=device)
    hist = sim.server.run(rounds)
    fr = [h.invariant_frac for h in hist]
    return {"invariant_frac_by_round": fr,
            "frac_at_30pct_training": fr[max(1, int(rounds * 0.3))],
            "final_frac": fr[-1]}


def _profile_round(sim, params):
    """Each client's per-neuron update statistics of one more local
    training pass from ``params`` (the clients' RNG streams advance, as the
    reference's do)."""
    per_client = []
    for c in sim.clients:
        u = c.train(params)
        new = tree_map(lambda p, d: p + d, params, u.delta)
        per_client.append(inv.neuron_stats(params, new,
                                           sim.model_cls.UNIT_SPECS))
    return per_client


def table3_threshold(workload="femnist", rounds=6, n_data=400,
                     thresholds=(0.01, 0.03, 0.05, 0.1), seed=0,
                     device="cuda") -> Dict:
    """Table 3 / App A.2: higher threshold -> more invariant neurons."""
    sim = _sim(workload, n_data=n_data, seed=seed, device=device)
    sim.server.run(rounds)
    # recompute per-client stats at the last round
    per_client = _profile_round(sim, sim.server.params)
    total = sum(g["size"] for g in sim.model_cls.UNIT_SPECS)
    out = {}
    for th in thresholds:
        out[th] = inv.count_invariant(per_client, th) / total
    return out


def fig5_scalability(workload="femnist", n_clients=10, straggler_frac=0.2,
                     rounds=6, n_data=800, seed=0, device="cuda") -> Dict:
    """Fig 5: many clients, 20% stragglers; invariant vs baselines."""
    k = max(1, int(n_clients * straggler_frac))
    out = {}
    for m in METHODS + ("none",):
        sim = _sim(workload, n_clients=n_clients,
                   straggler_ids=tuple(range(k)), method=m,
                   straggler_frac=straggler_frac, n_data=n_data, seed=seed,
                   device=device)
        hist = sim.server.run(rounds, eval_every=rounds)
        out[m] = {"accuracy": hist[-1].accuracy,
                  "mean_round_time": float(np.mean(
                      [h.round_time for h in hist[1:]]))}
    return out


def insight_oneshot_pruning(workload="femnist", rounds=15, n_data=1500,
                            rates=(0.9, 0.75, 0.5), seed=0,
                            device="cuda") -> Dict:
    """Direct test of the paper's core insight: neurons flagged invariant
    contribute least. Train a full model federatedly, then one-shot-extract
    sub-models by each policy (no retraining) and measure the accuracy
    drop. Invariant selection should lose the least."""
    sim = _sim(workload, method="none", n_data=n_data, seed=seed,
               device=device)
    sim.server.run(rounds)
    params = sim.server.params
    specs = sim.model_cls.UNIT_SPECS

    # one extra profiling round for invariant stats
    per_client = _profile_round(sim, params)
    th = inv.initial_threshold(per_client) * 4

    pol = {m: DropoutPolicy(m, specs, seed=seed)
           for m in ("random", "ordered", "invariant")}
    pol["invariant"].observe(per_client, th)

    xt = torch.as_tensor(sim.ds.x_test, device=device)
    yt = torch.as_tensor(sim.ds.y_test, device=device)

    def acc(p):
        with torch.no_grad():
            hits = sim.model_cls.apply(p, xt).argmax(-1) == yt
        return float(hits.float().mean())

    out = {"full": acc(params)}
    for r in rates:
        for m, p in pol.items():
            sub = sm.extract(params, specs, p.keep_map(r))
            out[f"{m}@r{r}"] = acc(sub)
    return out
