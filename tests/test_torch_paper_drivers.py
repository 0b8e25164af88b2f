"""The port's seven paper drivers (scripts/paper_experiments_torch.py)
against the reference's (benchmarks/paper_experiments.py, loaded by file
path), on the CPU at a tiny size: Table 2, Fig 4a, Fig 4b, Fig 5, Fig 6,
Table 3 and the one-shot-pruning probe.

Each driver runs with the same arguments in both packages, femnist at
n_data 100 and a few rounds, so that a sub-model trains (one data size
for all, so the reference compiles each client's step once); the port
starts from the reference's initial params (its ``FemnistCNN.init``
replaced by ``interop.params_from_numpy`` of the reference's
``PRNGKey(seed)`` params). Beside the returned dicts, every simulation a
driver builds is recorded (its ``_sim`` wrapped) and the two packages'
are held to each other round by round. Tolerances are those of
tests/test_torch_sequential.py and test_torch_paper_runs.py: stragglers,
rates and keep-maps exact; modelled times rel 1e-9; ``within_10pct`` and
invariant fractions equal; accuracy within 1/n_test; params within 5e-4.
Table 3 and the probe train every client once more from the final params
(``c.train``) and read the per-neuron update statistics of that pass: the
threshold sweep's invariant fractions must be equal, the probe's
sub-models extracted with the same keep-maps.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.core import submodel as j_sm  # noqa: E402
from repro.models import small as j_small  # noqa: E402
from repro_torch.core import submodel as t_sm  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import small as t_small  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_TEST = 400                  # make_dataset's test size: max(400, n_data // 5)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("ref_paper_experiments", "benchmarks/paper_experiments.py")
PORT = _load("paper_experiments_torch", "scripts/paper_experiments_torch.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(build, out):
    """``_sim`` that appends (sim, keep-maps by round) to ``out``."""
    def _sim(*a, **kw):
        sim = build(*a, **kw)
        backend, kms = sim.server.backend, []

        def run_round(params, keep_maps, rates, inner=backend.run_round):
            kms.append({c: {g: np.asarray(k) for g, k in km.items()}
                        for c, km in keep_maps.items()})
            return inner(params, keep_maps, rates)
        backend.run_round = run_round
        out.append((sim, kms))
        return sim
    return _sim


@pytest.fixture
def sims(monkeypatch):
    """Reference initial params for the port; both packages' simulations
    recorded: {"ref": [...], "port": [...]}."""
    init = jax.jit(j_small.FemnistCNN.init)
    monkeypatch.setattr(t_small.FemnistCNN, "init", staticmethod(
        lambda seed=0, device="cuda": params_from_numpy(
            jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed))), device)))
    built = {"ref": [], "port": []}
    for key, mod in (("ref", REF), ("port", PORT)):
        monkeypatch.setattr(mod, "_sim", _recording(mod._sim, built[key]))
    return built


def _same_acc(a, b):
    assert math.isnan(a) == math.isnan(b)
    if not math.isnan(a):
        assert abs(b - a) <= 1 / N_TEST + 1e-9, (a, b)


def hold_same_sims(built):
    """Every pair of recorded simulations: the same plans, keep-maps and
    modelled times each round, accuracy within 1/n_test, params 5e-4."""
    assert len(built["port"]) == len(built["ref"]) > 0
    for (js, jk), (ts, tk) in zip(built["ref"], built["port"]):
        jh, th = js.server.history, ts.server.history
        assert len(th) == len(jh) == len(tk) == len(jk)
        for a, b, ka, kb in zip(jh, th, jk, tk):
            assert (b.stragglers, b.rates) == (a.stragglers, a.rates)
            for k in ("round_time", "straggler_time", "t_target"):
                assert getattr(b, k) == pytest.approx(getattr(a, k), rel=1e-9), k
            assert b.invariant_frac == a.invariant_frac
            _same_acc(a.accuracy, b.accuracy)
            assert kb.keys() == ka.keys()
            for c in ka:
                assert kb[c].keys() == ka[c].keys()
                for g in ka[c]:
                    np.testing.assert_array_equal(kb[c][g], ka[c][g])
        for a, b in zip(jax.tree.leaves(js.server.params), tree_leaves(ts.server.params)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4, rtol=0)
    return [s for s, _ in built["port"]]


def test_table2_accuracy_matches_reference(sims):
    kw = dict(rates=(0.75,), rounds=2, n_data=100, seeds=(0, 1))
    ref = REF.table2_accuracy(**kw)
    got = PORT.table2_accuracy(device="cpu", **kw)
    assert list(got) == list(ref) == [(m, 0.75) for m in PORT.METHODS]
    for k in ref:
        _same_acc(ref[k][0], got[k][0])            # the mean over the seeds
        assert abs(got[k][1] - ref[k][1]) <= 1 / N_TEST + 1e-9
    port = hold_same_sims(sims)
    assert len(port) == 6 and all(s.server.history[-1].rates for s in port)
    assert {s.server.cfg.fixed_rate for s in port} == {0.75}


def test_fig4a_straggler_time_matches_reference(sims):
    kw = dict(rounds=3, n_data=100)
    ref, got = REF.fig4a_straggler_time(**kw), PORT.fig4a_straggler_time(device="cpu", **kw)
    assert got.keys() == ref.keys()
    assert got["within_10pct"] == ref["within_10pct"]
    for k in ("t_straggler_before", "t_straggler_after", "t_target"):
        assert got[k] == pytest.approx(ref[k], rel=1e-9), k
    hold_same_sims(sims)


def test_fig4b_dynamic_stragglers_matches_reference(sims):
    kw = dict(rounds=4, n_data=100)
    ref = REF.fig4b_dynamic_stragglers(**kw)
    got = PORT.fig4b_dynamic_stragglers(device="cpu", **kw)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-9), k
    none, static, fluid = hold_same_sims(sims)
    # the static arm's frozen plan goes on treating client 0 as the straggler
    # after the switch (round 2 on), and client 0 goes on training the
    # sub-model; FLuID's moves to client 3
    assert static.server.cfg.calibrate_every == 10_000 and fluid.server.cfg.calibrate_every == 1
    assert [h.stragglers for h in static.server.history] == [[], [0], [0], [0]]
    assert [h.stragglers for h in fluid.server.history] == [[], [0], [0], [3]]
    assert static.store.rates_of([0])[0] < 1.0 and static.store.rates_of([3])[0] == 1.0
    assert sims["port"][1][1][3].keys() == {0} and sims["port"][2][1][3].keys() == {3}
    assert all(km == {} for km in sims["port"][0][1])      # "none" drops nothing


def test_fig5_scalability_matches_reference(sims):
    kw = dict(n_clients=10, rounds=2, n_data=100)
    ref = REF.fig5_scalability(**kw)
    got = PORT.fig5_scalability(device="cpu", **kw)
    assert list(got) == list(ref) == [*PORT.METHODS, "none"]
    for m in ref:
        _same_acc(ref[m]["accuracy"], got[m]["accuracy"])
        assert got[m]["mean_round_time"] == pytest.approx(ref[m]["mean_round_time"], rel=1e-9)
    port = hold_same_sims(sims)
    assert sorted(port[0].server.history[-1].stragglers) == [0, 1]   # 20% of 10


def test_fig6_invariant_evolution_matches_reference(sims):
    kw = dict(rounds=3, n_data=100)
    ref = REF.fig6_invariant_evolution(**kw)
    got = PORT.fig6_invariant_evolution(device="cpu", **kw)
    assert got == ref
    assert all(0.0 < f <= 1.0 for f in got["invariant_frac_by_round"])
    hold_same_sims(sims)


def test_table3_threshold_matches_reference(sims):
    kw = dict(rounds=2, n_data=100, thresholds=(0.002, 0.005, 0.01, 0.02, 0.05))
    ref = REF.table3_threshold(**kw)
    got = PORT.table3_threshold(device="cpu", **kw)
    assert got == ref
    fr = list(got.values())
    assert fr == sorted(fr) and fr[0] < fr[-1]
    hold_same_sims(sims)


def _recording_extract(monkeypatch, mod, out):
    inner = mod.extract

    def extract(params, unit_specs, keep_map):
        out.append({g: np.asarray(k) for g, k in keep_map.items()})
        return inner(params, unit_specs, keep_map)
    monkeypatch.setattr(mod, "extract", extract)


def test_insight_oneshot_pruning_matches_reference(sims, monkeypatch):
    kms = {"ref": [], "port": []}
    _recording_extract(monkeypatch, j_sm, kms["ref"])
    _recording_extract(monkeypatch, t_sm, kms["port"])
    kw = dict(rounds=2, n_data=100)
    ref = REF.insight_oneshot_pruning(**kw)
    got = PORT.insight_oneshot_pruning(device="cpu", **kw)
    assert list(got) == list(ref) == ["full"] + [f"{m}@r{r}" for r in (0.9, 0.75, 0.5)
                                                 for m in PORT.METHODS]
    for k in ref:
        _same_acc(ref[k], got[k])
    assert len(kms["port"]) == len(kms["ref"]) == 9
    for a, b in zip(kms["ref"], kms["port"]):
        assert b.keys() == a.keys()
        for g in a:
            np.testing.assert_array_equal(b[g], a[g])
    hold_same_sims(sims)
