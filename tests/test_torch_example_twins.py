"""The example twins (``examples/*_torch.py``) against the JAX reference's
examples, on the CPU: the three FL twins; and for all five, the paper
drivers and the validation pass, the import without JAX and the refusal to
run without a card unless the CPU is asked for
(tests/test_torch_example_twins_lm.py holds the other two twins,
tests/test_torch_paper_drivers.py the drivers).

The FL twins run at a tiny size (femnist, n_data 100, a few rounds, so
that a sub-model trains) and are held to the same calls through
``repro``'s API, from the reference's initial params (the port's
``FemnistCNN.init`` replaced by ``interop.params_from_numpy`` of the
reference's ``PRNGKey(seed)`` params). Tolerances are those of
tests/test_torch_sequential.py: stragglers and rates exact, modelled times
rel 1e-9, accuracy within 1/n_test, invariant fractions equal; the
calibrated threshold, which sums the clients' statistics, to rel 1e-3.
"""
import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.fl import simulation as j_simu  # noqa: E402
from repro.models import small as j_small  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import small as t_small  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_DATA, N_TEST = 100, 400          # make_dataset's test size: max(400, n_data // 5)
TWINS = ("quickstart", "compare_dropout_methods", "dynamic_stragglers",
         "fluid_datacenter", "serve_example")


def _load(name, folder="examples"):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / folder / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ref_cnn_init(monkeypatch):
    """The port's FemnistCNN.init gives the reference's PRNGKey(seed) params."""
    init = jax.jit(j_small.FemnistCNN.init)
    monkeypatch.setattr(t_small.FemnistCNN, "init", staticmethod(
        lambda seed=0, device="cuda": params_from_numpy(
            jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed))), device)))


def _ref_sim(**kw):
    n_data = kw.pop("n_data")
    return j_simu.build_simulation(j_simu.SimulationConfig(
        workload="femnist", **kw,
        cohort=j_simu.CohortConfig(n_clients=5, straggler_ids=(0,), n_data=n_data)))


def _same_logs(jh, th):
    assert len(th) == len(jh)
    for a, b in zip(jh, th):
        assert b.round == a.round
        assert (b.stragglers, b.rates) == (a.stragglers, a.rates)
        for k in ("round_time", "straggler_time", "t_target"):
            assert getattr(b, k) == pytest.approx(getattr(a, k), rel=1e-9), k
        assert b.invariant_frac == a.invariant_frac
        assert b.threshold == pytest.approx(a.threshold, rel=1e-3)
        assert math.isnan(a.accuracy) == math.isnan(b.accuracy)
        if not math.isnan(a.accuracy):
            assert abs(b.accuracy - a.accuracy) <= 1 / N_TEST + 1e-9


def test_quickstart_twin_matches_reference(ref_cnn_init, capsys):
    rounds = 4                     # evaluates on the fourth, as the reference
    sim = _ref_sim(policy="invariant", n_data=N_DATA)
    jh = [sim.server.run_round(eval_now=(i % 4 == 3)) for i in range(rounds)]
    th = _load("quickstart").run(device="cpu", n_data=N_DATA, rounds=rounds)
    assert jh[-1].rates and not math.isnan(jh[-1].accuracy)
    _same_logs(jh, th)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["round", "round_time", "straggler", "target", "r",
                                "th", "inv%", "acc"]
    assert [int(ln.split()[0]) for ln in lines[1:1 + rounds]] == list(range(rounds))


def test_compare_dropout_methods_twin_matches_reference(ref_cnn_init, capsys):
    rounds = 2
    ref = {}
    for method in ("random", "ordered", "invariant"):
        sim = _ref_sim(policy=method, fixed_rate=0.75, seed=0, n_data=N_DATA)
        ref[method] = sim.server.run(rounds, eval_every=rounds)[-1].accuracy
    got = _load("compare_dropout_methods").run(device="cpu", rounds=rounds, n_data=N_DATA)
    assert got.keys() == ref.keys()
    for m in ref:
        assert abs(got[m] - ref[m]) <= 1 / N_TEST + 1e-9, m
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"sub-model size r=0.75, {rounds} rounds, 5 clients, 1 straggler"
    assert [ln.split()[0] for ln in out[1:]] == ["random", "ordered", "invariant"]


def test_dynamic_stragglers_twin_matches_reference(ref_cnn_init):
    per_phase = 2
    sim = _ref_sim(policy="invariant", seed=0, n_data=N_DATA)
    jh = [sim.server.run_round() for _ in range(per_phase)]
    sim.set_speed(0, 10.0)
    sim.set_speed(3, 13.5)
    jh += [sim.server.run_round() for _ in range(per_phase)]
    assert sim.server.plan.stragglers == [3]
    th = _load("dynamic_stragglers").run(device="cpu", n_data=N_DATA,
                                         rounds_per_phase=per_phase)
    assert th[0].stragglers == [] and th[1].stragglers == [0] and th[-1].stragglers == [3]
    _same_logs(jh, th)


def test_twins_and_scripts_import_with_jax_blocked():
    code = ("import runpy, sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None           # any import of them raises\n"
            f"for name in {TWINS!r}:\n"
            "    g = runpy.run_path(f'examples/{name}_torch.py', run_name='twin')\n"
            "    assert callable(g['run']) and callable(g['main'])\n"
            "sys.path.insert(0, 'scripts')\n"
            "import paper_experiments_torch as pe, run_paper_validation_torch as pv\n"
            "assert callable(pe.insight_oneshot_pruning) and callable(pv.main)\n"
            "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'repro')\n"
            "               for m, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default runs")
@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_a_card(name):
    with pytest.raises(RuntimeError, match="cpu"):
        _load(name).main([])


DRIVERS = ("table2_accuracy", "fig4a_straggler_time", "fig4b_dynamic_stragglers",
           "fig6_invariant_evolution", "table3_threshold", "fig5_scalability",
           "insight_oneshot_pruning")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default runs")
@pytest.mark.parametrize("name", DRIVERS)
def test_paper_driver_raises_without_a_card(name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(_load("paper_experiments", "scripts"), name)()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default runs")
def test_validation_pass_raises_without_a_card(tmp_path):
    out = tmp_path / "pv.json"
    with pytest.raises(RuntimeError, match="--device cpu"):
        _load("run_paper_validation", "scripts").main(["--out", str(out)])
    assert not out.exists()
