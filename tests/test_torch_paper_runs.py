"""The paper's VGG-9 (CIFAR10) and LSTM (Shakespeare) workloads, whole runs
on the sequential backend, port against the JAX reference.

Two rounds: the first trains every client on the full model and
calibrates, the second trains straggler 0 on a physically extracted
sub-model. ``n_data`` 80 over 4 clients is the least that gives every
client a batch. The port starts from the reference's initial params and
must reach the same stragglers, rates, keep-maps and round times (rel
1e-9), and params within 5e-4 (tests/test_fleet.py's tolerance).
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.fl import simulation as j_simu  # noqa: E402
from repro.models import small as j_small  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.fl import simulation as t_simu  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mod, cfg, rounds, **extra):
    """Run ``cfg``, keeping each round's keep-maps as the backend sees them."""
    sim = mod.build_simulation(cfg, **extra)
    backend, kms = sim.server.backend, []

    def run_round(params, keep_maps, rates, inner=backend.run_round):
        kms.append({c: {g: np.asarray(k) for g, k in km.items()}
                    for c, km in keep_maps.items()})
        return inner(params, keep_maps, rates)
    backend.run_round = run_round
    return sim, sim.server.run(rounds, eval_every=1), kms


@pytest.mark.parametrize("workload", ["cifar10", "shakespeare"])
def test_paper_workload_run_matches_reference(workload):
    cohort = dict(n_clients=4, n_data=80)
    jsim, jh, jk = _run(j_simu, j_simu.SimulationConfig(
        workload=workload, cohort=j_simu.CohortConfig(**cohort)), 2)
    model = j_small.MODELS[t_simu.WORKLOADS[workload][1]]
    p0 = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0)))
    tsim, th, tk = _run(t_simu, t_simu.SimulationConfig(
        workload=workload, device="cpu", cohort=t_simu.CohortConfig(**cohort)),
        2, params=params_from_numpy(p0, device="cpu"))
    assert tsim.backend == jsim.backend == "sequential"
    assert jh[1].stragglers and jk[1]                # a sub-model trained
    for a, b, ka, kb in zip(jh, th, jk, tk):
        assert (b.stragglers, b.rates) == (a.stragglers, a.rates)
        assert b.round_time == pytest.approx(a.round_time, rel=1e-9)
        assert kb.keys() == ka.keys()
        for cid in ka:
            assert kb[cid].keys() == ka[cid].keys()
            for g in ka[cid]:
                np.testing.assert_array_equal(kb[cid][g], ka[cid][g])
        assert abs(b.accuracy - a.accuracy) <= 1 / 400 + 1e-9
    for a, b in zip(jax.tree.leaves(jsim.server.params),
                    tree_leaves(tsim.server.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=5e-4, rtol=0)
