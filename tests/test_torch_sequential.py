"""The port's sequential backend and dense fleet against the JAX reference.

The reference's default experiment, ``SimulationConfig()``, is the FEMNIST
CNN on the sequential backend: each client trains alone, a straggler on a
physically extracted sub-model whose delta comes back through
``embed_delta``. The port runs it from the reference's initial params
(``interop.params_from_numpy``) and must reach the same stragglers,
rates, keep-maps and round times (rel 1e-9) every round, and params
within 5e-4 — the reference's own fleet-vs-sequential tolerance
(tests/test_fleet.py). A client's delta agrees to 2e-5 and its sim time to
rel 1e-12, as there. The port's dense fleet is held to its own sequential
backend and, on the kernel workloads, to its kernel fleet (plain versions
on the CPU) by the same rules; a full-model client's delta is the
sequential one bit for bit, as the reference's vmap gives on XLA. Numpy-side logic (policies, thresholds,
keep-maps) must agree exactly.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dropout as j_drop  # noqa: E402
from repro.core import invariant as j_inv  # noqa: E402
from repro.fl import client as j_client  # noqa: E402
from repro.fl import rounds as j_rounds  # noqa: E402
from repro.fl import simulation as j_simu  # noqa: E402
from repro.models import small as j_small  # noqa: E402
from repro_torch.core import dropout as t_drop  # noqa: E402
from repro_torch.core import invariant as t_inv  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data import partition as t_part  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.fl import client as t_client  # noqa: E402
from repro_torch.fl import rounds as t_rounds  # noqa: E402
from repro_torch.fl import simulation as t_simu  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import small as t_small  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_CLIENTS, N_DATA = 4, 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(jtree, ttree, atol):
    assert jax.tree.structure(jtree).num_leaves == len(tree_leaves(ttree))
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        np.testing.assert_allclose(b.detach().cpu().numpy(), np.asarray(a),
                                   atol=atol, rtol=0)


def _jax_params(model_name, seed=0):
    init = jax.jit(j_small.MODELS[model_name].init)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def _clients(mod, workload, n_data=N_DATA):
    """The simulation's clients of ``workload``, built as _build does."""
    ds_name, model_name, lr, bs = t_simu.WORKLOADS[workload]
    ds = t_syn.make_dataset(ds_name, n=n_data, n_test=400, n_partitions=16)
    parts = t_part.partition_non_iid(ds, N_CLIENTS)
    speeds = t_simu.default_speeds(N_CLIENTS, (0,))
    model_cls = (j_small if mod is j_client else t_small).MODELS[model_name]
    return [mod.SimClient(i, model_cls, ds.x[parts[i]], ds.y[parts[i]],
                          speed=speeds[i], batch_size=bs, lr=lr)
            for i in range(N_CLIENTS)]


def _keep_map(model_name, r=0.5):
    specs = j_small.MODELS[model_name].UNIT_SPECS
    return j_drop.get_policy("random", specs, seed=7).keep_map(r)


# ---------------------------------------------------------------------------
# one round

def test_sequential_round_matches_reference():
    params = _jax_params("femnist_cnn")
    tparams = params_from_numpy(params, device="cpu")
    specs = t_small.FemnistCNN.UNIT_SPECS
    km0 = _keep_map("femnist_cnn", 0.5)
    km2 = j_drop.get_policy("ordered", specs).keep_map(0.5)
    keep_maps, rates = {0: km0, 2: km2}, {0: 0.5, 2: 0.5}
    jb = j_rounds.SequentialBackend(_clients(j_client, "femnist"), specs)
    tb = t_rounds.make_backend("sequential", t_small.FemnistCNN,
                               _clients(t_client, "femnist"), specs, device="cpu")
    assert isinstance(tb, t_rounds.SequentialBackend)
    jr = jb.run_round(jax.tree.map(jnp.asarray, params), keep_maps, rates)
    tr = tb.run_round(tparams, keep_maps, rates)
    assert tr.sim_times == pytest.approx(jr.sim_times, rel=1e-12)
    for a, b in zip(jr.updates(), tr.updates()):
        assert (b.client_id, b.n_samples) == (a.client_id, a.n_samples)
        _close(a.delta, b.delta, atol=2e-5)
        assert (a.mask is None) == (b.mask is None) == (a.client_id not in keep_maps)
        if a.mask is not None:
            _close(a.mask, b.mask, atol=0)
    _close(jr.aggregate(params), tr.aggregate(tparams), atol=2e-5)
    js, ts = jr.non_straggler_stats(params), tr.non_straggler_stats(tparams)
    assert len(ts) == len(js) == N_CLIENTS - len(keep_maps)
    for a, b in zip(js, ts):
        for g in a:
            np.testing.assert_allclose(b[g].numpy(), np.asarray(a[g]),
                                       rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# whole experiments

class _Recorder:
    """Wraps a RoundBackend and keeps each round's keep-maps."""

    def __init__(self, backend):
        self.backend, self.keep_maps = backend, []

    @property
    def clients(self):
        return self.backend.clients

    def run_round(self, params, keep_maps, rates):
        self.keep_maps.append({c: {g: np.asarray(k) for g, k in km.items()}
                               for c, km in keep_maps.items()})
        return self.backend.run_round(params, keep_maps, rates)


def _run(mod, cfg, rounds, **extra):
    sim = mod.build_simulation(cfg, **extra)
    rec = _Recorder(sim.server.backend)
    sim.server.backend = rec
    return sim, sim.server.run(rounds, eval_every=1), rec.keep_maps


def _same_runs(a, b, params_atol=5e-4, acc_tol=0.0):
    """Two runs' plans, keep-maps, round times and params agree."""
    (sa, ha, ka), (sb, hb, kb) = a, b
    assert len(ha) == len(hb)
    assert any(h.stragglers for h in ha)          # dropout engaged
    sizes = {g["name"]: g["size"] for g in sa.model_cls.UNIT_SPECS}
    assert any(len(k) < sizes[g] for r in ka for km in r.values()
               for g, k in km.items())                 # a sub-model trained
    for x, y, kx, ky in zip(ha, hb, ka, kb):
        assert y.stragglers == x.stragglers
        assert y.rates == x.rates
        assert y.round_time == pytest.approx(x.round_time, rel=1e-9)
        assert ky.keys() == kx.keys()
        for cid in kx:
            assert ky[cid].keys() == kx[cid].keys()
            for g in kx[cid]:
                np.testing.assert_array_equal(ky[cid][g], kx[cid][g])
        assert abs(y.accuracy - x.accuracy) <= acc_tol + 1e-9
    return [np.asarray(p) for p in jax.tree.leaves(sa.server.params)], \
        [p.cpu().numpy() for p in tree_leaves(sb.server.params)]


@pytest.mark.parametrize("workload,backend,n_data,rounds", [
    ("femnist", "sequential", N_DATA, 3),      # SimulationConfig()'s own pair
    ("synth", "fleet", N_DATA, 3),
])
def test_run_experiment_matches_reference(workload, backend, n_data, rounds):
    kw = dict(workload=workload, backend=backend)
    if workload == "femnist":
        kw = {}                                # the defaults
    jcfg = j_simu.SimulationConfig(
        **kw, cohort=j_simu.CohortConfig(n_clients=N_CLIENTS, n_data=n_data))
    tcfg = t_simu.SimulationConfig(
        **kw, device="cpu",
        cohort=t_simu.CohortConfig(n_clients=N_CLIENTS, n_data=n_data))
    assert (tcfg.workload, tcfg.backend) == (jcfg.workload, jcfg.backend) == (
        workload, backend)
    j = _run(j_simu, jcfg, rounds)
    t = _run(t_simu, tcfg, rounds, params=params_from_numpy(
        _jax_params(t_simu.WORKLOADS[workload][1]), device="cpu"))
    assert t[0].backend == backend
    for a, b in zip(*_same_runs(j, t, acc_tol=1 / 400)):
        np.testing.assert_allclose(b, a, atol=5e-4, rtol=0)
    np.testing.assert_array_equal(t[0].store.speed_hist,
                                  np.asarray(j[0].store.speed_hist))


def _port_run(workload, n_data, rounds, **kw):
    cfg = t_simu.SimulationConfig(
        workload=workload, device="cpu",
        cohort=t_simu.CohortConfig(n_clients=N_CLIENTS, n_data=n_data), **kw)
    return _run(t_simu, cfg, rounds)


def _params_close(a, b, atol=5e-4):
    for x, y in zip(*_same_runs(a, b)):
        np.testing.assert_allclose(y, x, atol=atol, rtol=0)


@pytest.mark.parametrize("workload,n_data,rounds", [
    ("femnist", N_DATA, 3), ("cifar10", N_DATA, 3), ("shakespeare", 80, 2),
    ("synth", N_DATA, 3), ("femnist_kernel", N_DATA, 3)])
def test_dense_fleet_matches_sequential(workload, n_data, rounds):
    seq = _port_run(workload, n_data, rounds, backend="sequential")
    flt = _port_run(workload, n_data, rounds, backend="fleet")
    assert not flt[0].server.backend.backend.engine.use_kernels
    _params_close(seq, flt)


def test_dense_fleet_full_clients_bitwise_sequential():
    """A round from the same params: every full-model client's delta is
    the sequential path's bit for bit; the straggler's (masked against
    extracted) within 2e-5."""
    ds_name, model_name, lr, bs = t_simu.WORKLOADS["cifar10"]
    cls = t_small.MODELS[model_name]
    ds = t_syn.make_dataset(ds_name, n=N_DATA, n_test=40, n_partitions=16)
    parts = t_part.partition_non_iid(ds, N_CLIENTS)
    speeds = t_simu.default_speeds(N_CLIENTS, (0,))
    keep, params = {0: _keep_map(model_name)}, cls.init(0, device="cpu")

    def updates(backend, client_cls):
        cs = [client_cls(i, cls, ds.x[parts[i]], ds.y[parts[i]], speed=speeds[i],
                         batch_size=bs, lr=lr) for i in range(N_CLIENTS)]
        b = t_rounds.make_backend(backend, cls, cs, cls.UNIT_SPECS, device="cpu")
        return b.run_round(params, keep, {0: 0.5}).updates()
    for a, b in zip(updates("sequential", t_client.SimClient),
                    updates("fleet", t_client.FleetClient)):
        for x, y in zip(tree_leaves(a.delta), tree_leaves(b.delta)):
            if a.client_id in keep:
                np.testing.assert_allclose(y.numpy(), x.numpy(), atol=2e-5, rtol=0)
            else:
                assert torch.equal(x, y)


@pytest.mark.parametrize("workload", ["femnist_kernel", "femnist_attn"])
def test_dense_fleet_matches_kernel_fleet(workload):
    ops.reset_launch_counts()
    dense = _port_run(workload, N_DATA, 3, backend="fleet")
    kern = _port_run(workload, N_DATA, 3, backend="fleet", use_kernels=True)
    assert kern[0].server.backend.backend.engine.use_kernels
    assert set(ops.launch_counts().values()) == {0}     # plain versions only
    _params_close(kern, dense)


def test_kernel_fleet_refuses_a_model_without_kernels():
    with pytest.raises(ValueError, match="apply_kernels"):
        t_simu.build_simulation(t_simu.SimulationConfig(
            workload="femnist", backend="fleet", use_kernels=True, device="cpu",
            cohort=t_simu.CohortConfig(n_clients=2, n_data=40)))


# ---------------------------------------------------------------------------
# the reference's small gaps: DropoutPolicy, kind="max", per-group thresholds

def _stats(n_clients, sizes, seed):
    rng = np.random.RandomState(seed)
    return [{g: (np.abs(rng.randn(s)) * 0.01 + 1e-3).astype(np.float32)
             for g, s in sizes.items()} for _ in range(n_clients)]


@pytest.mark.parametrize("policy", ["random", "ordered", "invariant"])
def test_dropout_policy_alias_matches_reference(policy):
    specs = t_small.Vgg9.UNIT_SPECS
    a = j_drop.DropoutPolicy(policy, specs, seed=4, ema_decay=0.3)
    b = t_drop.DropoutPolicy(policy, specs, seed=4, ema_decay=0.3)
    assert type(b) is type(t_drop.get_policy(policy, specs))
    sizes = {g["name"]: g["size"] for g in specs}
    for step in range(2):
        stats = _stats(3, sizes, seed=step)
        th = float(np.median(np.concatenate([s["fc1"] for s in stats])))
        a.observe([{g: jnp.asarray(v) for g, v in cs.items()} for cs in stats], th)
        b.observe([{g: torch.from_numpy(v) for g, v in cs.items()} for cs in stats], th)
        for r in (0.5, 0.75, 1.0):
            ka, kb = a.keep_map(r), b.keep_map(r)
            assert ka.keys() == kb.keys()
            for g in ka:
                np.testing.assert_array_equal(kb[g], ka[g])


@pytest.mark.parametrize("kind", ["norm", "max"])
@pytest.mark.parametrize("model_name", ["femnist_cnn", "shakespeare_lstm"])
def test_neuron_stats_kinds_match(model_name, kind):
    rng = np.random.RandomState(5)
    specs = j_small.MODELS[model_name].UNIT_SPECS
    prev = _jax_params(model_name)
    new = jax.tree.map(
        lambda a: (a + 0.01 * rng.randn(*a.shape)).astype(np.float32), prev)
    want = j_inv.neuron_stats(prev, new, specs, kind=kind)
    got = t_inv.neuron_stats(params_from_numpy(prev, device="cpu"),
                             params_from_numpy(new, device="cpu"), specs,
                             kind=kind)
    assert got.keys() == want.keys()
    for g in want:
        assert got[g].dtype == torch.float32
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]),
                                   rtol=1e-6, atol=1e-6)


def test_calibrate_threshold_per_group_matches_reference():
    sizes = {"conv1": 16, "conv2": 64, "fc1": 120}
    stats = _stats(5, sizes, seed=12)
    js = [{g: jnp.asarray(v) for g, v in cs.items()} for cs in stats]
    ts = [{g: torch.from_numpy(v) for g, v in cs.items()} for cs in stats]
    th0 = j_inv.initial_threshold(js)
    for targets in ({"conv1": 4, "conv2": 32, "fc1": 60},
                    {"fc1": 119, "conv2": 0}, {"conv1": 17}):
        want = j_inv.calibrate_threshold_per_group(js, targets, th0, max_iters=60)
        got = t_inv.calibrate_threshold_per_group(ts, targets, th0, max_iters=60)
        assert got == want


# ---------------------------------------------------------------------------
# hygiene

def test_default_config_runs_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None           # any import of them raises\n"
            "from repro_torch.fl.simulation import run_experiment, SimulationConfig\n"
            "cfg = SimulationConfig(device='cpu')\n"
            "assert (cfg.workload, cfg.backend, cfg.cohort.n_clients) == ('femnist', 'sequential', 5)\n"
            "sim, hist = run_experiment(cfg, rounds=1)\n"
            "assert len(hist) == 1 and 0.0 <= hist[-1].accuracy <= 1.0\n"
            "assert type(sim.server.backend).__name__ == 'SequentialBackend'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
