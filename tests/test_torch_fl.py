"""The port's FL training path against the JAX reference, on the CPU.

Each module of the slice gets the same inputs in both packages (numpy
seeds; the reference's initial params carried over with
``interop.params_from_numpy``): numpy-side logic must agree exactly
(datasets, partitions, keep-maps, straggler plans, the client store,
sim times), fp32 math to the stated tolerance. The slice test runs
``run_experiment`` on ``femnist_kernel`` / ``fleet`` / ``use_kernels=True``
in both and holds stragglers, rates, round times and keep-maps equal every
round, and the final params within 5e-4 (the reference's own
fleet-vs-sequential tolerance, tests/test_fleet.py). The reference runs its
Pallas kernels in interpret mode; the port runs their plain versions.
"""
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.aggregate import aggregate_stacked as j_aggregate_stacked  # noqa: E402
from repro.core import dropout as j_drop  # noqa: E402
from repro.core import invariant as j_inv  # noqa: E402
from repro.core import straggler as j_strag  # noqa: E402
from repro.core import submodel as j_sub  # noqa: E402
from repro.data import partition as j_part  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.fl import client as j_client  # noqa: E402
from repro.fl import fleet as j_fleet  # noqa: E402
from repro.fl import population as j_pop  # noqa: E402
from repro.fl import simulation as j_simu  # noqa: E402
from repro.models.kernel_models import KernelAttnClassifier, KernelMLP as JMLP  # noqa: E402
from repro_torch.core import aggregate as t_agg  # noqa: E402
from repro_torch.core import dropout as t_drop  # noqa: E402
from repro_torch.core import invariant as t_inv  # noqa: E402
from repro_torch.core import straggler as t_strag  # noqa: E402
from repro_torch.core import submodel as t_sub  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import partition as t_part  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.fl import client as t_client  # noqa: E402
from repro_torch.fl import fleet as t_fleet  # noqa: E402
from repro_torch.fl import population as t_pop  # noqa: E402
from repro_torch.fl import simulation as t_simu  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.kernel_models import KernelMLP as TMLP  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_CLIENTS, N_DATA, ROUNDS = 4, 240, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: the suite runs in
    several worker processes, and per-op thread pools would oversubscribe
    the cores (gradcheck ran 75x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(jtree, ttree, atol, rtol=0.0):
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(),
                                   atol=atol, rtol=rtol)


def _jax_params(seed=0):
    return _np_tree(JMLP.init(jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# data

@pytest.mark.parametrize("name,n", [("femnist", 300), ("cifar10", 120),
                                    ("shakespeare", 40), ("synth", 500)])
def test_dataset_and_partition_bitwise(name, n):
    a = j_syn.make_dataset(name, n=n, n_test=n // 4, n_partitions=10, seed=3)
    b = t_syn.make_dataset(name, n=n, n_test=n // 4, n_partitions=10, seed=3)
    for f in ("x", "y", "writer", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    for pa, pb in zip(j_part.partition_non_iid(a, 4, seed=1),
                      t_part.partition_non_iid(b, 4, seed=1)):
        np.testing.assert_array_equal(pa, pb)
    for pa, pb in zip(j_part.partition_iid(a, 3, seed=2),
                      t_part.partition_iid(b, 3, seed=2)):
        np.testing.assert_array_equal(pa, pb)


# ---------------------------------------------------------------------------
# dropout policies, invariant stats, thresholds

def _stats(n_clients, sizes, seed):
    rng = np.random.RandomState(seed)
    return [{g: (np.abs(rng.randn(s)) * 0.01 + 1e-3).astype(np.float32)
             for g, s in sizes.items()} for _ in range(n_clients)]


@pytest.mark.parametrize("policy", ["random", "ordered", "invariant"])
def test_policy_keep_maps_bitwise(policy):
    specs = KernelAttnClassifier.UNIT_SPECS
    a = j_drop.get_policy(policy, specs, seed=5)
    b = t_drop.get_policy(policy, specs, seed=5)
    assert t_drop.available_policies() == j_drop.available_policies()
    sizes = {g["name"]: g["size"] for g in specs}
    for step in range(3):
        stats = _stats(3, sizes, seed=step)
        th = float(np.median(np.concatenate([s["ffn"] for s in stats])))
        a.observe([{g: jnp.asarray(v) for g, v in cs.items()} for cs in stats], th)
        b.observe([{g: torch.from_numpy(v) for g, v in cs.items()} for cs in stats], th)
        for r in (0.5, 0.65, 0.75, 1.0):
            ka, kb = a.keep_map(r), b.keep_map(r)
            assert ka.keys() == kb.keys()
            for g in ka:
                np.testing.assert_array_equal(ka[g], kb[g])
                assert ka[g].dtype == kb[g].dtype


def test_thresholds_and_counts_match():
    sizes = {"ffn": 1024}
    stats = _stats(3, sizes, seed=11)
    js = [{g: jnp.asarray(v) for g, v in cs.items()} for cs in stats]
    ts = [{g: torch.from_numpy(v) for g, v in cs.items()} for cs in stats]
    th0_j, th0_t = j_inv.initial_threshold(js), t_inv.initial_threshold(ts)
    assert th0_t == pytest.approx(th0_j, rel=1e-6)
    for target in (10, 300, 700):
        th = j_inv.calibrate_threshold(js, target, th0_j)
        assert t_inv.calibrate_threshold(ts, target, th0_j) == th
        assert t_inv.count_invariant(ts, th) == j_inv.count_invariant(js, th)
        for g, v in j_inv.invariant_counts(js, th).items():
            np.testing.assert_array_equal(t_inv.invariant_counts(ts, th)[g], v)


@pytest.mark.parametrize("specs_of", ["kernel_mlp", "tiled"])
def test_neuron_stats_match(specs_of):
    rng = np.random.RandomState(4)
    if specs_of == "kernel_mlp":
        specs = JMLP.UNIT_SPECS
        prev = _jax_params()
    else:      # tile-major (tile 3) and unit-major (tile -16) groupings
        specs = [{"name": "a", "size": 8, "out": [("l/w", 1, 3)], "in": []},
                 {"name": "h", "size": 4, "out": [("m/w", 1, -16),
                                                  ("m/v", 0, -16)], "in": []}]
        prev = {"l": {"w": rng.randn(5, 24).astype(np.float32)},
                "m": {"w": rng.randn(7, 64).astype(np.float32),
                      "v": rng.randn(64, 3).astype(np.float32)}}
    new = jax.tree.map(lambda a: (a + 0.01 * rng.randn(*a.shape)).astype(np.float32),
                       prev)
    want = j_inv.neuron_stats(prev, new, specs)
    got = t_inv.neuron_stats(params_from_numpy(prev, device="cpu"),
                             params_from_numpy(new, device="cpu"), specs)
    for g in want:
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# stragglers and the client store

def test_plan_and_plan_from_store_exact():
    rng = np.random.RandomState(0)
    for trial in range(40):
        n = rng.randint(2, 30)
        cap = 32                          # one store shape: one jit trace
        lat = {i: float(10 * (1 + 0.05 * rng.randn())) for i in range(n)}
        for s in rng.choice(n, rng.randint(0, max(1, n // 3)), replace=False):
            lat[int(s)] *= 1.3
        for frac in (None, 0.0, 0.25):
            assert asdict(t_strag.plan(lat, frac=frac)) == asdict(j_strag.plan(lat, frac=frac))
        assert t_strag.detect_band(lat) == j_strag.detect_band(lat)
        assert t_strag.pick_rate(1 + trial / 20) == j_strag.pick_rate(1 + trial / 20)
        if trial % 4:                     # the reference's store jits per cohort size
            continue
        ids = np.arange(n)
        speeds = np.asarray([lat[i] for i in ids], np.float32)
        js = j_pop.ClientStore.empty(cap).register(ids, speeds, ids)
        ts = t_pop.ClientStore.empty(cap).register(ids, speeds, ids)
        obs = ids[: max(1, n - 1)]        # one client never observed
        args = (obs, speeds[obs], np.ones(obs.size, np.float32))
        js, ts = js.update_from_round(*args), ts.update_from_round(*args)
        for frac in (None, 0.3):
            assert (asdict(t_strag.plan_from_store(ts, list(ids), frac=frac))
                    == asdict(j_strag.plan_from_store(js, list(ids), frac=frac)))


def test_client_store_ops_match():
    ids = np.arange(6)
    speeds = np.asarray([10, 11, 13, 9.5, 10.2, 12], np.float32)
    js = j_pop.ClientStore.empty(8, history=3).register(ids, speeds, ids[::-1])
    ts = t_pop.ClientStore.empty(8, history=3).register(ids, speeds, ids[::-1])
    rng = np.random.RandomState(1)
    for rnd in range(5):
        sel = np.sort(rng.choice(6, 4, replace=False))
        lat = (speeds[sel] * (1 + 0.03 * rng.randn(4))).astype(np.float32)
        rates = np.where(rng.rand(4) < 0.3, 0.75, 1.0).astype(np.float32)
        js = js.update_from_round(sel, lat, rates).assign_rates(sel[:2], rates[:2])
        ts = ts.update_from_round(sel, lat, rates).assign_rates(sel[:2], rates[:2])
    js, ts = js.set_speed([2], [20.0]), ts.set_speed([2], [20.0])
    for f in ("speed", "speed_hist", "dropout_rate", "data_shard",
              "rounds_participated", "active"):
        np.testing.assert_array_equal(getattr(ts, f), np.asarray(getattr(js, f)))
    for f in ("speed_ema", "straggler_ema"):
        np.testing.assert_allclose(getattr(ts, f), np.asarray(getattr(js, f)),
                                   rtol=1e-6)
    q = [0, 3, 5, 7]
    np.testing.assert_array_equal(ts.last_latency(q), js.last_latency(q))
    np.testing.assert_array_equal(ts.rates_of(q), js.rates_of(q))


# ---------------------------------------------------------------------------
# sub-models and aggregation

def _keep_maps(specs, seed):
    pol = j_drop.get_policy("random", specs, seed=seed)
    return pol.keep_map(0.75), j_drop.get_policy("ordered", specs).keep_map(0.5)


def test_keep_mask_extract_embed_match():
    params = _jax_params()
    tparams = params_from_numpy(params, device="cpu")
    for km in _keep_maps(JMLP.UNIT_SPECS, 2):
        _close(j_sub.keep_mask(params, JMLP.UNIT_SPECS, km),
               t_sub.keep_mask(tparams, JMLP.UNIT_SPECS, km), atol=0)
        jsub = j_sub.extract(params, JMLP.UNIT_SPECS, km)
        tsub = t_sub.extract(tparams, JMLP.UNIT_SPECS, km)
        _close(jsub, tsub, atol=0)
        jd, jm = j_sub.embed_delta(jsub, params, JMLP.UNIT_SPECS, km)
        td, tm = t_sub.embed_delta(tsub, tparams, JMLP.UNIT_SPECS, km)
        _close(jd, td, atol=0)
        _close(jm, tm, atol=0)


def test_aggregate_stacked_and_aggregate_match():
    rng = np.random.RandomState(9)
    params = _jax_params()
    tparams = params_from_numpy(params, device="cpu")
    kms = _keep_maps(JMLP.UNIT_SPECS, 5)
    rows = [jax.tree.map(np.ones_like, params)] + [
        _np_tree(j_sub.keep_mask(params, JMLP.UNIT_SPECS, km)) for km in kms]
    bank = jax.tree.map(lambda *r: np.stack(r), *rows)
    idx = np.asarray([0, 1, 0, 2, 1], np.int32)
    weights = np.asarray([30, 12, 25, 40, 7], np.float32)
    deltas = jax.tree.map(lambda b: (0.01 * rng.randn(5, *b.shape[1:])
                                     * b[idx]).astype(np.float32), bank)
    want = j_aggregate_stacked(params, deltas, jnp.asarray(weights),
                                   bank, jnp.asarray(idx))
    tbank = params_from_numpy(bank, device="cpu")
    got = t_agg.aggregate_stacked(tparams, params_from_numpy(deltas, device="cpu"),
                                  torch.from_numpy(weights), tbank,
                                  torch.from_numpy(idx))
    _close(want, got, atol=1e-6)
    ups = [t_agg.ClientUpdate(tree_map(lambda d: torch.from_numpy(d[i]), deltas),
                              int(weights[i]),
                              None if idx[i] == 0 else
                              tree_map(lambda b: b[int(idx[i])], tbank))
           for i in range(5)]
    _close(want, t_agg.aggregate(tparams, ups), atol=1e-6)


# ---------------------------------------------------------------------------
# one fleet round, then the whole slice

def _fresh_clients(mod):
    ds = t_syn.make_dataset("femnist", n=N_DATA, n_test=400, n_partitions=16)
    parts = t_part.partition_non_iid(ds, N_CLIENTS)
    speeds = t_simu.default_speeds(N_CLIENTS, (0,))
    return [mod.FleetClient(i, None, ds.x[parts[i]], ds.y[parts[i]],
                            speed=speeds[i], batch_size=10, lr=0.02)
            for i in range(N_CLIENTS)]


def test_fleet_round_matches_reference():
    params = _jax_params()
    km0, km2 = _keep_maps(JMLP.UNIT_SPECS, 6)
    keep_maps, rates = {0: km0, 2: km2}, {0: 0.75, 2: 0.5}
    jeng = j_fleet.FleetEngine(JMLP, _fresh_clients(j_client), JMLP.UNIT_SPECS,
                               use_kernels=True)
    teng = t_fleet.FleetEngine(TMLP, _fresh_clients(t_client), TMLP.UNIT_SPECS,
                               use_kernels=True, device="cpu")
    assert teng.steps == jeng.steps and teng.bs == jeng.bs
    jr = jeng.run_cohort(jax.tree.map(jnp.asarray, params), keep_maps, rates)
    tr = teng.run_cohort(params_from_numpy(params, device="cpu"), keep_maps, rates)
    _close(jr.deltas, tr.deltas, atol=1e-4)
    assert tr.sim_times == jr.sim_times
    np.testing.assert_array_equal(tr.mask_idx.numpy(), np.asarray(jr.mask_idx))
    _close(jr.mask_bank, tr.mask_bank, atol=0)
    _close(jr.aggregate(params), tr.aggregate(params_from_numpy(params, device="cpu")),
           atol=1e-4)
    for a, b in zip(jr.non_straggler_stats(params),
                    tr.non_straggler_stats(params_from_numpy(params, device="cpu"))):
        np.testing.assert_allclose(b["ffn"].numpy(), a["ffn"], rtol=1e-3, atol=1e-6)


def test_mask_bank_dedupes_like_reference():
    params = _jax_params()
    km0, km1 = _keep_maps(JMLP.UNIT_SPECS, 8)
    keep_maps = {0: km0, 1: km1, 3: {g: k.copy() for g, k in km0.items()}}
    jeng = j_fleet.FleetEngine(JMLP, _fresh_clients(j_client), JMLP.UNIT_SPECS,
                               use_kernels=True)
    teng = t_fleet.FleetEngine(TMLP, _fresh_clients(t_client), TMLP.UNIT_SPECS,
                               use_kernels=True, device="cpu")
    jb, ji, jn = jeng._mask_bank(jax.tree.map(jnp.asarray, params), keep_maps)
    tb, ti, tn = teng._mask_bank(params_from_numpy(params, device="cpu"), keep_maps)
    assert tree_leaves(tb)[0].shape[0] == 3          # clients 0 and 3 share a row
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tn, jn)
    assert tn.dtype == np.int64
    _close(jb, tb, atol=0)
    again = teng._mask_bank(params_from_numpy(params, device="cpu"), dict(keep_maps))
    assert again[0] is tb                             # cached while unchanged


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


def _run(mod, **extra):
    kw = dict(workload="femnist_kernel", backend="fleet", use_kernels=True,
              cohort=mod.CohortConfig(n_clients=N_CLIENTS, n_data=N_DATA))
    sim = mod.build_simulation(mod.SimulationConfig(**kw, **extra.pop("cfg", {})),
                               **extra)
    rec = _Recorder(sim.server.backend)
    sim.server.backend = rec
    return sim, sim.server.run(ROUNDS, eval_every=1), rec.keep_maps


def test_run_experiment_matches_reference():
    jsim, jhist, jkm = _run(j_simu)
    tsim, thist, tkm = _run(t_simu, cfg=dict(device="cpu"),
                            params=params_from_numpy(_jax_params(), device="cpu"))
    assert len(thist) == len(jhist) == ROUNDS
    assert any(h.stragglers for h in jhist)       # dropout engaged
    for a, b, ka, kb in zip(jhist, thist, jkm, tkm):
        assert b.stragglers == a.stragglers
        assert b.rates == a.rates
        assert b.round_time == a.round_time
        assert kb.keys() == ka.keys()
        for cid in ka:
            for g in ka[cid]:
                np.testing.assert_array_equal(kb[cid][g], ka[cid][g])
        assert abs(b.accuracy - a.accuracy) <= 1 / 400 + 1e-9
        assert b.threshold == pytest.approx(a.threshold, rel=1e-5)
    _close(jsim.server.params, tsim.server.params, atol=5e-4)
    np.testing.assert_array_equal(tsim.store.speed_hist,
                                  np.asarray(jsim.store.speed_hist))


# ---------------------------------------------------------------------------
# configuration and hygiene

def test_simulation_config_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_simu.SimulationConfig(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_simu.run_experiment(t_simu.SimulationConfig(
            workload="femnist_kernel", backend="fleet", use_kernels=True),
            rounds=1)


@pytest.mark.parametrize("kw,err", [
    (dict(workload="femnist", backend="fleet", n_shards=2), ValueError),
    (dict(workload="femnist_kernel", backend="sharded_fleet",
          use_kernels=True), ValueError),
    (dict(workload="femnist_attn", backend="async"), ValueError),
    (dict(workload="femnist_cnn"), ValueError),
    (dict(workload="femnist_kernel", backend="sequential", use_kernels=True),
     ValueError),
    (dict(workload="mnist", backend="fleet", use_kernels=True), ValueError),
    (dict(workload="femnist_kernel", backend="fleet", use_kernels=True,
          policy="bogus"), ValueError),
])
def test_unported_or_invalid_configs_raise(kw, err):
    with pytest.raises(err):
        t_simu.SimulationConfig(device="cpu", **kw)


def test_fl_slice_runs_without_jax():
    code = ("import sys\n"
            "from repro_torch.fl.simulation import run_experiment, SimulationConfig, CohortConfig\n"
            "cfg = SimulationConfig(workload='femnist_kernel', backend='fleet', use_kernels=True,\n"
            "                       cohort=CohortConfig(n_clients=3, n_data=90), device='cpu')\n"
            "sim, hist = run_experiment(cfg, rounds=2)\n"
            "assert len(hist) == 2 and hist[-1].accuracy == hist[-1].accuracy\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
