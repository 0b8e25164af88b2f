"""The port's femnist_attn training path against the JAX reference, on the CPU.

``KernelAttnClassifier`` has two droppable groups, "heads" (unit-major,
tile -16) and "ffn". Each module of the slice gets the same inputs in both
packages (numpy seeds; the reference's initial params carried over with
``interop.params_from_numpy``): the model's dense and kernel paths at
1e-5, the sub-model masks and keep-maps exactly, the invariant stats at
1e-6, one fleet round, then ``run_experiment`` on ``femnist_attn`` /
``fleet`` / ``use_kernels=True`` for 3 rounds with stragglers, rates,
round times and keep-maps equal every round and the params within 5e-4
(the reference's own fleet-vs-sequential tolerance, tests/test_fleet.py).
The reference runs its Pallas kernels in interpret mode; the port runs
their plain versions.
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
from repro.core import submodel as j_sub  # noqa: E402
from repro.fl import client as j_client  # noqa: E402
from repro.fl import fleet as j_fleet  # noqa: E402
from repro.fl import simulation as j_simu  # noqa: E402
from repro.models.kernel_models import KernelAttnClassifier as JAttn  # noqa: E402
from repro_torch.core import dropout as t_drop  # noqa: E402
from repro_torch.core import invariant as t_inv  # noqa: E402
from repro_torch.core import submodel as t_sub  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import partition as t_part  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.fl import client as t_client  # noqa: E402
from repro_torch.fl import fleet as t_fleet  # noqa: E402
from repro_torch.fl import simulation as t_simu  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.kernel_models import KERNEL_MODELS  # noqa: E402
from repro_torch.models.kernel_models import KernelAttnClassifier as TAttn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPECS = JAttn.UNIT_SPECS
N_CLIENTS, N_DATA, ROUNDS = 4, 240, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these many small CPU ops: the suite runs in
    several worker processes, and per-op thread pools would oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(jtree, ttree, atol, rtol=0.0):
    ja, ta = jax.tree.leaves(jtree), tree_leaves(ttree)
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(),
                                   atol=atol, rtol=rtol)


def _jax_params(seed=0):
    return _np_tree(JAttn.init(jax.random.PRNGKey(seed)))


def _keep_maps(seed):
    """A random rate-0.75 keep-map (3 of 4 heads) and an ordered rate-0.5
    one (2 heads, the first 128 FFN neurons)."""
    return (j_drop.get_policy("random", SPECS, seed=seed).keep_map(0.75),
            j_drop.get_policy("ordered", SPECS).keep_map(0.5))


# ---------------------------------------------------------------------------
# the model

def test_model_contract_matches_reference():
    assert TAttn.UNIT_SPECS == JAttn.UNIT_SPECS
    assert KERNEL_MODELS["kernel_attn"] is TAttn
    for f in ("num_classes", "input_shape", "d", "n_heads", "head_dim", "hidden"):
        assert getattr(TAttn, f) == getattr(JAttn, f)
    want = _jax_params()
    got = TAttn.init(0, device="cpu")
    assert [t.shape for t in tree_leaves(got)] == [a.shape for a in jax.tree.leaves(want)]
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):   # the same scales
        assert b.dtype == torch.float32
        assert float(b.std()) == pytest.approx(float(np.std(a)), rel=0.2, abs=1e-9)
    x = np.random.RandomState(0).rand(3, 2, 28, 28, 1).astype(np.float32)
    np.testing.assert_array_equal(TAttn._patches(torch.from_numpy(x)).numpy(),
                                  np.stack([np.asarray(JAttn._patches(v)) for v in x]))


def test_apply_matches_reference():
    params = _jax_params()
    x = np.random.RandomState(1).rand(6, 28, 28, 1).astype(np.float32)
    want = np.asarray(JAttn.apply(jax.tree.map(jnp.asarray, params), x))
    got = TAttn.apply(params_from_numpy(params, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_apply_kernels_matches_reference(masked):
    """Two clients, one on a 3-of-4-heads keep-map, one on the ordered 0.5
    one; on masked params the kernel path also equals the dense one."""
    rng = np.random.RandomState(2)
    base = _jax_params()
    stacked = jax.tree.map(lambda a: np.stack(
        [a, (a + 0.05 * rng.randn(*a.shape)).astype(np.float32)]), base)
    masks = [_np_tree(j_sub.keep_mask(base, SPECS, km)) for km in _keep_maps(4)]
    mtree = jax.tree.map(lambda *m: np.stack(m), *masks)
    if masked:
        stacked = jax.tree.map(lambda p, m: p * m, stacked, mtree)
    x = rng.rand(2, 3, 28, 28, 1).astype(np.float32)
    jkm = jax.vmap(JAttn.kernel_masks)(mtree)
    want = np.asarray(jax.vmap(lambda p, xb, km: JAttn.apply_kernels(
        p, xb, km, interpret=True))(stacked, x, jkm))
    tparams = params_from_numpy(stacked, device="cpu")
    tkm = TAttn.kernel_masks(params_from_numpy(mtree, device="cpu"))
    for g in ("heads", "ffn"):
        np.testing.assert_array_equal(tkm[g].numpy(), np.asarray(jkm[g]))
    got = TAttn.apply_kernels(tparams, torch.from_numpy(x), tkm)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if masked:
        for c in range(2):
            dense = TAttn.apply(tree_map(lambda p: p[c], tparams), torch.from_numpy(x[c]))
            np.testing.assert_allclose(got[c].numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the "heads" group (tile -16) in the sub-model and invariant modules

def test_keep_mask_apply_mask_extract_embed_match():
    params = _jax_params()
    tparams = params_from_numpy(params, device="cpu")
    for km in _keep_maps(2):
        jm = j_sub.keep_mask(params, SPECS, km)
        tm = t_sub.keep_mask(tparams, SPECS, km)
        _close(jm, tm, atol=0)
        kept_cols = np.repeat(np.isin(np.arange(4), km["heads"]), 16)
        for k in ("wq", "wk", "wv"):       # unit-major: a head owns 16 columns
            np.testing.assert_array_equal(tm["attn"][k].numpy().max(0), kept_cols)
        np.testing.assert_array_equal(tm["attn"]["wo"].numpy().max(1), kept_cols)
        _close(j_sub.apply_mask(params, jm), t_sub.apply_mask(tparams, tm), atol=0)
        jsub = j_sub.extract(params, SPECS, km)
        tsub = t_sub.extract(tparams, SPECS, km)
        _close(jsub, tsub, atol=0)
        assert tsub["attn"]["wq"].shape == (64, 16 * len(km["heads"]))
        jd, jm2 = j_sub.embed_delta(jsub, params, SPECS, km)
        td, tm2 = t_sub.embed_delta(tsub, tparams, SPECS, km)
        _close(jd, td, atol=0)
        _close(jm2, tm2, atol=0)


def test_neuron_stats_heads_group_match():
    rng = np.random.RandomState(4)
    prev = _jax_params()
    new = jax.tree.map(lambda a: (a + 0.01 * rng.randn(*a.shape)).astype(np.float32),
                       prev)
    new["attn"]["wk"][:, 16:32] = prev["attn"]["wk"][:, 16:32]   # head 1 of wk still
    want = j_inv.neuron_stats(prev, new, SPECS)
    got = t_inv.neuron_stats(params_from_numpy(prev, device="cpu"),
                             params_from_numpy(new, device="cpu"), SPECS)
    assert got["heads"].shape == (4,) and got["ffn"].shape == (256,)
    for g in want:
        np.testing.assert_allclose(got[g].numpy(), np.asarray(want[g]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["random", "ordered", "invariant"])
def test_heads_keep_count_at_paper_rates(policy):
    a = j_drop.get_policy(policy, SPECS, seed=1)
    b = t_drop.get_policy(policy, SPECS, seed=1)
    rng = np.random.RandomState(6)
    stats = [{g["name"]: (np.abs(rng.randn(g["size"])) * 0.01).astype(np.float32)
              for g in SPECS} for _ in range(3)]
    th = float(np.median(np.concatenate([s["heads"] for s in stats])))
    a.observe([{g: jnp.asarray(v) for g, v in s.items()} for s in stats], th)
    b.observe([{g: torch.from_numpy(v) for g, v in s.items()} for s in stats], th)
    for r, n_heads in ((0.5, 2), (0.65, 3), (0.75, 3), (0.85, 3), (0.95, 4), (1.0, 4)):
        ka, kb = a.keep_map(r), b.keep_map(r)
        assert len(kb["heads"]) == n_heads
        for g in ka:
            np.testing.assert_array_equal(kb[g], ka[g])


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
    km0, km2 = _keep_maps(6)
    keep_maps, rates = {0: km0, 2: km2}, {0: 0.75, 2: 0.5}
    jeng = j_fleet.FleetEngine(JAttn, _fresh_clients(j_client), SPECS,
                               use_kernels=True)
    teng = t_fleet.FleetEngine(TAttn, _fresh_clients(t_client), SPECS,
                               use_kernels=True, device="cpu")
    assert teng.steps == jeng.steps and teng.bs == jeng.bs
    jr = jeng.run_cohort(jax.tree.map(jnp.asarray, params), keep_maps, rates)
    tparams = params_from_numpy(params, device="cpu")
    tr = teng.run_cohort(tparams, keep_maps, rates)
    _close(jr.deltas, tr.deltas, atol=1e-4)
    for c, km in keep_maps.items():        # a dropped head's delta is exactly 0
        for h in set(range(4)) - set(km["heads"]):
            for k in ("wq", "wk", "wv"):
                assert not tr.deltas["attn"][k][c][:, 16 * h:16 * h + 16].any()
            assert not tr.deltas["attn"]["wo"][c][16 * h:16 * h + 16].any()
    assert tr.sim_times == jr.sim_times
    np.testing.assert_array_equal(tr.mask_idx.numpy(), np.asarray(jr.mask_idx))
    _close(jr.mask_bank, tr.mask_bank, atol=0)
    _close(jr.aggregate(params), tr.aggregate(tparams), atol=1e-4)
    for a, b in zip(jr.non_straggler_stats(params), tr.non_straggler_stats(tparams)):
        for g in ("heads", "ffn"):
            np.testing.assert_allclose(b[g].numpy(), a[g], rtol=1e-3, atol=1e-6)


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
    kw = dict(workload="femnist_attn", backend="fleet", use_kernels=True,
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
    assert any(len(km["heads"]) < 4 for r in tkm for km in r.values())
    for a, b, ka, kb in zip(jhist, thist, jkm, tkm):
        assert b.stragglers == a.stragglers
        assert b.rates == a.rates
        assert b.round_time == a.round_time
        assert kb.keys() == ka.keys()
        for cid in ka:
            assert kb[cid].keys() == ka[cid].keys() == {"heads", "ffn"}
            for g in ka[cid]:
                np.testing.assert_array_equal(kb[cid][g], ka[cid][g])
        assert abs(b.accuracy - a.accuracy) <= 1 / 400 + 1e-9
        assert b.threshold == pytest.approx(a.threshold, rel=1e-5)
    _close(jsim.server.params, tsim.server.params, atol=5e-4)
    np.testing.assert_array_equal(tsim.store.speed_hist,
                                  np.asarray(jsim.store.speed_hist))


# ---------------------------------------------------------------------------
# configuration and hygiene

def test_femnist_attn_config_and_launches_on_cpu():
    cfg = t_simu.SimulationConfig(workload="femnist_attn", backend="fleet",
                                  use_kernels=True, device="cpu",
                                  cohort=t_simu.CohortConfig(n_clients=2, n_data=60))
    assert t_simu.WORKLOADS["femnist_attn"] == ("femnist", "kernel_attn", 0.02, 10)
    assert t_simu.WORKLOADS == j_simu.WORKLOADS
    ops.reset_launch_counts()
    sim, hist = t_simu.run_experiment(cfg, rounds=1)
    assert isinstance(sim.server.params["attn"]["wq"], torch.Tensor)
    assert set(ops.launch_counts().values()) == {0}     # plain versions only
    cfg = t_simu.SimulationConfig(workload="femnist_attn", backend="sharded_fleet",
                                  n_shards=2, device="cpu",
                                  cohort=t_simu.CohortConfig(n_clients=2, n_data=60))
    sim = t_simu.build_simulation(cfg)
    assert sim.server.backend.engine.n_shards == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_simu.SimulationConfig(workload="femnist_attn", backend="fleet",
                                    use_kernels=True)


def test_attn_slice_runs_without_jax():
    code = ("import sys\n"
            "from repro_torch.fl.simulation import run_experiment, SimulationConfig, CohortConfig\n"
            "cfg = SimulationConfig(workload='femnist_attn', backend='fleet', use_kernels=True,\n"
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
