"""The port's population layer against the JAX reference, on the CPU.

``repro_torch.fl.population`` (the ClientStore's sampling and in-flight
flags, ``population_speeds``, ``PopulationSim``, ``build_population``),
``fl/shard_fleet.py``, the fleet's ``lr`` / ``n_steps`` / ``members``
overrides and ``SimClient.tail_sigma`` get the same inputs as their
reference counterparts: numpy seeds, the reference's initial params
through ``interop.params_from_numpy``, and the reference's Gumbel field
(``jax.random.gumbel`` of ``fold_in(PRNGKey(seed), round)``) handed to the
port through ``PopulationSim.cohort_noise``, so both sample the same
cohorts. Cohorts, stragglers, rates, keep-maps, round times and store
arrays must match exactly; params within 5e-4, the reference's own
fleet-vs-sequential tolerance. The reference runs its Pallas kernels in
interpret mode; the port runs their plain versions.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import straggler as j_strag  # noqa: E402
from repro.fl import client as j_client  # noqa: E402
from repro.fl import fleet as j_fleet  # noqa: E402
from repro.fl import population as j_pop  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data import partition as t_part  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.fl import client as t_client  # noqa: E402
from repro_torch.fl import fleet as t_fleet  # noqa: E402
from repro_torch.fl import population as t_pop  # noqa: E402
from repro_torch.fl import rounds as t_rounds  # noqa: E402
from repro_torch.fl import shard_fleet as t_shard  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import small as t_small  # noqa: E402

STORE_FIELDS = ("speed", "speed_ema", "speed_hist", "straggler_ema",
                "dropout_rate", "data_shard", "rounds_participated",
                "active", "in_flight")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_noise(seed, n):
    """The reference's per-round Gumbel field, as ``cohort_noise``."""
    base = jax.random.PRNGKey(seed)
    cache = {}

    def noise(rnd):
        if rnd not in cache:
            g = jax.random.gumbel(jax.random.fold_in(base, rnd), (n,),
                                  jnp.float32)
            cache[rnd] = torch.from_numpy(np.array(g))
        return cache[rnd]
    return noise


def _close(jtree, ttree, atol):
    assert jax.tree.structure(jtree).num_leaves == len(tree_leaves(ttree))
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        np.testing.assert_allclose(b.detach().cpu().numpy(), np.asarray(a),
                                   atol=atol, rtol=0)


def assert_same_store(js, ts):
    for f in STORE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, f),
                                      np.asarray(getattr(js, f)), err_msg=f)


def assert_same_policy(jsrv, tsrv):
    """Every keep-map the policy would hand a straggler agrees exactly."""
    for r in j_strag.DEFAULT_SIZES[:-1]:
        jk, tk = jsrv.policy.keep_map(r), tsrv.policy.keep_map(r)
        assert jk.keys() == tk.keys()
        for g in jk:
            np.testing.assert_array_equal(tk[g], np.asarray(jk[g]))


def assert_same_logs(jh, th):
    assert len(jh) == len(th)
    for a, b in zip(jh, th):
        assert b.round_time == a.round_time
        assert b.stragglers == a.stragglers and b.rates == a.rates
        assert b.clock == a.clock
        assert (b.staleness_mean, b.staleness_max) == (a.staleness_mean,
                                                       a.staleness_max)
        assert b.threshold == pytest.approx(a.threshold, rel=1e-5)


def twin_populations(jcfg, tdev="cpu"):
    """The reference's population and the port's from the same config,
    params and cohort noise."""
    jsim = j_pop.build_population(jcfg)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg) if f.name != "async_cfg"}
    tcfg = t_pop.PopulationConfig(**fields, device=tdev)
    params = params_from_numpy(jax.tree.map(np.asarray, jsim.server.params),
                               device=tdev)
    return jsim, tcfg, params


# ---------------------------------------------------------------------------
# pure pieces

@pytest.mark.parametrize("n,frac,seed", [(1000, 0.1, 0), (10_000, 0.2, 42),
                                         (37, 0.0, 3)])
def test_population_speeds_bitwise(n, frac, seed):
    np.testing.assert_array_equal(
        t_pop.population_speeds(n, frac, seed=seed),
        j_pop.population_speeds(n, frac, seed=seed))


def _stores(n=400, seed=5):
    rng = np.random.RandomState(seed)
    speeds = j_pop.population_speeds(n, seed=seed)
    shards = rng.randint(0, 16, n)
    active = np.sort(rng.choice(n, n * 3 // 4, replace=False))
    js = j_pop.ClientStore.empty(n).register(active, speeds[active],
                                             shards[active])
    ts = t_pop.ClientStore.empty(n).register(active, speeds[active],
                                             shards[active])
    return js, ts, active


def test_store_views_and_in_flight_match():
    js, ts, active = _stores()
    assert ts.capacity == js.capacity == 400
    assert ts.n_active == js.n_active == active.size
    fly = active[::3]
    js, ts = js.mark_in_flight(fly, True), ts.mark_in_flight(fly, True)
    assert_same_store(js, ts)
    ids = np.array([3, 0, 399, 17, 17])
    np.testing.assert_array_equal(ts.speeds_of(ids), js.speeds_of(ids))
    np.testing.assert_array_equal(ts.shards_of(ids), js.shards_of(ids))
    js, ts = (js.mark_in_flight(fly[:5], False),
              ts.mark_in_flight(fly[:5], False))
    assert_same_store(js, ts)


@pytest.mark.parametrize("available_only", [False, True])
@pytest.mark.parametrize("size", [1, 40, 190])
def test_sample_cohort_matches_on_the_same_field(available_only, size):
    js, ts, active = _stores()
    js, ts = (js.mark_in_flight(active[::3], True),
              ts.mark_in_flight(active[::3], True))
    for rnd in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(9), rnd)
        noise = ref_noise(9, js.capacity)(rnd)
        want = np.asarray(js.sample_cohort(key, size, available_only))
        got = ts.sample_cohort(noise, size, available_only)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and np.all(np.diff(got) > 0)
        assert ts.active[got].all()
        if available_only:
            assert not ts.in_flight[got].any()


def test_sample_cohort_refuses_more_than_the_pool():
    js, ts, active = _stores()
    ts = ts.mark_in_flight(active[:100], True)
    noise = t_pop.gumbel_field(0, 0, ts.capacity)
    assert ts.sample_cohort(noise, active.size).size == active.size
    with pytest.raises(ValueError, match="active"):
        ts.sample_cohort(noise, active.size + 1)
    with pytest.raises(ValueError, match="available"):
        ts.sample_cohort(noise, active.size - 99, available_only=True)
    with pytest.raises(ValueError, match="active"):
        js.sample_cohort(jax.random.PRNGKey(0), active.size + 1)


def test_gumbel_field_is_seeded_and_standard():
    a, b = t_pop.gumbel_field(3, 7, 50_000), t_pop.gumbel_field(3, 7, 50_000)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, t_pop.gumbel_field(3, 8, 50_000))
    assert not torch.equal(a, t_pop.gumbel_field(4, 7, 50_000))
    assert bool(torch.isfinite(a).all())
    assert abs(float(a.mean()) - 0.5772) < 0.02          # Euler's gamma
    assert abs(float(a.var()) - np.pi ** 2 / 6) < 0.05


@pytest.mark.parametrize("tail_sigma", [0.0, 0.6])
def test_sim_client_tail_sigma_draws_like_reference(tail_sigma):
    x, y = np.zeros((40, 32), np.float32), np.zeros(40, np.int32)
    kw = dict(speed=10.0, tail_sigma=tail_sigma, seed=11)
    jc = j_client.FleetClient(-3, None, x, y, **kw)
    tc = t_client.FleetClient(-3, None, x, y, **kw)
    for rate, n in ((1.0, 1000), (0.5, 400), (0.75, 12345)):
        np.testing.assert_array_equal(tc.local_batches()[0],
                                      jc.local_batches()[0])
        assert tc.draw_sim_time(rate, n) == jc.draw_sim_time(rate, n)


def test_sim_client_without_tail_keeps_its_stream():
    """tail_sigma 0 draws nothing extra: the stream is the untailed one."""
    x, y = np.zeros((40, 32), np.float32), np.zeros(40, np.int32)
    a = t_client.FleetClient(2, None, x, y, speed=10.0)
    b = t_client.FleetClient(2, None, x, y, speed=10.0, tail_sigma=0.6)
    assert a.draw_sim_time(1.0, 10) != b.draw_sim_time(1.0, 10)
    assert a._rng.randn() != b._rng.randn()     # b drew one more normal


# ---------------------------------------------------------------------------
# the fleet's overrides

def _synth_clients(mod, model_cls, n=6, n_data=240):
    ds = t_syn.make_dataset("synth", n=n_data, n_test=40, n_partitions=16)
    parts = t_part.partition_non_iid(ds, n)
    return [mod.FleetClient(i, model_cls, ds.x[parts[i]], ds.y[parts[i]],
                            speed=10.0 + i, batch_size=20, lr=0.05,
                            tail_sigma=0.3, seed=4)
            for i in range(n)]


def test_fleet_overrides_match_reference():
    from repro.models import small as j_small
    jparams = jax.tree.map(np.asarray, jax.jit(j_small.SynthMLP.init)(
        jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jparams, device="cpu")
    specs = t_small.SynthMLP.UNIT_SPECS
    from repro.core import dropout as j_drop
    km = {1: j_drop.get_policy("random", specs, seed=3).keep_map(0.5)}
    je = j_fleet.FleetEngine(j_small.SynthMLP,
                             _synth_clients(j_client, j_small.SynthMLP), specs)
    te = t_fleet.FleetEngine(t_small.SynthMLP,
                             _synth_clients(t_client, t_small.SynthMLP), specs,
                             device="cpu")
    np.testing.assert_array_equal(te.client_steps, je.client_steps)
    lr = np.array([0.05, 0.02, 0.1, 0.05, 0.01, 0.07], np.float32)
    n_steps = np.array([2, 1, 0, 3, 2, 1])
    members = np.array([True, True, True, False, True, False])
    jr = je.run_cohort(jax.tree.map(jnp.asarray, jparams), km, {1: 0.5},
                       lr=lr, n_steps=n_steps, members=members)
    tr = te.run_cohort(tparams, km, {1: 0.5}, lr=lr, n_steps=n_steps,
                       members=members)
    assert tr.sim_times == jr.sim_times
    assert sorted(tr.sim_times) == [0, 1, 2, 4]          # pads draw nothing
    _close(jr.deltas, tr.deltas, atol=2e-6)
    for i in [*np.flatnonzero(~members), 2]:             # pads, and 0 steps
        assert all(not bool(d[i].any()) for d in tree_leaves(tr.deltas))
    np.testing.assert_array_equal(tr.weights.numpy(), np.asarray(jr.weights))
    assert [u.client_id for u in tr.updates()] == [0, 1, 2, 4]
    js, ts = jr.non_straggler_stats(jparams), tr.non_straggler_stats(tparams)
    assert len(ts) == len(js) == 3                       # 0, 2, 4
    for a, b in zip(js, ts):
        for g in a:
            np.testing.assert_allclose(b[g].numpy(), np.asarray(a[g]),
                                       rtol=1e-3, atol=1e-6)
    _close(jr.aggregate(jparams), tr.aggregate(tparams), atol=2e-6)
    with pytest.raises(ValueError, match="members"):
        te.run_cohort(tparams, {}, {}, members=members[:3])
    with pytest.raises(ValueError, match="n_steps"):
        te.run_cohort(tparams, {}, {}, n_steps=n_steps[:3])


# ---------------------------------------------------------------------------
# population runs against the reference

def _pop_cfg(**over):
    kw = dict(n_clients=10_000, cohort_size=8, workload="synth",
              backend="fleet", n_partitions=16, samples_per_partition=40,
              seed=42)
    kw.update(over)
    return j_pop.PopulationConfig(**kw)


def run_twins(jcfg, rounds, drift_at=None):
    """Run both populations ``rounds`` rounds from the same params and
    noise; before round ``drift_at`` a sampled non-straggler of the next
    cohort slows to 2x base in both. Checks every round's cohort, plan,
    round time, store and keep-maps; returns both sims."""
    jsim, tcfg, params = twin_populations(jcfg)
    tsim = t_pop.build_population(tcfg, params=params)
    tsim.cohort_noise = ref_noise(jcfg.seed, jcfg.n_clients)
    for r in range(rounds):
        if r == drift_at:
            ids = jsim.cohort_ids(r)
            calm = [int(c) for c in ids if jsim.store.rates_of([c])[0] == 1.0]
            jsim.set_speed(calm[0], 2 * jcfg.base_speed)
            tsim.set_speed(calm[0], 2 * jcfg.base_speed)
        np.testing.assert_array_equal(tsim.cohort_ids(), jsim.cohort_ids())
        jsim.run_round(eval_now=r == rounds - 1)
        tsim.run_round(eval_now=r == rounds - 1)
        assert_same_store(jsim.store, tsim.store)
        assert_same_policy(jsim.server, tsim.server)
    assert_same_logs(jsim.server.history, tsim.server.history)
    return jsim, tsim


@pytest.mark.parametrize("backend", ["sequential", "fleet", "sharded_fleet"])
def test_population_run_matches_reference(backend):
    jsim, tsim = run_twins(_pop_cfg(
        backend=backend, n_shards=2 if backend == "sharded_fleet" else None),
        rounds=4, drift_at=2)
    assert any(h.stragglers for h in tsim.server.history)
    engine = {"sequential": t_rounds.SequentialBackend,
              "fleet": t_rounds.FleetBackend,
              "sharded_fleet": t_rounds.ShardedFleetBackend}[backend]
    be = t_rounds.make_backend(backend, tsim.model_cls,
                               tsim._materialize(tsim.cohort_ids()),
                               tsim.model_cls.UNIT_SPECS, n_shards=2,
                               device="cpu")
    assert type(be) is engine
    _close(jsim.server.params, tsim.server.params, atol=5e-4)
    h = tsim.server.history[-1]
    assert h.accuracy == pytest.approx(jsim.server.history[-1].accuracy,
                                       abs=1e-2)


def test_kernel_population_matches_reference():
    """femnist_kernel through the kernels' plain versions against the
    reference's Pallas kernels in interpret mode."""
    jsim, tsim = run_twins(_pop_cfg(
        n_clients=300, cohort_size=4, workload="femnist_kernel",
        n_partitions=8, samples_per_partition=20, use_kernels=True), 2)
    assert tsim.cfg.use_kernels
    _close(jsim.server.params, tsim.server.params, atol=5e-4)


def test_sharded_partials_sum_to_num_bitwise():
    cfg = t_pop.PopulationConfig(**{**dataclasses.asdict(_pop_cfg(
        n_clients=2000, backend="sharded_fleet", n_shards=4)),
        "device": "cpu"})
    sim = t_pop.build_population(cfg)
    sim.run(2)
    clients = sim._materialize(sim.cohort_ids())
    be = t_rounds.make_backend("sharded_fleet", sim.model_cls, clients,
                               sim.model_cls.UNIT_SPECS, n_shards=4,
                               device="cpu")
    rates = {c.id: 0.5 for c in clients[::3]}
    km = {c: sim.server.policy.keep_map(r) for c, r in rates.items()}
    res = be.run_round(sim.server.params, km, rates)
    pr_num, pr_w = res.shard_partials
    assert pr_w.shape == (4, tree_leaves(res.mask_bank)[0].shape[0])
    num = tree_map(lambda a: ((a[0] + a[1]) + a[2]) + a[3], pr_num)
    for x, y in zip(tree_leaves(num), tree_leaves(res.num)):
        assert torch.equal(x, y)
    assert torch.equal(((pr_w[0] + pr_w[1]) + pr_w[2]) + pr_w[3],
                       res.w_per_mask)
    dense = t_fleet.CohortResult.aggregate(res, sim.server.params)
    for x, y in zip(tree_leaves(res.aggregate(sim.server.params)),
                    tree_leaves(dense)):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="divide evenly"):
        t_shard.ShardedFleetEngine(sim.model_cls, clients[:6],
                                   sim.model_cls.UNIT_SPECS, n_shards=4,
                                   device="cpu")


def test_population_config_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pop.PopulationConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pop.PopulationConfig(backend="async", device="cuda:0")


@pytest.mark.parametrize("kw,match", [
    (dict(backend="bogus"), "backend"),
    (dict(backend="fleet", async_cfg=object()), "async_cfg"),
    (dict(backend="async", n_shards=2), "does not shard"),
])
def test_build_population_refuses_bad_configs(kw, match):
    with pytest.raises(ValueError, match=match):
        t_pop.build_population(t_pop.PopulationConfig(device="cpu", **kw))


@pytest.mark.parametrize("model", ["kernel_mlp", "kernel_attn", "femnist_cnn",
                                   "synth_mlp"])
def test_stacked_stats_match_per_client_stats(model):
    """The fleet's batched invariant stats against one neuron_stats call
    a client (the reference's per-client form) on the selected rows."""
    from repro_torch.core import invariant as t_inv
    from repro_torch.models.kernel_models import KERNEL_MODELS
    cls = {**t_small.MODELS, **KERNEL_MODELS}[model]
    p = cls.init(0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    deltas = tree_map(lambda t: 1e-3 * torch.randn((6, *t.shape), generator=gen), p)
    rows = torch.tensor([0, 2, 5])
    got = t_inv.neuron_stats(p, tree_map(lambda a, d: a + d[rows], p, deltas),
                             cls.UNIT_SPECS)
    for j, i in enumerate(rows.tolist()):
        want = t_inv.neuron_stats(p, tree_map(lambda a, d: a + d[i], p, deltas),
                                  cls.UNIT_SPECS)
        assert got.keys() == want.keys()
        for g in want:
            torch.testing.assert_close(got[g][j], want[g], rtol=1e-6, atol=0)
