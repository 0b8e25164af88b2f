"""The port's async buffered rounds against the JAX reference, on the CPU.

``repro_torch.fl.async_rounds`` (AsyncConfig, the buffered backend,
AsyncPopulationSim), the ``EventLoop``, ``ArrivalModel``,
``staleness_scale`` / ``aggregate_buffered`` and ``launch/async_fl`` get
the inputs their reference counterparts get: numpy seeds, the reference's
initial params and its Gumbel cohort field (tests/test_torch_population.py
``ref_noise``). The clock, arrivals, staleness, stragglers, rates,
keep-maps, round times and store arrays must match exactly, params within
5e-4. Within the port, what the reference pins bitwise stays bitwise: a
zero-spread async run equals the fleet run, and a uniformly stale buffer
aggregates like ``aggregate_stacked``.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.aggregate import aggregate_buffered as j_aggregate_buffered  # noqa: E402
from repro.core.aggregate import staleness_scale as j_staleness_scale  # noqa: E402
from repro.core import straggler as j_strag  # noqa: E402
from repro.fl import async_rounds as j_async  # noqa: E402
from repro.fl import population as j_pop  # noqa: E402
from repro.fl import rounds as j_rounds  # noqa: E402
from repro.launch import async_fl as j_launch  # noqa: E402
from repro_torch.core import aggregate as t_agg  # noqa: E402
from repro_torch.core import straggler as t_strag  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.fl import async_rounds as t_async  # noqa: E402
from repro_torch.fl import population as t_pop  # noqa: E402
from repro_torch.fl import rounds as t_rounds  # noqa: E402
from repro_torch.fl import simulation as t_simu  # noqa: E402
from repro_torch.launch import async_fl as t_launch  # noqa: E402
from test_torch_population import (STORE_FIELDS, _close,  # noqa: E402
                                   assert_same_logs, assert_same_policy,
                                   assert_same_store, ref_noise,
                                   twin_populations)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# pure pieces

def test_event_loop_matches_reference():
    events = [(5.0, "a"), (1.0, "b"), (5.0, "c"), (0.5, "d"), (5.0, "e")]
    jl, tl = j_rounds.EventLoop(), t_rounds.EventLoop()
    for t, p in events:
        jl.push(t, p)
        tl.push(t, p)
    got = [tl.pop() for _ in range(3)]
    assert got == [jl.pop() for _ in range(3)]
    assert [p for _, p in got] == ["d", "b", "a"]          # ties: push order
    assert tl.now == jl.now == 5.0
    tl.push(2.0, "late")                 # scheduled before now: no rewind
    jl.push(2.0, "late")
    assert tl.pop() == jl.pop() == (2.0, "late")
    assert tl.now == 5.0 and len(tl) == len(jl) == 2
    assert [tl.pop()[1] for _ in range(2)] == ["c", "e"]


@pytest.mark.parametrize("tail_sigma,drop_prob", [(0.0, 0.0), (0.6, 0.0),
                                                  (0.0, 0.3), (0.6, 0.3)])
def test_arrival_model_draws_exactly_like_reference(tail_sigma, drop_prob):
    kw = dict(tail_sigma=tail_sigma, drop_prob=drop_prob,
              reconnect_mean=25.0, max_drops=3, seed=7)
    jm, tm = j_strag.ArrivalModel(**kw), t_strag.ArrivalModel(**kw)
    bases = np.random.RandomState(1).uniform(1.0, 30.0, 200)
    got = [tm.draw(float(b)) for b in bases]
    assert got == [jm.draw(float(b)) for b in bases]
    if tail_sigma == drop_prob == 0.0:
        assert got == [(float(b), 0) for b in bases]       # pass-through
        assert np.array_equal(tm._rng.get_state()[1],
                              np.random.RandomState(7).get_state()[1])
    if drop_prob:
        assert any(d for _, d in got) and max(d for _, d in got) <= 3


def test_config_validation_matches_reference():
    for mod in (t_async, j_async):
        with pytest.raises(ValueError, match="buffer_k"):
            mod.AsyncConfig(buffer_k=0)
        with pytest.raises(ValueError, match="concurrency"):
            mod.AsyncConfig(buffer_k=8, concurrency=4)
        with pytest.raises(ValueError, match="staleness_exponent"):
            mod.AsyncConfig(staleness_exponent=-0.1)
    for mod in (t_strag, j_strag):
        with pytest.raises(ValueError, match="drop_prob"):
            mod.ArrivalModel(drop_prob=1.0)
        with pytest.raises(ValueError, match="tail_sigma"):
            mod.ArrivalModel(tail_sigma=-1.0)


def test_staleness_scale_identities_and_reference():
    ones = lambda n: torch.ones(n)                          # noqa: E731
    assert torch.equal(t_agg.staleness_scale(np.zeros(4, np.float32), 0.5),
                       ones(4))
    assert torch.equal(t_agg.staleness_scale(np.full(5, 7.0, np.float32), 0.5),
                       ones(5))
    assert torch.equal(t_agg.staleness_scale(
        np.asarray([0., 5., 2.], np.float32), 0.0), ones(3))
    s = t_agg.staleness_scale(np.asarray([0., 1., 3.], np.float32), 0.5)
    assert s[0] == 1.0 and s[0] > s[1] > s[2] > 0.0
    rng = np.random.RandomState(0)
    for a in (0.0, 0.5, 1.7):
        st = rng.randint(0, 9, 16).astype(np.float32)
        np.testing.assert_allclose(
            t_agg.staleness_scale(st, a).numpy(),
            np.asarray(j_staleness_scale(st, a)), rtol=1e-6)


def _stacked_case(seed=0):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(6, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    mask = {"w": (rng.rand(6, 4) > 0.5).astype(np.float32),
            "b": (rng.rand(4) > 0.5).astype(np.float32)}
    bank = {k: np.stack([np.ones_like(params[k]), mask[k]]) for k in params}
    deltas = {k: rng.randn(3, *params[k].shape).astype(np.float32)
              for k in params}
    for k in deltas:                  # client 1 is the straggler
        deltas[k][1] *= mask[k]
    idx = np.asarray([0, 1, 0], np.int32)
    weights = np.asarray([20.0, 10.0, 30.0], np.float32)
    return params, deltas, weights, bank, idx


def _torch_case(case):
    params, deltas, weights, bank, idx = case
    to = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}  # noqa: E731
    return (to(params), to(deltas), torch.from_numpy(weights), to(bank),
            torch.from_numpy(idx).long())


def test_aggregate_buffered_matches_reference():
    case = _stacked_case()
    jcase = [jax.tree.map(jnp.asarray, c) for c in case]
    for stale in ([0., 4., 0.], [2., 0., 1.], [3., 3., 3.]):
        s = np.asarray(stale, np.float32)
        for a in (0.5, 1.0):
            want = j_aggregate_buffered(*jcase, s, a)
            got = t_agg.aggregate_buffered(*_torch_case(case), s, a)
            for k in want:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), atol=1e-6)


def test_max_stale_buffer_is_plain_masked_fedavg_bitwise():
    tcase = _torch_case(_stacked_case())
    base = t_agg.aggregate_stacked(*tcase)
    for s in (0.0, 4.0):
        got = t_agg.aggregate_buffered(*tcase, np.full(3, s, np.float32), 0.5)
        assert all(torch.equal(base[k], got[k]) for k in base)
    mixed = t_agg.aggregate_buffered(*tcase, np.asarray([0., 4., 0.],
                                                        np.float32), 0.5)
    assert not all(torch.equal(base[k], mixed[k]) for k in base)


# ---------------------------------------------------------------------------
# async runs against the reference

def _pop_cfg(**over):
    kw = dict(n_clients=1500, cohort_size=8, workload="synth",
              backend="async", n_partitions=16, samples_per_partition=40,
              straggler_frac_pop=0.2, tail_sigma=0.6, seed=42)
    kw.update(over)
    return j_pop.PopulationConfig(**kw)


def twin_async(acfg_kw, rounds, **over):
    """The reference's async population and the port's, same params and
    noise; both run ``rounds`` buffers and every buffer is compared."""
    jcfg = _pop_cfg(async_cfg=j_async.AsyncConfig(
        arrival=j_strag.ArrivalModel(drop_prob=0.05, seed=42), **acfg_kw),
        **over)
    jsim, tcfg, params = twin_populations(jcfg)
    tcfg.async_cfg = t_async.AsyncConfig(
        arrival=t_strag.ArrivalModel(drop_prob=0.05, seed=42), **acfg_kw)
    tsim = t_pop.build_population(tcfg, params=params)
    assert isinstance(tsim, t_async.AsyncPopulationSim)
    tsim.cohort_noise = ref_noise(jcfg.seed, jcfg.n_clients)
    for _ in range(rounds):
        jsim.run_round()
        tsim.run_round()
        jb, tb = jsim.backend, tsim.backend
        assert tsim.clock == jsim.clock
        assert tb.last_arrived == jb.last_arrived
        np.testing.assert_array_equal(tb.last_result.staleness,
                                      jb.last_result.staleness)
        assert [a.drops for a in tb.last_result.arrivals] == \
            [a.drops for a in jb.last_result.arrivals]
        assert tb.in_flight_ids == jb.in_flight_ids
        assert (tb.n_dispatched, tb.total_drops) == (jb.n_dispatched,
                                                     jb.total_drops)
        assert_same_store(jsim.store, tsim.store)
        assert_same_policy(jsim.server, tsim.server)
        assert set(np.flatnonzero(tsim.store.in_flight)) == tb.in_flight_ids
    assert_same_logs(jsim.server.history, tsim.server.history)
    _close(jsim.server.params, tsim.server.params, atol=5e-4)
    return jsim, tsim


def test_async_k8_flash_crowd_matches_reference():
    """K 8, concurrency 16, a flash crowd of 10 at step 1: round 1
    dispatches 18 clients, the last group padded with 6 slots."""
    _, tsim = twin_async(dict(buffer_k=8, concurrency=16,
                              flash_crowds=((1, 10),)), 4)
    hist = tsim.server.history
    assert max(h.staleness_max for h in hist) > 0
    assert any(h.stragglers for h in hist)
    assert tsim.backend.n_dispatched == len(tsim.backend.in_flight_ids) + 4 * 8


def test_async_k1_streams_one_arrival_a_round_like_reference():
    _, tsim = twin_async(dict(buffer_k=1, concurrency=3), 4)
    be = tsim.backend
    assert be.n_dispatched == 3 + 3 and len(be.in_flight_ids) == 2
    assert int(tsim.store.rounds_participated.sum()) == 4


def test_zero_spread_async_equals_fleet_bitwise():
    """buffer_k = concurrency = cohort, pass-through arrivals, no client
    tail: the port's async run is its fleet run, bit for bit."""
    base = dict(n_clients=1500, cohort_size=8, workload="synth",
                n_partitions=16, samples_per_partition=40,
                straggler_frac_pop=0.2, seed=42, device="cpu")
    sync = t_pop.build_population(t_pop.PopulationConfig(backend="fleet",
                                                         **base))
    sync.run(4)
    asy = t_async.build_async_population(
        t_pop.PopulationConfig(**base),
        t_async.AsyncConfig(buffer_k=8, concurrency=8))
    asy.run(4)
    for a, b in zip(tree_leaves(sync.server.params),
                    tree_leaves(asy.server.params)):
        assert torch.equal(a, b)
    for f in STORE_FIELDS:
        assert np.array_equal(getattr(sync.store, f), getattr(asy.store, f),
                              equal_nan=True), f
    hs, ha = sync.server.history, asy.server.history
    assert [h.round_time for h in hs] == [h.round_time for h in ha]
    assert [h.stragglers for h in hs] == [h.stragglers for h in ha]
    assert [h.rates for h in hs] == [h.rates for h in ha]
    assert [h.threshold for h in hs] == [h.threshold for h in ha]
    assert all(h.staleness_max == 0.0 for h in ha)
    assert any(h.stragglers for h in hs)
    assert ha[-1].clock == pytest.approx(sum(h.round_time for h in hs))


def _sim_backend(n_clients, n_data, acfg):
    ssim = t_simu.build_simulation(t_simu.SimulationConfig(
        workload="femnist", backend="fleet", device="cpu",
        cohort=t_simu.CohortConfig(n_clients=n_clients, n_data=n_data)))
    be = t_rounds.make_backend("async", ssim.model_cls, ssim.clients,
                               ssim.model_cls.UNIT_SPECS, async_cfg=acfg,
                               device="cpu")
    return ssim, be


def test_make_backend_async_is_stateful_across_rounds():
    ssim, be = _sim_backend(4, 400, t_async.AsyncConfig(
        buffer_k=2, concurrency=2,
        arrival=t_strag.ArrivalModel(tail_sigma=0.4, seed=0)))
    assert isinstance(be, t_async.AsyncBufferedBackend)
    params = ssim.server.params
    r1 = be.run_round(params, {}, {})
    assert len(r1.sim_times) == 2 and be.version == 1
    assert np.all(r1.staleness == 0.0)
    r2 = be.run_round(params, {}, {})
    assert r2.clock >= r1.clock
    assert set(r1.sim_times) | set(r2.sim_times) <= {c.id for c in ssim.clients}
    new = r2.aggregate(params)
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(new))
    assert len(r2.updates()) == 2


def test_async_backend_refuses_unfillable_buffer():
    ssim, be = _sim_backend(2, 300, t_async.AsyncConfig(buffer_k=4,
                                                        concurrency=4))
    with pytest.raises(RuntimeError, match="cannot fill"):
        be.run_round(ssim.server.params, {}, {})


def test_async_population_refuses_concurrency_over_the_population():
    with pytest.raises(ValueError, match="exceeds the population"):
        t_pop.build_population(t_pop.PopulationConfig(
            n_clients=10, backend="async", device="cpu",
            async_cfg=t_async.AsyncConfig(buffer_k=4, concurrency=16)))


# ---------------------------------------------------------------------------
# the launcher

LAUNCH_ARGS = ["--clients", "400", "--cohort", "8", "--rounds", "3",
               "--partitions", "8", "--samples", "40", "--buffer-k", "4",
               "--concurrency", "8", "--drop-prob", "0.1",
               "--flash-crowd", "1:3", "--eval-every", "2"]


def _shape(text):
    return [re.sub(r"-?\d+(\.\d+)?", "#", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("backend", ["async", "fleet"])
def test_launch_async_fl_prints_the_reference_lines(backend, capsys):
    argv = LAUNCH_ARGS + ["--backend", backend]
    assert t_launch.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert j_launch.main(argv) == 0
    want = capsys.readouterr().out
    assert _shape(got) == _shape(want)
    assert len(got.splitlines()) == 4
    assert got.splitlines()[-1].startswith("done: 3 ")


def test_population_and_async_run_without_jax():
    code = ("import sys\n"
            "from repro_torch.launch import async_fl\n"
            "assert async_fl.main(['--device', 'cpu', '--clients', '300', '--rounds', '2',\n"
            "    '--buffer-k', '4', '--concurrency', '8', '--partitions', '4',\n"
            "    '--samples', '40', '--eval-every', '0']) == 0\n"
            "from repro_torch.fl.population import PopulationConfig, build_population\n"
            "sim = build_population(PopulationConfig(n_clients=500, cohort_size=4,\n"
            "    backend='sharded_fleet', n_shards=2, n_partitions=4,\n"
            "    samples_per_partition=40, device='cpu'))\n"
            "sim.run(2)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
