"""The paper's models (models/small.py) in the port against the JAX reference.

FemnistCNN, Vgg9, ShakespeareLSTM and SynthMLP get the reference's initial
params (carried over with ``interop.params_from_numpy``) and the same
numpy batch. Unit specs and param layouts must be identical; logits and
``make_loss`` gradients agree in fp32 to 1e-5 (XLA's and oneDNN's fp32
sums differ in order), for the full model and for a physically extracted
sub-model at rate 0.5 in every group, whose kept indices are scattered
(a random policy), so a wrong conv layout or flatten order shows.
``submodel_sizes`` is exact. Max pooling follows a ReLU in both CNNs, so
a tied window's gradient is zero whichever input takes it; the sub-model
gradients check that too. Exact ties route the gradient to the same
input in both frameworks (the first of the window in row-major order).

``SimClient.train``, the sequential backend's local SGD, gives the
reference's delta to 2e-5 and its sim time to rel 1e-12
(tests/test_fleet.py's tolerances), for a full client and a straggler's
sub-model, from the params the simulation starts from (``PRNGKey(0)``).
A *near* tie is another matter: from ``PRNGKey(1)``'s CNN params, one
batch of client 1 has a 2x2 window whose two largest conv2 outputs are
3.7119977 > 3.7119968 in the port (oneDNN) and 3.7119970 < 3.7119982 in
XLA. The fp32 sums order them differently, the gradient takes the other
input, and conv2's delta differs by 5.6e-5 after one local epoch. That is
max pooling's discontinuity meeting two correct fp32 sums, not a fault.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import dropout as j_drop  # noqa: E402
from repro.core import submodel as j_sub  # noqa: E402
from repro.fl import client as j_client  # noqa: E402
from repro.models import small as j_small  # noqa: E402
from repro_torch.core import submodel as t_sub  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data import partition as t_part  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.fl import client as t_client  # noqa: E402
from repro_torch.fl import simulation as t_simu  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import small as t_small  # noqa: E402

MODELS = tuple(j_small.MODELS)
BATCH = {"femnist_cnn": 8, "cifar_vgg9": 4, "shakespeare_lstm": 8,
         "synth_mlp": 16}
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(name, seed=0):
    rng = np.random.RandomState(seed)
    cls, n = j_small.MODELS[name], BATCH[name]
    if name == "shakespeare_lstm":
        x = rng.randint(0, cls.vocab, size=(n, cls.seq_len)).astype(np.int32)
    else:
        x = rng.randn(n, *cls.input_shape).astype(np.float32)
    return x, rng.randint(0, cls.num_classes, size=n).astype(np.int32)


@functools.cache
def _params(name, seed=1):
    """The reference's initial params as numpy (read only: callers copy)."""
    init = jax.jit(j_small.MODELS[name].init)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def _close(jtree, ttree, **tol):
    assert jax.tree.structure(jtree).num_leaves == len(tree_leaves(ttree))
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        assert tuple(np.shape(a)) == tuple(b.shape)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **tol)


def _keep_map(name):
    """Scattered kept indices, half of every group."""
    specs = j_small.MODELS[name].UNIT_SPECS
    return j_drop.get_policy("random", specs, seed=3).keep_map(0.5)


@pytest.mark.parametrize("name", MODELS)
def test_unit_specs_and_param_layout_match(name):
    jm, tm = j_small.MODELS[name], t_small.MODELS[name]
    assert tm.UNIT_SPECS == jm.UNIT_SPECS
    want = _params(name)
    got = tm.init(0, device="cpu")
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got, is_leaf=torch.is_tensor))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32
        if b.ndim == 1:
            assert not b.any()                       # biases start at zero
    again = tree_leaves(tm.init(0, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), again))


@pytest.mark.parametrize("sub", [False, True], ids=["full", "sub"])
@pytest.mark.parametrize("name", MODELS)
def test_logits_and_loss_grads_match(name, sub):
    jm, tm = j_small.MODELS[name], t_small.MODELS[name]
    params = _params(name)
    tparams = params_from_numpy(params, device="cpu")
    if sub:
        km = _keep_map(name)
        params = jax.tree.map(np.asarray, j_sub.extract(params, jm.UNIT_SPECS, km))
        tparams = t_sub.extract(tparams, tm.UNIT_SPECS, km)
        _close(params, tparams, atol=0, rtol=0)
    x, y = _batch(name)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    got = tm.apply(tparams, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jg = jax.jit(jax.grad(j_client.make_loss(jm)))(params, jnp.asarray(x),
                                                   jnp.asarray(y))
    leaves = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    loss = t_client.make_loss(tm)(tparams, torch.from_numpy(x), torch.from_numpy(y))
    tg = torch.autograd.grad(loss, leaves)
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_max_pool_routes_exact_ties_like_the_reference():
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, :2, :2] = 2.0                          # a 4-way tie
    x[0, 2, 3] = x[0, 3, 2] = 1.0               # a 2-way tie; one window all 0
    weights = np.arange(1.0, 5.0, dtype=np.float32).reshape(1, 2, 2, 1)
    want = jax.grad(lambda a: (j_small._pool(a) * weights).sum())(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    pooled = t_small._pool(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (pooled * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", MODELS)
def test_submodel_sizes_exact(name):
    specs = j_small.MODELS[name].UNIT_SPECS
    params = _params(name)
    tparams = params_from_numpy(params, device="cpu")
    for km in (_keep_map(name),
               j_drop.get_policy("ordered", specs).keep_map(0.75),
               j_drop.get_policy("ordered", specs).keep_map(1.0)):
        assert (t_sub.submodel_sizes(tparams, specs, km)
                == j_sub.submodel_sizes(params, specs, km))


def _client(mod, workload):
    """Client 1 of a 4-client ``workload`` simulation, built as _build does."""
    ds_name, model_name, lr, bs = t_simu.WORKLOADS[workload]
    ds = t_syn.make_dataset(ds_name, n=240, n_test=60, n_partitions=16)
    part = t_part.partition_non_iid(ds, 4)[1]
    models = j_small.MODELS if mod is j_client else t_small.MODELS
    return mod.SimClient(1, models[model_name], ds.x[part], ds.y[part],
                         speed=t_simu.default_speeds(4, (0,))[1],
                         batch_size=bs, lr=lr)


@pytest.mark.parametrize("straggler", [False, True], ids=["full", "straggler"])
@pytest.mark.parametrize("workload", ["femnist", "shakespeare", "synth"])
def test_simclient_train_matches_reference(workload, straggler):
    name = t_simu.WORKLOADS[workload][1]
    params = _params(name, seed=0)
    tparams = params_from_numpy(params, device="cpu")
    rate = 1.0
    if straggler:
        specs, rate = j_small.MODELS[name].UNIT_SPECS, 0.5
        params = jax.tree.map(np.asarray, j_sub.extract(params, specs,
                                                        _keep_map(name)))
        tparams = t_sub.extract(tparams, specs, _keep_map(name))
    jc, tc = _client(j_client, workload), _client(t_client, workload)
    for _ in range(2):                  # two rounds: the RNG stream carries on
        ju = jc.train(jax.tree.map(jnp.asarray, params), rate=rate)
        tu = tc.train(tparams, rate=rate)
        assert tu.sim_time == pytest.approx(ju.sim_time, rel=1e-12)
        assert (tu.n_samples, tu.client_id, tu.mask) == (ju.n_samples, 1, None)
        assert tu.real_time > 0
        _close(ju.delta, tu.delta, atol=2e-5, rtol=0)
    x, y = tc.x[:40], tc.y[:40]
    assert tc.evaluate(tparams, x, y) == jc.evaluate(
        jax.tree.map(jnp.asarray, params), x, y)
