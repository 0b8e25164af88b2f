"""The port's train step against the JAX reference, on the CPU.

Smoke configs in float32, params from the reference's init through numpy.
``model.loss_fn`` under a loss mask against ``jax.value_and_grad`` of the
reference's: loss within 1e-5, each gradient leaf within 1e-4 (relative
∞-norm); tests/test_torch_zoo_loss.py does the same for every registered
arch. ``launch.steps.make_train_step`` with the masked FFN through the
training kernels (their plain versions here; the reference's Pallas kernel
in interpret mode, as tests/test_kernel_grad.py runs it): under SGD at lr 1
the params' change is the gradient (1e-4); under AdamW the params within
1e-3, the reference's own tolerance. Also grad_accum, Granite's biased FFN
(no kernel route), block remat (same numbers, the forward kernel twice a
layer), param_specs, and the chunked WKV scan's plain route under
autograd.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.train import synth_batch as jax_synth_batch  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import masks_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels import masked_ffn, ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import synth_batch  # noqa: E402
from repro_torch.models import model as tq_model  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
B, S = 2, 16
jax_value_and_grad = jax.jit(jax.value_and_grad(jax_model.loss_fn, has_aux=True),
                             static_argnums=(1,))


def _cfgs(arch, **over):
    """The arch's smoke config in float32 in both packages, with ``over``."""
    over = {"dtype": "float32", "param_dtype": "float32", "grad_accum": 1, **over}
    return (dataclasses.replace(jax_get_config(arch).smoke(), **over),
            dataclasses.replace(get_config(arch).smoke(), **over))


def _params(jcfg):
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _batches(jcfg, tcfg, batch=B, seq=S, seed=0):
    """The same synthetic batch in both packages (the same RandomState)."""
    jb = jax_synth_batch(np.random.RandomState(seed), jcfg, batch, seq + 1)
    tb = synth_batch(np.random.RandomState(seed), tcfg, batch, seq + 1, "cpu")
    return jb, tb


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_trees_close(got, want, tol):
    """Each leaf within ``tol`` relative ∞-norm, but the cross-attention's
    key bias: its keys sit at position 0 (no rotation), so the bias shifts
    each query's scores alike and softmax cancels it. Its exact gradient is
    zero; both packages give rounding noise, held below 1e-6 of the tree's
    largest entry."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    scale = max(np.abs(np.asarray(v)).max() for v in w.values())
    errs = {}
    for k in w:
        a, b = g[k].detach().numpy(), np.asarray(w[k])
        if k.endswith("/cross/bk"):
            assert max(np.abs(a).max(), np.abs(b).max()) <= 1e-6 * scale, k
        else:
            errs[k] = _rel(a, b)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])


def _masks(jcfg, seed=0):
    """FFN masks that drop a different pair of 128-blocks in each layer
    (kept by numpy, given to both packages)."""
    from repro.core import transformer_hooks as jhooks
    rng = np.random.RandomState(seed)

    def drop(m):
        m = np.array(m, np.float32)
        nb = m.shape[-1] // 128
        for r in range(m.shape[0]):
            for b in rng.choice(nb, size=nb // 2, replace=False):
                m[r, ..., b * 128:(b + 1) * 128] = 0.0
        return m
    npm = jax.tree.map(drop, jhooks.full_masks(jcfg))
    return jax.tree.map(jnp.asarray, npm), masks_from_numpy(npm)


def test_loss_mask_weights_the_mean():
    jcfg, tcfg = _cfgs("stablelm-12b")
    jparams, tparams = _params(jcfg)
    jb, tb = _batches(jcfg, tcfg)
    mask = (np.random.RandomState(5).rand(B, S) < 0.6).astype(np.float32)
    jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    (jloss, _), jg = jax_value_and_grad(jparams, jcfg, jb)
    (tloss, _), tg = steps.make_grads_fn(tcfg)(tparams, tb)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    _assert_trees_close(tg, jg, GRAD_TOL)
    tb["loss_mask"] = torch.zeros(B, S)                 # sum(mask) clamps to 1
    (zero, _), _ = steps.make_grads_fn(tcfg)(tparams, tb)
    assert float(zero) == 0.0


def _count_ffn_kernels(monkeypatch):
    """Count calls of the three training-kernel functions MaskedFFNTrain
    calls (their plain versions on the CPU)."""
    counts = dict.fromkeys(("masked_ffn_train_fwd", "masked_ffn_dx", "masked_ffn_dw"), 0)
    for name in counts:
        fn = getattr(masked_ffn, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(masked_ffn, name, counted)
    return counts


def _step_pair(arch, use_kernels, **over):
    """One masked train step of both packages from the same params, masks
    and batch: (reference new params, port new params, reference params
    before, losses, config)."""
    jcfg, tcfg = _cfgs(arch, **over)
    jparams, tparams = _params(jcfg)
    jmasks, tmasks = _masks(jcfg)
    jb, tb = _batches(jcfg, tcfg, batch=4)
    jstep = jax.jit(jax_steps.make_train_step(jcfg, with_masks=True, use_kernels=use_kernels))
    jnew, _, jmet = jstep(jparams, jax_make_optimizer(jcfg.optimizer).init(jparams), jb, jmasks)
    tstep = steps.make_train_step(tcfg, with_masks=True, use_kernels=use_kernels)
    tnew, _, tmet = tstep(tparams, make_optimizer(tcfg.optimizer).init(tparams), tb, tmasks)
    return jnew, tnew, jparams, (float(jmet["loss"]), float(tmet["loss"])), tcfg


@pytest.mark.parametrize("arch", ["stablelm-12b", "recurrentgemma-9b"])
def test_kernel_train_step_sgd_gradients_match_reference(arch, monkeypatch):
    """SGD at lr 1: the params' change is the gradient. The masked FFN goes
    through MaskedFFNTrain at C = 1 in every layer; with block remat its
    forward runs twice a layer (forward and recompute), dx and dW once."""
    counts = _count_ffn_kernels(monkeypatch)
    jnew, tnew, jold, (jl, tl), tcfg = _step_pair(arch, True, optimizer="sgd",
                                                  learning_rate=1.0)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl)
    L = tcfg.n_layers
    assert counts == {"masked_ffn_train_fwd": 2 * L, "masked_ffn_dx": L, "masked_ffn_dw": L}
    delta = lambda new: jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), new, jold)
    tdelta = jax.tree.map(lambda a, b: torch.from_numpy(a.numpy() - np.asarray(b)),
                          tnew, jold)
    _assert_trees_close(tdelta, delta(jnew), GRAD_TOL)


def test_kernel_train_step_adamw_matches_reference():
    jnew, tnew, _, (jl, tl), _ = _step_pair("stablelm-12b", True)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl)
    g, w = _flat(tnew), _flat(jnew)
    for k in w:
        assert float(np.abs(g[k].numpy() - np.asarray(w[k])).max()) < 1e-3, k


def test_kernel_and_dense_routes_agree_and_dropped_blocks_get_no_gradient():
    """The port's kernel step against its own dense masked step: the same
    loss and gradients, and a dropped block's W_in/W_gate columns and W_out
    rows get exactly zero gradient on both routes."""
    jcfg, tcfg = _cfgs("stablelm-12b")
    _, tparams = _params(jcfg)
    _, tmasks = _masks(jcfg)
    _, tb = _batches(jcfg, tcfg, batch=4)
    (lk, _), gk = steps.make_grads_fn(tcfg, use_kernels=True)(tparams, tb, tmasks)
    (ld, _), gd = steps.make_grads_fn(tcfg)(tparams, tb, tmasks)
    assert abs(float(lk) - float(ld)) <= LOSS_TOL * abs(float(ld))
    _assert_trees_close(gk, gd, GRAD_TOL)
    dropped = tmasks[0]["l0"]["ffn"] == 0                        # (R, f)
    for g in (gk, gd):
        ffn = g["stack"]["seg0"]["l0"]["ffn"]
        for r in range(dropped.shape[0]):
            assert (ffn["w_in"][r][:, dropped[r]] == 0).all()
            assert (ffn["w_gate"][r][:, dropped[r]] == 0).all()
            assert (ffn["w_out"][r][dropped[r]] == 0).all()


def test_grad_accum_matches_reference():
    jnew, tnew, jold, (jl, tl), _ = _step_pair("stablelm-12b", True, optimizer="sgd",
                                               learning_rate=1.0, grad_accum=2)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl)
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), jnew, jold)
    tdelta = jax.tree.map(lambda a, b: torch.from_numpy(a.numpy() - np.asarray(b)),
                          tnew, jold)
    _assert_trees_close(tdelta, delta, GRAD_TOL)


def test_biased_ffn_takes_no_kernel_route(monkeypatch):
    """Granite's FFN has biases: with use_kernels=True its masked FFN stays
    dense, in both packages, and the step is the dense step's."""
    counts = _count_ffn_kernels(monkeypatch)
    jnew, tnew, jold, (jl, tl), _ = _step_pair("granite-20b", True, optimizer="sgd",
                                               learning_rate=1.0)
    assert set(counts.values()) == {0}
    assert abs(tl - jl) <= LOSS_TOL * abs(jl)
    delta = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), jnew, jold)
    tdelta = jax.tree.map(lambda a, b: torch.from_numpy(a.numpy() - np.asarray(b)),
                          tnew, jold)
    _assert_trees_close(tdelta, delta, GRAD_TOL)


def test_block_remat_gives_the_same_numbers():
    """cfg.remat "block" and "none": the same loss and the same gradient
    bits, with and without the kernel route."""
    jcfg, tcfg = _cfgs("stablelm-12b")
    _, tparams = _params(jcfg)
    _, tmasks = _masks(jcfg)
    _, tb = _batches(jcfg, tcfg)
    assert tcfg.remat == "block"
    for kernels in (False, True):
        (l1, _), g1 = steps.make_grads_fn(tcfg, kernels)(tparams, tb, tmasks)
        (l0, _), g0 = steps.make_grads_fn(dataclasses.replace(tcfg, remat="none"),
                                          kernels)(tparams, tb, tmasks)
        assert torch.equal(l0, l1)
        for a, b in zip(_flat(g0).values(), _flat(g1).values()):
            assert torch.equal(a, b)


def test_rwkv_chunk_scan_plain_route_differentiates():
    """On CPU tensors the chunked WKV scan is its plain version, which
    autograd differentiates: every input gets a finite, nonzero gradient
    that matches a central difference."""
    g = torch.Generator().manual_seed(0)
    Bq, Sq, H, N = 1, 8, 2, 4
    r, k, v = (torch.randn(Bq, Sq, H, N, generator=g, dtype=torch.float64) for _ in range(3))
    logw = -torch.rand(Bq, Sq, H, N, generator=g, dtype=torch.float64) - 0.1
    u = torch.randn(H, N, generator=g, dtype=torch.float64)
    ins = [t.requires_grad_() for t in (r, k, v, logw, u)]
    y, s = ops.rwkv_chunk_scan(*ins, chunk=4)
    (y.square().sum() + s.square().sum()).backward()
    for t in ins:
        assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    with torch.no_grad():
        def f():
            yy, ss = ops.rwkv_chunk_scan(*ins, chunk=4)
            return float(yy.double().square().sum() + ss.double().square().sum())
        eps = 1e-4
        k.data[0, 3, 1, 2] += eps
        up = f()
        k.data[0, 3, 1, 2] -= 2 * eps
        down = f()
        k.data[0, 3, 1, 2] += eps
    assert abs((up - down) / (2 * eps) - float(k.grad[0, 3, 1, 2])) <= 1e-3 * max(
        1.0, abs(float(k.grad[0, 3, 1, 2])))


def test_param_specs_and_count_params_match_reference():
    """param_specs allocates nothing and gives init_params' shapes and
    dtypes; count_params takes tensors or specs; at StableLM-2-12B's full
    width the count is the reference's."""
    for arch in ARCH_IDS:
        tcfg = get_config(arch).smoke()
        specs, params = tq_model.param_specs(tcfg), tq_model.init_params(tcfg, device="cpu")
        fs, fp = _flat(specs), _flat(params)
        assert sorted(fs) == sorted(fp)
        for key, t in fp.items():
            assert fs[key].shape == tuple(t.shape) and fs[key].dtype == t.dtype, key
        assert tq_model.count_params(specs) == tq_model.count_params(params)
    full = get_config("stablelm-12b").with_overrides(n_layers=8)
    want = jax_model.count_params(jax_model.param_specs(
        jax_get_config("stablelm-12b").with_overrides(n_layers=8)))
    assert tq_model.count_params(tq_model.param_specs(full)) == want == 3_145_815_040
