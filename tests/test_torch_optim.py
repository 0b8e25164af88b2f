"""The port's optimizers against the JAX reference's, on the CPU: sgd,
sgdm and adamw (and weight decay) on one params tree, three steps of
gradients drawn with numpy, params and state within 1e-6 relative, AdamW's
step count exact. The port updates in place and returns the same tensors.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import optim as jax_optim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402

TOL = 1e-6
SHAPES = {"tok": {"embed": (64, 16)}, "stack": {"seg0": {"l0": {
    "ffn": {"w_in": (2, 16, 32), "w_out": (2, 32, 16)}, "norm1": {"scale": (2, 16)}}}}}


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("make", [
    lambda m: m.sgd(), lambda m: m.sgdm(), lambda m: m.sgdm(momentum=0.5),
    lambda m: m.adamw(), lambda m: m.adamw(weight_decay=0.1)],
    ids=["sgd", "sgdm", "sgdm0.5", "adamw", "adamw_wd"])
def test_updates_match_reference(make):
    rng = np.random.RandomState(0)
    p0 = _tree(lambda s: rng.randn(*s).astype(np.float32))
    grads = [_tree(lambda s: rng.randn(*s).astype(np.float32)) for _ in range(3)]
    jopt, topt = make(jax_optim), make(optim)
    # each package its own copy: on the CPU jnp.asarray may alias an aligned
    # numpy buffer, which the port's in-place update would then write into
    jp = jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)), p0)
    tp = jax.tree.map(lambda a: torch.tensor(a), p0)
    js, ts = jopt.init(jp), topt.init(tp)
    ids = list(map(id, tree_leaves(tp)))
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, 3e-2)
        tp, ts = topt.update(jax.tree.map(torch.tensor, g), ts, tp, 3e-2)
    assert list(map(id, tree_leaves(tp))) == ids              # updated in place
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert _rel(a.numpy(), b) <= TOL
    assert sorted(ts) == sorted(js)
    for key in js:
        for a, b in zip(jax.tree.leaves(ts[key]), jax.tree.leaves(js[key])):
            assert a.dtype == {jnp.dtype("float32"): torch.float32,
                               jnp.dtype("int32"): torch.int32}[b.dtype]
            if key == "t":
                assert int(a) == int(b) == 3
            else:
                assert _rel(a.numpy(), b) <= TOL


def test_state_dtypes_follow_the_reference():
    """sgdm's buffer keeps the params' dtype; AdamW's moments are fp32 over
    bf16 params, and a bf16 param takes its fp32 step rounded."""
    p = {"w": torch.ones(4, 8, dtype=torch.bfloat16)}
    assert optim.sgdm().init(p)["m"]["w"].dtype == torch.bfloat16
    st = optim.adamw().init(p)
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    assert st["t"].dtype == torch.int32 and st["t"].ndim == 0
    g = {"w": torch.full((4, 8), 0.5, dtype=torch.bfloat16)}
    p, st = optim.adamw().update(g, st, p, 1e-2)
    want = jax_optim.adamw().update({"w": jnp.full((4, 8), 0.5, jnp.bfloat16)},
                                    jax_optim.adamw().init({"w": jnp.ones((4, 8), jnp.bfloat16)}),
                                    {"w": jnp.ones((4, 8), jnp.bfloat16)}, 1e-2)[0]["w"]
    assert p["w"].dtype == torch.bfloat16
    assert np.array_equal(p["w"].float().numpy(), np.asarray(want, np.float32))


def test_make_optimizer_and_functional_forms():
    for name in ("sgd", "sgdm", "adamw"):
        assert optim.make_optimizer(name).name == name
    p = {"w": torch.ones(3)}
    st = optim.init_opt("adamw", p)
    p2, st2 = optim.opt_update("adamw", {"w": torch.ones(3)}, st, p, 0.1)
    assert p2["w"] is p["w"] and int(st2["t"]) == 1
    assert torch.allclose(p["w"], torch.full((3,), 0.9))


def test_params_from_numpy_never_aliases_the_callers_arrays():
    """params_from_numpy copies on the CPU too: an in-place SGD step on its
    tensors leaves the numpy tree as it was."""
    from repro_torch.interop import params_from_numpy
    rng = np.random.RandomState(1)
    tree = _tree(lambda s: rng.randn(*s).astype(np.float32))
    before = jax.tree.map(np.copy, tree)
    tp = params_from_numpy(tree, device="cpu")
    g = jax.tree.map(lambda a: torch.ones(a.shape), tree)
    optim.sgd().update(g, {}, tp, 0.5)
    for a, b, t in zip(jax.tree.leaves(tree), jax.tree.leaves(before), tree_leaves(tp)):
        assert np.array_equal(a, b)
        assert not np.shares_memory(a, t.numpy())
