"""``model.loss_fn`` and its gradients for every registered arch against
the JAX reference's, on the CPU: smoke configs in float32, params from the
reference's init through numpy, the batch from both packages'
``synth_batch``; loss within 1e-5, each gradient leaf within 1e-4 (relative
∞-norm, the helpers of tests/test_torch_train_step.py). Block remat is on
in the configs that set it, in both packages."""
import pytest

pytest.importorskip("jax")

from repro.configs import ARCH_IDS  # noqa: E402
from test_torch_train_step import (GRAD_TOL, LOSS_TOL, _assert_trees_close,  # noqa: E402
                                   _batches, _cfgs, _params, jax_value_and_grad,
                                   steps)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_and_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(jcfg)
    jb, tb = _batches(jcfg, tcfg)
    (jloss, jm), jg = jax_value_and_grad(jparams, jcfg, jb)
    (tloss, tm), tg = steps.make_grads_fn(tcfg)(tparams, tb)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * max(1.0, abs(float(jloss)))
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= LOSS_TOL
    _assert_trees_close(tg, jg, GRAD_TOL)
