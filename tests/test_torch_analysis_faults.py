"""Each check of repro_torch.analysis catches a fault planted for it, and the
lint's fixtures (true positive, clean twin, suppressed twin) hold.

Planted faults: a float64 op in an optimizer update (no-f64), the masked
FFN's old plain route that multiplied by the mask (dw-zero-ffn), a dense
FFN whose op sequence depends on the mask's contents (mask-as-data), an
``.item()`` inside a watched program (no-host-sync, CPU form), a masked-FFN
wrapper that accepts F = 200 (kernel-ffn-tiles), an unregistered
``BasePolicy`` subclass (FLD106) and a ``.tolist()`` in a step (FLD105).
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts, kernel_contracts
from repro_torch.analysis.lint import RULES, lint_paths, lint_source
from repro_torch.kernels import masked_ffn as mffn


@pytest.fixture(autouse=True)
def _one_thread():
    """These checks run many small ops: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# lint fixtures: (rule, bad snippet, clean twin)

FIXTURES = {
    "FLD100": ("def f(:\n    pass\n", "def f():\n    pass\n"),
    "FLD105": (
        "import torch\n"
        "def make_train_step(cfg):\n"
        "    def step(params, batch):\n"
        "        loss = params['w'].sum()\n"
        "        return loss.tolist()\n"
        "    return step\n",
        "import torch\n"
        "def make_train_step(cfg):\n"
        "    def step(params, batch):\n"
        "        return params['w'].sum()\n"
        "    return step\n",
    ),
    "FLD106": (
        "from repro_torch.core.dropout import BasePolicy\n"
        "class MyPolicy(BasePolicy):\n"
        "    pass\n",
        "from repro_torch.core.dropout import BasePolicy, register_policy\n"
        "@register_policy('mine')\n"
        "class MyPolicy(BasePolicy):\n"
        "    pass\n",
    ),
}

HOST_SYNCS = {
    "item": "def decode_step(x):\n    return x.max().item()\n",
    "cpu": "def _decode_program(x):\n    return x.cpu()\n",
    "np.asarray": "import numpy as np\ndef step(x):\n    return np.asarray(x)\n",
    "synchronize": "import torch\ndef step(x):\n    torch.cuda.synchronize()\n    return x\n",
    "autograd": ("import torch\nclass F(torch.autograd.Function):\n"
                 "    @staticmethod\n    def backward(ctx, g):\n        return g.item()\n"),
    "checkpoint": ("from torch.utils.checkpoint import checkpoint\n"
                   "def fn(x):\n    return x.tolist()\n"
                   "def run(x):\n    return checkpoint(fn, x)\n"),
}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_lint_true_positive(rule):
    bad, _ = FIXTURES[rule]
    assert [f for f in lint_source(bad, f"fix_{rule}.py") if f.rule == rule]


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_lint_clean_twin(rule):
    _, good = FIXTURES[rule]
    assert lint_source(good, f"clean_{rule}.py") == []


@pytest.mark.parametrize("rule", sorted(set(FIXTURES) - {"FLD100"}))
def test_lint_suppression(rule):
    bad, _ = FIXTURES[rule]
    flagged = {f.line for f in lint_source(bad, "x.py") if f.rule == rule}
    patched = "\n".join(
        ln + (f"  # fluidlint: disable={rule} (the reason)" if i + 1 in flagged else "")
        for i, ln in enumerate(bad.splitlines()))
    assert flagged
    assert [f for f in lint_source(patched, "x.py") if f.rule == rule] == []


def test_file_level_suppression():
    patched = "# fluidlint: disable-file=FLD105\n" + FIXTURES["FLD105"][0]
    assert lint_source(patched, "x.py") == []


@pytest.mark.parametrize("kind", sorted(HOST_SYNCS))
def test_host_sync_forms_in_step_functions(kind):
    hits = lint_source(HOST_SYNCS[kind], "x.py")
    assert [f.rule for f in hits] == ["FLD105"], hits


def test_host_sync_outside_a_step_function_not_flagged():
    src = "def summary(x):\n    return x.cpu().tolist()\n"
    assert lint_source(src, "x.py") == []


def test_every_rule_has_fixture():
    assert set(FIXTURES) == set(RULES)


def test_port_lints_clean():
    assert lint_paths(["src/repro_torch"]) == []


# ---------------------------------------------------------------------------
# contracts catch their planted faults

def test_no_f64_catches_a_float64_update(monkeypatch):
    from repro_torch.optim import optim

    def sgd64():
        def update(grads, state, params, lr):
            for p, g in zip(params.values(), grads.values()):
                p.sub_((g.double() * lr).float())
            return params, state
        return optim.Optimizer("sgd", lambda p: {}, update)
    monkeypatch.setitem(optim._FACTORIES, "sgd", sgd64)
    vs = contracts.check_optim_no_f64()
    assert {v.where for v in vs} == {"update[sgd]"}
    assert "float64" in vs[0].message


def test_no_f64_catches_a_float64_op_in_the_train_step(monkeypatch):
    from repro_torch.models import model as model_lib
    orig = model_lib.loss_fn

    def loss64(*a, **kw):
        loss, metrics = orig(*a, **kw)
        return loss + torch.zeros((), dtype=torch.float64, device=loss.device).float(), metrics
    monkeypatch.setattr(model_lib, "loss_fn", loss64)
    vs = contracts.check_zoo_train_no_f64()
    assert len({v.where for v in vs}) == 10            # every arch's step
    assert all("aten.zeros.default -> float64[]" in v.message for v in vs)


def _multiply_forward(x, w_in, w_out, row_mask, w_gate=None, act="silu"):
    """The plain forward before the repair: multiplies by the mask."""
    xf = mffn._ct(x)
    h = xf @ mffn._ct(w_in)
    h = mffn._ACTS[act](xf @ mffn._ct(w_gate)) * h if w_gate is not None else mffn._ACTS[act](h)
    h = (h * mffn._ct(row_mask)).to(x.dtype)
    return (mffn._ct(h) @ mffn._ct(w_out)).to(x.dtype)


def _multiply_core(gy, x, w_in, w_out, row_mask, w_gate, act):
    xf, rm = mffn._ct(x), mffn._ct(row_mask)
    zh = xf @ mffn._ct(w_in)
    ghm = (mffn._ct(gy) @ mffn._ct(w_out).transpose(-1, -2)) * rm
    if w_gate is not None:
        zg = xf @ mffn._ct(w_gate)
        a = mffn._ACTS[act](zg)
        return a * zh * rm, ghm * a, ghm * zh * mffn._DACTS[act](zg)
    return mffn._ACTS[act](zh) * rm, ghm * mffn._DACTS[act](zh), None


CASES = {(256, "gelu"): "kernel_attn", (512, "swiglu"): "planted"}


def test_dw_zero_ffn_catches_the_multiply_forward(monkeypatch):
    monkeypatch.setattr(mffn, "masked_ffn_batch_plain", _multiply_forward)
    vs = contracts.check_dropped_dw_zero_ffn(device="cpu", cases=CASES)
    assert {v.where for v in vs} == {"masked_ffn[F=256, gelu] (kernel_attn)",
                                     "masked_ffn[F=512, swiglu] (planted)"}
    assert all("forward read a dropped" in v.message for v in vs)


def test_dw_zero_ffn_catches_the_multiply_backward(monkeypatch):
    monkeypatch.setattr(mffn, "_bwd_core_plain", _multiply_core)
    vs = contracts.check_dropped_dw_zero_ffn(device="cpu", cases=CASES)
    assert {v.message.split(" of ")[0] for v in vs} >= {"dW_in"}
    assert all("not bitwise zero" in v.message for v in vs)


def test_mask_as_data_catches_a_mask_dependent_program(monkeypatch):
    from repro_torch.models import transformer
    orig = transformer.apply_ffn

    def leaky(p, x, cfg, neuron_mask=None, kernels=False):
        y = orig(p, x, cfg, neuron_mask, kernels)
        if neuron_mask is not None and bool((neuron_mask == 0).any()):
            y = y * 1.0                    # an op only a partial mask runs
        return y
    monkeypatch.setattr(transformer, "apply_ffn", leaky)
    vs = contracts.check_train_step_mask_as_data(device="cpu")
    assert vs and all(v.check == "mask-as-data-train" for v in vs)
    assert "another op sequence" in vs[0].message


def test_no_host_sync_catches_item_in_a_region():
    vs, out = contracts.sync_violations("no-host-sync", "planted",
                                        lambda t: t * t.sum().item(), torch.ones(3))
    assert [v.message for v in vs] == [
        "host sync inside the region: aten._local_scalar_dense.default"]   # no port frame
    assert torch.equal(out, torch.full((3,), 3.0))
    vs, _ = contracts.sync_violations("no-host-sync", "planted",
                                      lambda t: t[t > 0], torch.ones(3))
    assert vs and "boolean mask" in vs[0].message


def test_no_host_sync_catches_item_in_the_decode_program(monkeypatch):
    from repro_torch.models import model as model_lib
    orig = model_lib.decode_step

    def syncing(*a, **kw):
        logits, caches = orig(*a, **kw)
        float(logits.max())                # a host sync inside the chunk
        return logits, caches
    monkeypatch.setattr(model_lib, "decode_step", syncing)
    vs = contracts.check_no_host_sync(device="cpu")
    assert [v.where for v in vs] == ["ServeEngine._decode_program"]
    assert re.fullmatch(r"host sync inside the region: aten\._local_scalar_dense\.default "
                        r"\(at repro_torch/launch/serving\.py:\d+ _decode_program\)",
                        vs[0].message), vs[0].message


def test_kernel_ffn_tiles_catches_a_wrapper_that_takes_f200(monkeypatch):
    from repro_torch.kernels import ops

    def dense(x, w_in, w_out, mask, w_gate=None, act="silu"):
        return torch.nn.functional.silu(x @ w_in) @ w_out     # the silent dense fallback
    for name in ("masked_ffn", "masked_ffn_batch", "masked_ffn_train"):
        monkeypatch.setattr(ops, name, dense)
    monkeypatch.setattr(kernel_contracts, "_ffn_widths", lambda: {(200, 16): ["planted"]})
    vs = kernel_contracts.check_ffn_tile_eligibility()
    assert len(vs) == 2 and all("NOT 128-aligned" in v.message for v in vs)


def test_unknown_contract_is_a_key_error():
    with pytest.raises(KeyError, match="unknown contract"):
        contracts.run_contracts(only=["no-such-check"], device="cpu")


def test_run_contracts_turns_a_crash_into_a_violation(monkeypatch):
    def boom(device="cpu"):
        raise RuntimeError("boom")
    monkeypatch.setitem(contracts.CHECKS, "no-f64-optim", boom)
    vs = contracts.run_contracts(only=["no-f64-optim"], device="cpu")
    assert [v.message for v in vs] == ["check crashed: RuntimeError: boom"]


def test_recorded_calls_skip_the_warmup_and_compare_ops():
    calls = []
    f = contracts._recorded(lambda t, n: t.sum() if n else t * 2, calls)
    t = torch.ones(4)
    for n in (0, 1, 1):
        f(t, n)
    assert len(calls) == 2 and calls[0]["ops"] == calls[1]["ops"]
    f(t, 0)
    vs = contracts._same_program("c", "w", calls, "cpu")
    assert len(vs) == 1 and "call 3 ran another op sequence" in vs[0].message
    assert np.all([c["launches"] == calls[0]["launches"] for c in calls])
