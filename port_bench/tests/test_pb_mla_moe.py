"""The MLA + MoE cell at smoke size on the CPU: the work counts against a
hand count, whole runs that come out ``correct`` and the faults that must
not, and the span readers on a made-up trace."""
import importlib
from types import SimpleNamespace

import pytest
import torch

from conftest import SEED
from harness import cell, counts_mla_moe as counts
from harness.attribution import AttributedTrace
from harness.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from repro_torch.tracing import Span

MOE = "dsv2lite-train-straggler-r075"
MOE_SMALL = dict(hidden_size=128, intermediate_size=320, num_attention_heads=2,
                 num_key_value_heads=2, kv_lora_rank=32, qk_nope_head_dim=16,
                 qk_rope_head_dim=16, v_head_dim=16, n_routed_experts=8,
                 num_experts_per_tok=2, moe_intermediate_size=512, n_shared_experts=2,
                 num_hidden_layers=3, vocab_size=512)
MOE_PORT = dict(d_model=128, d_ff=320, n_heads=2, n_kv_heads=2, kv_lora_rank=32,
                qk_nope_dim=16, qk_rope_dim=16, v_head_dim=16, n_experts=8, top_k=2,
                moe_d_ff=512, vocab_size=512, vocab_pad_multiple=64)


def moe_cell(dtype="float32"):
    """The MoE cell cut to smoke size; computed in float32 by default, where
    the program and the reference agree to rounding and the cell's limits
    separate a sound run from a faulty one."""
    w, c, t = cell.resolve(cell.benchmark(), MOE)
    c = dict(c, **MOE_SMALL, dtype=dtype,
             port_overrides=dict(c["port_overrides"], **MOE_PORT, dtype=dtype))
    return w, c, dict(t, batch=2, seq=32)


def run_cell(w, c, t, trace=False):
    driver = importlib.import_module(f"drivers.{t['driver']}")
    return driver.run(w, c, t, SEED, 0.3, trace, lambda tp: 0.0, device="cpu")


def test_moe_step_flops_by_hand():
    _, c, _ = moe_cell()
    proj = 2 * (128 * 2 * 32 + 128 * (32 + 16) + 32 * 2 * (16 + 16) + 2 * 16 * 128)
    context = 2 * 2 * (16 + 16 + 16) * sum(p + 1 for p in range(32))
    dense = 32 * 6 * 128 * 240
    routed = 6 * 128 * 2 * 384
    shared = 6 * 128 * 1024
    router = 2 * 128 * 8
    moe = 32 * (router + routed + shared)
    head = 2 * 128 * 512
    forward = 3 * (32 * proj + context) + dense + 2 * moe + 32 * head
    assert counts.train_step_flops(c, [240], [384.0, 384.0], 2, 32) == 3 * 2 * forward
    flops, nbytes = counts.expert_gemm_work(c, 64, 8 * 384)
    assert (flops, nbytes) == (6 * 128 * 64 * 384, 3 * 8 * 384 * 128 * 2)


def test_moe_cell_is_correct_at_smoke_size():
    w, c, t = moe_cell()
    run = run_cell(w, c, t)
    assert run.correct, run.rows
    assert run.step_flops == counts.train_step_flops(c, [240], [384.0, 384.0], 2, 32)
    assert run.expert_units == [8 * 384, 8 * 384]


def _renormalised(monkeypatch):
    """The program's routed weights divided by each token's sum over its
    picks, as the module default (norm_topk_prob) has them."""
    from repro_torch.models import moe
    real = moe._route

    def route(p, x2d, cfg, *a, **kw):
        order, tok, gs, w, row_e, aux = real(p, x2d, cfg, *a, **kw)
        total = torch.zeros(x2d.shape[0], dtype=w.dtype).index_add_(0, tok, w)
        return order, tok, gs, w / total[tok], row_e, aux
    monkeypatch.setattr(moe, "_route", route)


def _half_batch(monkeypatch):
    """The masked step sees half of each batch."""
    from repro_torch.launch import steps
    real = steps.make_train_step

    def patched(cfg, with_masks=False, use_kernels=False):
        step = real(cfg, with_masks=with_masks, use_kernels=use_kernels)
        if not with_masks:
            return step
        return lambda p, s, b, m: step(p, s, {k: v[: v.shape[0] // 2] for k, v in b.items()}, m)
    monkeypatch.setattr(steps, "make_train_step", patched)


@pytest.mark.parametrize("fault", [_renormalised, _half_batch], ids=lambda f: f.__name__)
def test_moe_cell_fault_fails(monkeypatch, fault):
    fault(monkeypatch)
    assert not run_cell(*moe_cell()).correct


def test_the_parent_s_program_stops_before_drawing(monkeypatch):
    """A program whose ModelConfig lacks the published block's fields stops
    at the configuration, before any weight is drawn."""
    from drivers import train_moe_step
    from repro_torch.configs import base
    real = base.ModelConfig.with_overrides

    def without(self, **kw):
        if {"norm_topk_prob", "seq_aux", "rope_scaling"} & set(kw):
            raise TypeError("unexpected keyword")
        return real(self, **kw)
    monkeypatch.setattr(base.ModelConfig, "with_overrides", without)
    monkeypatch.setattr(train_moe_step.weights, "make_params",
                        lambda *a, **k: pytest.fail("weights drawn"))
    with pytest.raises(TypeError):
        run_cell(*moe_cell())


# ---------------------------------------------------------------------------
# the span readers on a made-up trace

def _sp(name, s, e, sid, parent=None, **attrs):
    return Span(name, int(s * 1e9), int(e * 1e9), sid, parent, attrs)


def _moe_run(units):
    _, c, _ = moe_cell()
    program = [_sp("moe.layer", 1.0, 2.0, 1), _sp("moe.route", 1.0, 1.1, 2, 1, picks=64,
                                                   experts=8),
               _sp("moe.dispatch", 1.1, 1.2, 3, 1), _sp("moe.experts", 1.2, 1.8, 4, 1),
               _sp("moe.combine", 1.8, 2.0, 5, 1), _sp("mla.layer", 2.0, 3.0, 6),
               _sp("moe.backward", 3.0, 4.0, 7)]
    device = [("r", 1.05, 1.15, 1), ("d", 1.15, 1.25, 2), ("gemm", 1.25, 2.25, 3),
              ("void at::native::copy", 2.25, 2.35, 4), ("attn", 2.35, 3.0, 5), ("bwd", 3.2, 3.6, 6),
              ("feed", 0.1, 0.2, 7)]
    launches = {1: 1.01, 2: 1.11, 3: 1.21, 4: 1.81, 5: 2.1, 6: 3.1, 7: 0.05}
    trace = AttributedTrace(device, {"window": [(0.0, 10.0)], "step": [(0.0, 5.0), (5.0, 10.0)]},
                            [], program, launches)
    return SimpleNamespace(kind="train", trace=trace, c=c, expert_units=units)


def test_span_readers_charge_by_launch():
    run = _moe_run([8 * 384, 8 * 256])
    read = lambda name: cell.reader(name)(run)
    assert read("moe_ms.train") == pytest.approx(1e3 * (0.1 + 0.1 + 1.0 + 0.1 + 0.4) / 2)
    assert read("mla_ms.train") == pytest.approx(1e3 * 0.65 / 2)
    assert read("moe_dispatch_ms.train") == pytest.approx(1e3 * 0.3 / 2)
    # the layers' mean of the kept units the driver handed the program
    flops, nbytes = counts.expert_gemm_work(run.c, 64, 8 * 320)
    least = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    assert read("expert_gemm_roofline.train") == pytest.approx(100 * least / 1.0)
    assert read("mla_ms.train") is not None
    plain = SimpleNamespace(kind="train", trace=None, c=run.c)
    assert all(cell.reader(n)(plain) is None for n in
               ("moe_ms.train", "mla_ms.train", "moe_dispatch_ms.train",
                "expert_gemm_roofline.train"))
    # a run that carries no kept units (a program without them) reads no roofline
    assert cell.reader("expert_gemm_roofline.train")(
        SimpleNamespace(kind="train", trace=run.trace, c=run.c)) is None


def test_name_readers_take_the_attributed_trace():
    """gemm_ms.train and elementwise_ms.train read the MoE cell's trace by
    kernel name, as they read the dense cells'."""
    run = _moe_run([8 * 384])
    assert cell.reader("gemm_ms.train")(run) == pytest.approx(1e3 * 1.0 / 2)
    assert cell.reader("elementwise_ms.train")(run) == pytest.approx(1e3 * 0.1 / 2)
