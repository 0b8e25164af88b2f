"""The meta-device dry-run (``launch/dryrun``, ``launch/roofline``) on the
CPU: ``active_params``, ``model_flops`` and ``VARIANTS`` equal to the JAX
reference's for all ten archs; every arch's step at full width on 2
layers runs on the meta device for train_4k and decode_32k (batch cut to
1, or to the config's microbatch count) (the FLOPs against a real step:
``test_torch_dryrun_flops.py``); a meta input the card's kernels would refuse
raises the same ValueError; the byte counts of a known product.
"""
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.models import model  # noqa: E402


@pytest.fixture(scope="module")
def jdr():
    """The reference's dry-run module. Importing it appends a 512-device
    flag to XLA_FLAGS; the backend is started first, so the flag changes
    nothing, and the variable is restored."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return mod


def test_variants_match_reference(jdr):
    assert dryrun.VARIANTS == jdr.VARIANTS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_match_reference(jdr, arch):
    from repro.configs import INPUT_SHAPES as J_SHAPES
    from repro.configs import get_config as jax_get_config
    from repro.launch import roofline as jax_roofline
    n = dryrun.active_params(get_config(arch))
    assert n == jdr.active_params(jax_get_config(arch))
    for name, shape in INPUT_SHAPES.items():
        assert roofline.model_flops(get_config(arch), shape, n) == \
            jax_roofline.model_flops(jax_get_config(arch), J_SHAPES[name], n)
    # a variant's overrides as the reference's run_combo makes them
    for v in ("submodel_r75", "rwkv_c128_bf16", "accum4"):
        cfg = dryrun.variant_config(arch, v)
        over = jdr.VARIANTS[v]
        jcfg = jax_get_config(arch).with_overrides(**over.get("cfg_overrides", {}))
        if over.get("dff_scale"):
            assert cfg.d_ff == int(jcfg.d_ff * over["dff_scale"]) // 128 * 128
        else:
            assert (cfg.rwkv_chunk, cfg.rwkv_chunk_dtype, cfg.grad_accum) == \
                (jcfg.rwkv_chunk, jcfg.rwkv_chunk_dtype, jcfg.grad_accum)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_two_layer_full_width_runs_on_meta(arch):
    cfg = get_config(arch).with_overrides(n_layers=2)
    if cfg.is_encdec:
        cfg = cfg.with_overrides(enc_layers=2)
    ops.reset_launch_counts()
    for name in ("train_4k", "decode_32k"):
        shape = dataclasses.replace(INPUT_SHAPES[name], global_batch=max(cfg.grad_accum, 1))
        terms, mem = dryrun.dry_step(cfg, shape)
        assert terms.flops > 0 and terms.bytes_unfused >= terms.bytes_accessed > 0
        assert mem["peak_estimate"] >= mem["argument_bytes"] > 0
        assert mem["argument_breakdown"]["params"] == sum(
            t.numel() * t.element_size()
            for t in jax.tree.leaves(model.init_params(cfg, device="meta")))
        if name == "train_4k":
            assert mem["saved_for_backward_bytes"] > 0
            assert mem["written_bytes"] == mem["argument_breakdown"]["params"] + \
                mem["argument_breakdown"]["opt_state"]
        else:
            assert mem["saved_for_backward_bytes"] == 0
    assert set(ops.launch_counts().values()) == {0}


def test_masked_train_step_counts_the_dense_flops():
    """fluid_mask_r75: the masked step runs on meta with full_masks' tree,
    and a mask is data: the same matmuls as the unmasked step."""
    cfg = get_config("stablelm-12b").smoke()
    shape = InputShape("t", 32, 2, "train")
    masked, _ = dryrun.dry_step(cfg, shape, dryrun.VARIANTS["fluid_mask_r75"])
    dense, _ = dryrun.dry_step(cfg, shape)
    assert masked.flops == dense.flops > 0


@pytest.mark.parametrize("variant,grouped", [("serve_tp_bf16", False),
                                             ("serve_seqcache", True), ("serve_upos", True)])
def test_decode_variants_take_their_attention_route(monkeypatch, variant, grouped):
    """The sequence-sharded-cache variants pass grouped_decode to the serve
    step: every layer's decode attention runs ``_sdpa_grouped`` on meta
    tensors, and no layer's does under the others."""
    from repro_torch.models import attention
    calls, orig = [], attention._sdpa_grouped
    monkeypatch.setattr(attention, "_sdpa_grouped",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    cfg = dryrun.variant_config("stablelm-12b", variant).smoke()
    terms, _ = dryrun.dry_step(cfg, InputShape("d", 64, 2, "decode"), dryrun.VARIANTS[variant])
    assert terms.flops > 0
    assert len(calls) == (cfg.n_layers if grouped else 0)


def test_meta_input_the_card_refuses_raises_its_error():
    """RWKV head size 48 (the kernel takes 16, 32, 64) and a decode head
    dim of 40 in bf16 (80 B: not 16 B times a power of two) raise the
    launch's ValueError on the meta device; the CPU's plain versions take
    both."""
    cfg = get_config("rwkv6-3b").smoke().with_overrides(d_model=96, rwkv_head_size=48)
    with pytest.raises(ValueError, match="head size N"):
        dryrun.dry_step(cfg, InputShape("p", 32, 1, "prefill"))
    m = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="head size N"):
        ops.rwkv_chunk_scan(m(1, 8, 2, 48), m(1, 8, 2, 48), m(1, 8, 2, 48),
                            m(1, 8, 2, 48, dt=torch.float32), m(2, 48, dt=torch.float32))
    with pytest.raises(ValueError, match="16 B times a power of two"):
        ops.decode_gqa(m(2, 4, 40), m(2, 8, 2, 40), m(2, 8, 2, 40),
                       m(2, dt=torch.int32))
    with pytest.raises(ValueError, match="kernel takes"):
        ops.masked_ffn_batch(m(2, 64, dt=torch.float64), m(64, 128, dt=torch.float64),
                             m(128, 64, dt=torch.float64), m(2, 128, dt=torch.float32))
    c = lambda *s: torch.zeros(*s)  # noqa: E731
    assert ops.decode_gqa(c(2, 4, 40), c(2, 8, 2, 40), c(2, 8, 2, 40),
                          torch.ones(2, dtype=torch.int32)).shape == (2, 4, 40)


def test_rwkv_training_takes_the_plain_form_and_the_kernel_refuses_grad():
    """B12 has no backward: on the meta device, as on the card, its wrapper
    given an input that requires grad raises; tmix_seq differentiated runs
    the plain chunked form (either chunk dtype), so a train step needs none
    of the kernel's checks, and its backward reaches every param."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import rwkv6
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no backward"):
        ops.rwkv_chunk_scan(m(1, 8, 2, 64).requires_grad_(), m(1, 8, 2, 64), m(1, 8, 2, 64),
                            m(1, 8, 2, 64), m(2, 64), chunk=8)
    for cd in ("float32", "bfloat16"):
        cfg = get_config("rwkv6-3b").smoke().with_overrides(
            d_model=96, rwkv_head_size=48, rwkv_chunk_dtype=cd, dtype="float32",
            param_dtype="float32")
        p = rwkv6.init_tmix(None, cfg, "meta", torch.float32)
        for t in tree_leaves(p):
            t.requires_grad_()
        y, _, st = rwkv6.tmix_seq(p, m(2, 32, cfg.d_model), cfg)
        assert y.shape == (2, 32, cfg.d_model) and st.shape == (2, 2, 48, 48)
        gs = torch.autograd.grad(y.sum() + st.sum(), tree_leaves(p))
        assert all(g.shape == t.shape for g, t in zip(gs, tree_leaves(p)))


def test_count_terms_of_a_product():
    """2·M·K·N FLOPs forward, 6·M·K·N with the backward; the floor reads
    each input once and writes the output once; the ceiling adds every op's
    operands; the peak holds the arguments and the output."""
    M, K, N = 64, 128, 96
    a = torch.empty(M, K, device="meta")
    b = torch.empty(K, N, device="meta")
    y, terms, mem = roofline.count_terms(torch.matmul, a, b)
    assert terms.flops == 2 * M * K * N
    assert mem["argument_bytes"] == 4 * (M * K + K * N) and mem["output_bytes"] == 4 * M * N
    assert terms.bytes_accessed == 4 * (M * K + K * N + M * N) == terms.bytes_unfused
    assert mem["peak_bytes"] == 4 * (M * K + K * N + M * N)
    a.requires_grad_()
    _, terms, _ = roofline.count_terms(lambda x, w: (x @ w).sum().backward(), a, b)
    assert terms.flops == 4 * M * K * N            # dW of b is not asked for: 2 products
    assert terms.t_collective == 0 and terms.bottleneck in ("compute", "memory")
    # in place: an update writes its target once
    w = torch.empty(K, N, device="meta")
    _, terms, mem = roofline.count_terms(lambda p, g: p.sub_(g), w, b)
    assert mem["written_bytes"] == 4 * K * N and mem["output_bytes"] == 0
    assert np.isclose(terms.t_memory, 3 * 4 * K * N / roofline.HBM_BYTES_PER_S)
