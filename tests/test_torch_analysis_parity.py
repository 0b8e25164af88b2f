"""repro_torch.analysis against repro.analysis: the same case lists, the same
verdicts.

The port's ``_ffn_cases()`` / ``_ffn_widths()`` are the reference's; every
zoo FFN width and head layout that the reference's Pallas entry points
accept (``jax.eval_shape`` through ``_traces_ok``) the port's wrappers
accept on meta tensors, which meet the card's launch checks, and every one
the reference refuses with a ValueError the port refuses too. Both
packages' kernel contracts come out clean, and the reference's
``check_dropped_dw_zero_attn`` (about 10 s here) finds no violation where
the port's, run on the CPU's plain versions, finds none for the same head
counts.
"""
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.analysis import contracts as ref_contracts  # noqa: E402
from repro.analysis import kernel_contracts as ref_kernels  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.analysis import kernel_contracts  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """These checks run many small ops: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDTHS = sorted(ref_kernels._ffn_widths())
LAYOUTS = sorted(kernel_contracts.head_layouts())
M = 8


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_case_lists_equal_the_reference():
    assert contracts._ffn_cases() == ref_contracts._ffn_cases()
    assert kernel_contracts._ffn_widths() == ref_kernels._ffn_widths()
    from repro.configs.base import all_configs
    ref_heads = sorted({c.n_heads for c in all_configs().values()} | {4})
    assert contracts.zoo_head_counts() == ref_heads


@pytest.mark.parametrize("F,d", WIDTHS)
def test_ffn_width_verdict_equals_the_reference(F, d):
    from repro.kernels.masked_ffn import masked_ffn, masked_ffn_batch
    nb = max(F // 128, 1)
    ref = {"masked_ffn": ref_kernels._traces_ok(
               functools.partial(masked_ffn, act="silu", interpret=True),
               _sds(M, d), _sds(d, F), _sds(F, d), _sds(nb))[0],
           "masked_ffn_batch": ref_kernels._traces_ok(
               functools.partial(masked_ffn_batch, act="silu", interpret=True),
               _sds(M, d), _sds(d, F), _sds(F, d), _sds(M, F))[0]}
    for dtype in (torch.float32, torch.bfloat16):
        got = kernel_contracts.ffn_verdicts(F, d, dtype)
        assert {k: got[k][0] for k in ref} == ref, (dtype, got)
        assert got["masked_ffn_train"][0] == ref["masked_ffn"]
        if not ref["masked_ffn"]:
            assert "multiple of BLOCK_NEURONS=128" in got["masked_ffn"][1]


@pytest.mark.parametrize("H,hd,d", LAYOUTS)
def test_head_layout_verdict_equals_the_reference(H, hd, d):
    from repro.kernels.masked_attn import masked_head_merge, masked_head_proj
    ref = {"masked_head_proj": ref_kernels._traces_ok(
               functools.partial(masked_head_proj, interpret=True),
               _sds(M, d), _sds(d, H * hd), _sds(H))[0],
           "masked_head_merge": ref_kernels._traces_ok(
               functools.partial(masked_head_merge, interpret=True),
               _sds(M, H * hd), _sds(H * hd, d), _sds(H))[0]}
    _, dtype = kernel_contracts.head_layouts()[(H, hd, d)]
    got = kernel_contracts.head_verdicts(H, hd, d, dtype)
    assert {k: ok for k, (ok, _) in got.items()} == ref == {k: True for k in ref}


def test_kernel_contracts_clean_in_both_packages():
    assert ref_kernels.run_kernel_contracts() == []
    assert kernel_contracts.run_kernel_contracts() == []


def test_dw_zero_attn_clean_in_both_packages():
    assert ref_contracts.check_dropped_dw_zero_attn() == []
    assert contracts.check_dropped_dw_zero_attn(device="cpu") == []


@pytest.mark.parametrize("H", contracts.zoo_head_counts())
def test_dw_zero_attn_case_on_the_cpu(H):
    res = contracts.attn_poison_case(H, "cpu")
    assert res["finite"]
    assert all(res["dropped_zero"].values()), res["dropped_zero"]
    # the plain versions select, so the poisoned run is the clean run
    assert max(res["kept_err"].values()) == 0.0, res["kept_err"]
