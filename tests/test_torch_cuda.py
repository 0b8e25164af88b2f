"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import). Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels from src/repro_torch/kernels/csrc.
Tolerances: fp32 inputs agree to 1e-4 relative (fp32 sums in another
order); bf16 inputs to 1e-2 relative ∞-norm (the kernels round the masked
hidden activation to bf16 where the plain version keeps fp32).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_gqa as gqa
from repro_torch.kernels import masked_ffn as ffn
from repro_torch.kernels import ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("relu", False), ("relu2", False),
                                       ("gelu", False), ("silu", False)])
@pytest.mark.parametrize("M,d,F", [(1, 64, 128), (5, 200, 384),
                                   (13, 512, 1024)])
def test_masked_ffn_batch_kernel_matches_plain(dev, dtype, act, gated, M, d, F):
    g = torch.Generator(device=dev).manual_seed(M * F)
    r = lambda *s, fan: (torch.randn(*s, generator=g, device=dev)
                         / math.sqrt(fan)).to(dtype)
    x = r(M, d, fan=1)
    w_in, w_out = r(d, F, fan=d), r(F, d, fan=F)
    w_gate = r(d, F, fan=d) if gated else None
    rates = torch.tensor([1.0, 0.5, 0.0, 0.25, 0.6] * 3, device=dev)[:M]
    mask = (torch.rand(M, F, generator=g, device=dev) < rates[:, None]).float()
    mask[:, :128] *= (torch.arange(M, device=dev) % 2 == 0)[:, None]
    before = ffn.launches.n
    got = ops.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate, act=act)
    torch.cuda.synchronize()
    assert ffn.launches.n == before + 1
    want = ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, act)
    assert got.dtype == dtype and got.shape == (M, d)
    assert _rel_err(got, want) <= _tol(dtype)
    dropped = mask.sum(1) == 0
    assert (got[dropped] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("hd,C", [(64, 40), (128, 300)])
def test_decode_gqa_kernel_matches_plain(dev, dtype, G, hd, C):
    B, KV = 5, 2
    g = torch.Generator(device=dev).manual_seed(G * C)
    q = torch.randn(B, KV * G, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, C, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, C, KV, hd, generator=g, device=dev).to(dtype)
    lengths = torch.tensor(
        np.r_[1, C, np.random.RandomState(C).randint(1, C + 1, B - 2)],
        dtype=torch.int32, device=dev)
    before = gqa.launches.n
    got = ops.decode_gqa(q, k, v, lengths)
    torch.cuda.synchronize()
    assert gqa.launches.n == before + 1
    want = gqa.decode_gqa_plain(q, k, v, lengths)
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel_err(got, want) <= _tol(dtype)


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros(4, 64, device=dev)
    w = torch.zeros(64, 128, device=dev)
    wo = torch.zeros(128, 64, device=dev)
    m = torch.ones(4, 128, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        ops.masked_ffn_batch(x, w.bfloat16(), wo, m)
    with pytest.raises(ValueError, match="contiguous"):
        ops.masked_ffn_batch(x, w.T.contiguous().T, wo, m)
    with pytest.raises(ValueError, match="on cpu"):
        ops.masked_ffn_batch(x, w.cpu(), wo, m)
    q = torch.zeros(2, 48, 64, device=dev)
    k = torch.zeros(2, 8, 3, 64, device=dev)
    with pytest.raises(ValueError, match="H/KV"):
        ops.decode_gqa(q, k, k, torch.ones(2, dtype=torch.int32, device=dev))
