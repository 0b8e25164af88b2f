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
from repro_torch.kernels import masked_attn as attn
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


def _train_masks(C, M, F, g, dev):
    """Per-client row masks: all kept, ordered rate 0.5 (whole blocks
    dropped), scattered neurons at 0.75, one all-zero row, all dropped."""
    masks = []
    for c in range(C):
        kind = c % 5
        if kind == 0:
            m = torch.ones(M, F, device=dev)
        elif kind == 1:
            m = torch.zeros(M, F, device=dev)
            m[:, :F // 2] = 1.0
        elif kind == 2:
            m = (torch.rand(F, generator=g, device=dev) < 0.75).float().expand(M, F)
        elif kind == 3:
            m = (torch.rand(M, F, generator=g, device=dev) < 0.5).float()
            m[0] = 0.0
        else:
            m = torch.zeros(M, F, device=dev)
        masks.append(m)
    return torch.stack(masks).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True),
                                       ("relu", False), ("relu2", True)])
@pytest.mark.parametrize("C,M,d,F", [(5, 10, 64, 1024), (3, 13, 200, 384),
                                     (2, 1, 40, 128)])
def test_masked_ffn_train_kernels_match_plain(dev, dtype, act, gated, C, M, d, F):
    g = torch.Generator(device=dev).manual_seed(C * F + d)
    r = lambda *s, fan: (torch.randn(*s, generator=g, device=dev)
                         / math.sqrt(fan)).to(dtype)
    x, gy = r(C, M, d, fan=1), r(C, M, d, fan=1)
    w_in, w_out = r(C, d, F, fan=d), r(C, F, d, fan=F)
    w_gate = r(C, d, F, fan=d) if gated else None
    mask = _train_masks(C, M, F, g, dev)
    before = {k: c.n for k, c in ops.LAUNCHES.items()}
    y = ffn.masked_ffn_train_fwd(x, w_in, w_out, mask, w_gate, act=act)
    dx = ffn.masked_ffn_dx(gy, x, w_in, w_out, mask, w_gate, act=act)
    dws = ffn.masked_ffn_dw(gy, x, w_in, w_out, mask, w_gate, act=act)
    torch.cuda.synchronize()
    for k in ("masked_ffn_train_fwd", "masked_ffn_dx", "masked_ffn_dw"):
        assert ops.LAUNCHES[k].n == before[k] + 1
    want_y = ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, act)
    want_dx = ffn.masked_ffn_dx_plain(gy, x, w_in, w_out, mask, w_gate, act)
    want_dws = ffn.masked_ffn_dw_plain(gy, x, w_in, w_out, mask, w_gate, act)
    assert y.dtype == dtype and y.shape == (C, M, d)
    assert _rel_err(y, want_y) <= _tol(dtype)
    assert _rel_err(dx, want_dx) <= _tol(dtype)
    for got, want in zip(dws, want_dws):
        if want is None:
            assert got is None
            continue
        assert got.dtype == dtype
        assert _rel_err(got, want) <= _tol(dtype)
    # tiles no row keeps: dW exactly 0; an all-dropped client: y and dx 0
    blk = mask.view(C, M, F // 128, 128).amax(dim=(1, 3)) == 0      # (C, nfb)
    cols = blk.repeat_interleave(128, dim=1)                          # (C, F)
    assert (dws[0].transpose(1, 2)[cols] == 0).all()
    assert (dws[1][cols] == 0).all()
    if gated:
        assert (dws[2].transpose(1, 2)[cols] == 0).all()
    dead = mask.sum(dim=(1, 2)) == 0
    assert (y[dead] == 0).all() and (dx[dead] == 0).all()


def test_masked_ffn_train_autograd_launches_each_kernel_once(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    C, M, d, F = 5, 10, 64, 1024
    x = torch.randn(C, M, d, generator=g, device=dev, requires_grad=True)
    w_in = (torch.randn(C, d, F, generator=g, device=dev) / 8).requires_grad_()
    w_out = (torch.randn(C, F, d, generator=g, device=dev) / 32).requires_grad_()
    mask = _train_masks(C, M, F, g, dev)
    ops.reset_launch_counts()
    y = ops.masked_ffn_train(x, w_in, w_out, mask, act="gelu")
    y.square().sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert [counts[k] for k in ("masked_ffn_train_fwd", "masked_ffn_dx",
                                "masked_ffn_dw")] == [1, 1, 1]
    gy = 2 * y.detach()
    args = (x.detach(), w_in.detach(), w_out.detach(), mask)
    assert _rel_err(x.grad, ffn.masked_ffn_dx_plain(gy, *args, None, "gelu")) <= 1e-4
    want_in, want_out, _ = ffn.masked_ffn_dw_plain(gy, *args, None, "gelu")
    assert _rel_err(w_in.grad, want_in) <= 1e-4
    assert _rel_err(w_out.grad, want_out) <= 1e-4


def _head_masks(C, H, dev):
    """Per-client head masks: all kept, one head dropped, half dropped, one
    kept, all dropped."""
    rows = [[1] * H, [1] * (H - 1) + [0], [1, 0] * (H // 2) + [1] * (H % 2),
            [0] * (H - 1) + [1], [0] * H]
    return torch.tensor([rows[c % 5] for c in range(C)], dtype=torch.float32,
                        device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,M,width,H,hd", [(5, 490, 64, 4, 16), (7, 37, 24, 4, 6),
                                            (2, 300, 96, 2, 64), (3, 1, 64, 8, 8)])
def test_masked_attn_kernels_match_plain(dev, dtype, C, M, width, H, hd):
    """The six head-masked kernels against their plain versions; a dropped
    head's output slab, da slab and dW slab exactly 0."""
    g = torch.Generator(device=dev).manual_seed(C * M + hd)
    r = lambda *s, fan: (torch.randn(*s, generator=g, device=dev)
                         / math.sqrt(fan)).to(dtype)
    N = H * hd
    x, gy_p = r(C, M, width, fan=1), r(C, M, N, fan=1)       # projection side
    w_p = r(C, width, N, fan=width)
    a, gy_m = r(C, M, N, fan=1), r(C, M, width, fan=1)       # merge side
    w_m = r(C, N, width, fan=N)
    mask = _head_masks(C, H, dev)
    runs = {"masked_head_proj": (attn.proj_fwd, attn.masked_head_proj_plain, (x, w_p)),
            "masked_head_proj_dx": (attn.proj_dx, attn.masked_head_proj_dx_plain, (gy_p, w_p)),
            "masked_head_proj_dw": (attn.proj_dw, attn.masked_head_proj_dw_plain, (gy_p, x)),
            "masked_head_merge": (attn.merge_fwd, attn.masked_head_merge_plain, (a, w_m)),
            "masked_head_merge_da": (attn.merge_da, attn.masked_head_merge_da_plain, (gy_m, w_m)),
            "masked_head_merge_dw": (attn.merge_dw, attn.masked_head_merge_dw_plain, (gy_m, a))}
    dropped = (mask == 0).repeat_interleave(hd, dim=1)                 # (C, N)
    for name, (kern, plain, args) in runs.items():
        before = ops.LAUNCHES[name].n
        got = kern(*args, mask)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name].n == before + 1
        want = plain(*args, mask)
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel_err(got, want) <= _tol(dtype), name
        if name in ("masked_head_proj", "masked_head_merge_da", "masked_head_proj_dw"):
            assert (got.transpose(1, 2)[dropped] == 0).all(), name
        elif name == "masked_head_merge_dw":
            assert (got[dropped] == 0).all(), name
    dead = mask.sum(1) == 0
    assert (attn.merge_fwd(a, w_m, mask)[dead] == 0).all()
    assert (attn.proj_dx(gy_p, w_p, mask)[dead] == 0).all()


def test_masked_attention_autograd_launch_counts(dev):
    """One masked_attention forward and backward launches each projection
    kernel 3 times (Q, K, V) and each merge kernel once; its gradients
    match the plain versions' composition."""
    g = torch.Generator(device=dev).manual_seed(5)
    C, B, S, d, H = 5, 10, 49, 64, 4
    x = torch.randn(C, B, S, d, generator=g, device=dev, requires_grad=True)
    ws = [(torch.randn(C, d, d, generator=g, device=dev) / 8).requires_grad_()
          for _ in range(4)]
    mask = _head_masks(C, H, dev)
    ops.reset_launch_counts()
    y = ops.masked_attention(x, *ws, mask, H)
    y.square().sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert [counts[k] for k in ("masked_head_proj", "masked_head_proj_dx",
                                "masked_head_proj_dw", "masked_head_merge",
                                "masked_head_merge_da", "masked_head_merge_dw")] \
        == [3, 3, 3, 1, 1, 1]
    xs = [t.detach().clone().requires_grad_() for t in (x, *ws)]
    yp = attn.masked_attention(*xs, mask, H, proj=_plain_fn(attn.masked_head_proj_plain,
                                                            attn.masked_head_proj_dx_plain,
                                                            attn.masked_head_proj_dw_plain),
                               merge=_plain_fn(attn.masked_head_merge_plain,
                                               attn.masked_head_merge_da_plain,
                                               attn.masked_head_merge_dw_plain))
    yp.square().sum().backward()
    assert _rel_err(y.detach(), yp.detach()) <= 1e-4
    for t, tp in zip((x, *ws), xs):
        assert _rel_err(t.grad, tp.grad) <= 1e-4


def _plain_fn(fwd, d_in, d_w):
    """An autograd function over three plain versions (forward, d input,
    d weight), for comparison with the kernels' composition."""
    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, w, m):
            ctx.save_for_backward(a, w, m)
            return fwd(a, w, m)

        @staticmethod
        def backward(ctx, gy):
            a, w, m = ctx.saved_tensors
            return d_in(gy, w, m), d_w(gy, a, m), None
    return Plain.apply
