"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside the
fixture, never at import). Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels from src/repro_torch/kernels/csrc.
Tolerances: fp32 inputs agree to 1e-4 relative (fp32 sums in another
order); bf16 inputs to 1e-2 relative ∞-norm (the kernels round the masked
hidden activation to bf16 where the plain version keeps fp32).
"""
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_gqa as gqa
from repro_torch.kernels import invariant_stats as stats
from repro_torch.kernels import masked_attn as attn
from repro_torch.kernels import masked_ffn as ffn
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv_chunk as rwkv

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


@pytest.mark.parametrize("C", [300, 4096])
@pytest.mark.parametrize("ts", gqa.SPLITS)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_gqa_split_boundaries(dev, monkeypatch, dtype, G, hd, ts, C):
    """Rows of 1, TS − 1, TS, TS + 1 and C valid positions, at each split
    length the launch can pick (forced here), against the plain version;
    a second call gives the same bits."""
    monkeypatch.setattr(gqa, "split_len", lambda *a: ts)
    KV = 2
    lens = [1, ts - 1, ts, ts + 1, C]
    B = len(lens)
    rng = np.random.RandomState(ts + C + G)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev, dtype)
    q, k, v = mk(B, KV * G, hd), mk(B, C, KV, hd), mk(B, C, KV, hd)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = gqa.launches.n
    got = ops.decode_gqa(q, k, v, lengths)
    again = ops.decode_gqa(q, k, v, lengths)
    torch.cuda.synchronize()
    assert gqa.launches.n == before + 2
    want = gqa.decode_gqa_plain(q, k, v, lengths)
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel_err(got, want) <= _tol(dtype)
    assert torch.equal(got, again)


def _ffn_masks(kind, M, F, dev):
    """rate-0.5 ordered keep-maps for every row, or m-tiles keeping
    disjoint blocks (the first m-tile blocks 0-2, the second 3-4, ...;
    rows inside a tile at rates 1.0, 0.5, 0.25); the last quarter of the
    blocks is kept by no row."""
    m = torch.zeros(M, F, device=dev)
    if kind == "ordered0.5":
        m[:, :F // 2] = 1.0
        return m
    nfb = F // 128
    for r in range(M):
        t = r // 8
        lo, hi = (0, 3) if t == 0 else (3, 5) if t == 1 else (5, 6)
        keep = int((hi - lo) * 128 * (1.0, 0.5, 0.25)[r % 3])
        m[r, lo * 128:lo * 128 + keep] = 1.0
    assert hi <= nfb * 3 // 4
    return m


@pytest.mark.parametrize("kind", ["ordered0.5", "disjoint"])
@pytest.mark.parametrize("M", [8, 13, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_ffn_batch_kept_blocks_and_repeat(dev, dtype, M, kind):
    """The serving kernel under whole-block dropping: against the plain
    version, dropped rows exactly 0, a second call the same bits."""
    d, F = 512, 1024
    rng = np.random.RandomState(M)
    mk = lambda *s, fan: torch.from_numpy(
        (rng.randn(*s) / math.sqrt(fan)).astype(np.float32)).to(dev, dtype)
    x = mk(M, d, fan=1)
    w_in, w_gate, w_out = mk(d, F, fan=d), mk(d, F, fan=d), mk(F, d, fan=F)
    mask = _ffn_masks(kind, M, F, dev)
    got = ops.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate)
    again = ops.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate)
    torch.cuda.synchronize()
    want = ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, "silu")
    assert _rel_err(got, want) <= _tol(dtype)
    assert (got[mask.sum(1) == 0] == 0).all()
    assert torch.equal(got, again)


@pytest.mark.parametrize("M", [8, 13, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_ffn_batch_reads_no_skipped_block(dev, dtype, M):
    """Every weight of the blocks no row keeps (W_in and W_gate columns,
    W_out rows) is NaN: the output stays finite and equals the plain
    version on the clean weights, so no skipped byte is read."""
    d, F = 512, 1024
    rng = np.random.RandomState(100 + M)
    mk = lambda *s, fan: torch.from_numpy(
        (rng.randn(*s) / math.sqrt(fan)).astype(np.float32)).to(dev, dtype)
    x = mk(M, d, fan=1)
    w_in, w_gate, w_out = mk(d, F, fan=d), mk(d, F, fan=d), mk(F, d, fan=F)
    mask = _ffn_masks("disjoint", M, F, dev)
    want = ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, "silu")
    cols = (mask.view(M, F // 128, 128).amax((0, 2)) == 0).repeat_interleave(128)
    assert cols.any()
    w_in[:, cols], w_gate[:, cols], w_out[cols] = math.nan, math.nan, math.nan
    got = ops.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= _tol(dtype)


@pytest.mark.parametrize("kernel", ["masked_ffn_batch", "decode_gqa"])
def test_serving_kernels_repeat_bitwise_at_decode_shapes(dev, kernel):
    """Two calls on the serve's decode shapes give the same bits (the
    kernels sum in a fixed order, with no atomics)."""
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    if kernel == "masked_ffn_batch":
        M, d, F = 8, 5120, 13824
        r = lambda *s, fan: (torch.randn(*s, generator=g, device=dev) / math.sqrt(fan)).to(bf)
        x, w_in, w_gate, w_out = r(M, d, fan=1), r(d, F, fan=d), r(d, F, fan=d), r(F, d, fan=F)
        mask = torch.zeros(M, F, device=dev)
        for i in range(M):
            mask[i, :int(F * (1.0, 0.5, 0.25)[i % 3])] = 1.0
        call = lambda: ops.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate)
    else:
        B, H, KV, hd, C = 8, 32, 8, 128, 576
        q = torch.randn(B, H, hd, generator=g, device=dev).to(bf)
        k = torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf)
        v = torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf)
        lengths = torch.tensor([256 - 16 * i for i in range(B)], dtype=torch.int32,
                               device=dev)
        call = lambda: ops.decode_gqa(q, k, v, lengths)
    a, b = call(), call()
    torch.cuda.synchronize()
    assert torch.isfinite(a.float()).all()
    assert torch.equal(a, b)


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
    # any H/KV is taken (virtual head groups); a head of 48 fp32 values is
    # 12 16-byte chunks, which no power-of-two lane count covers
    q = torch.zeros(2, 48, 48, device=dev)
    k = torch.zeros(2, 8, 3, 48, device=dev)
    with pytest.raises(ValueError, match="hd"):
        ops.decode_gqa(q, k, k, torch.ones(2, dtype=torch.int32, device=dev))


# B1's serving form at the zoo's decode shapes (M 8, bf16): MiniCPM3-4B,
# RecurrentGemma-9B (gelu gated), Command-R-35B
ZOO_FFN = [(2560, 6400, "silu"), (4096, 12288, "gelu"), (8192, 22528, "silu")]


def _zoo_ffn_masks(M, F, dev):
    """Ordered keep-maps: every row at 1.0, at 0.5, the serve's 1.0/0.5/0.25
    cycle, and the cycle with its last row dropped."""
    def ordered(rates):
        m = torch.zeros(M, F, device=dev)
        for i, r in enumerate(rates):
            m[i, :int(F * r) // 128 * 128 if r < 1 else F] = 1.0
        return m
    cyc = [(1.0, 0.5, 0.25)[i % 3] for i in range(M)]
    return [ordered([1.0] * M), ordered([0.5] * M), ordered(cyc),
            ordered(cyc[:-1] + [0.0])]


@pytest.mark.parametrize("d,F,act", ZOO_FFN)
def test_masked_ffn_batch_at_zoo_decode_shapes(dev, d, F, act):
    """Against the plain version (1e-2 relative ∞-norm), dropped rows
    exactly 0, a second call the same bits, one launch a call."""
    M, bf = 8, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(d + F)
    r = lambda *s, fan: (torch.randn(*s, generator=g, device=dev) / math.sqrt(fan)).to(bf)
    x = r(M, d, fan=1)
    w_in, w_gate, w_out = r(d, F, fan=d), r(d, F, fan=d), r(F, d, fan=F)
    for mask in _zoo_ffn_masks(M, F, dev):
        before = ffn.launches.n
        got = ops.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate, act=act)
        again = ops.masked_ffn_batch(x, w_in, w_out, mask, w_gate=w_gate, act=act)
        torch.cuda.synchronize()
        assert ffn.launches.n == before + 2
        want = ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, act)
        assert _rel_err(got, want) <= 1e-2
        assert (got[mask.sum(1) == 0] == 0).all()
        assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [3, 6, 12, 16, 48])
@pytest.mark.parametrize("KV,hd,C", [(1, 128, 576), (2, 64, 300)])
def test_decode_gqa_virtual_head_groups_match_plain(dev, dtype, G, KV, hd, C):
    """H/KV outside (1, 2, 4, 8) goes to virtual groups of at most 8 heads
    (decode_gqa.head_groups): against the plain version, ragged lengths,
    a second call the same bits, one launch a call."""
    B = 6
    rng = np.random.RandomState(G * hd + KV)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev, dtype)
    q, k, v = mk(B, KV * G, hd), mk(B, C, KV, hd), mk(B, C, KV, hd)
    lengths = torch.tensor(np.r_[1, C, rng.randint(1, C + 1, B - 2)],
                           dtype=torch.int32, device=dev)
    before = gqa.launches.n
    got = ops.decode_gqa(q, k, v, lengths)
    again = ops.decode_gqa(q, k, v, lengths)
    torch.cuda.synchronize()
    assert gqa.launches.n == before + 2
    want = gqa.decode_gqa_plain(q, k, v, lengths)
    assert got.dtype == dtype and got.shape == q.shape
    assert _rel_err(got, want) <= _tol(dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("H,KV", [(64, 8), (48, 1)])
def test_decode_gqa_at_zoo_decode_shapes(dev, H, KV):
    """Command-R-35B's decode (64 heads on 8) and Granite-20B's (48 on 1),
    B 8, hd 128, C 576, bf16, at the step's lengths 256 − 16i."""
    B, hd, C, bf = 8, 128, 576, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(H + KV)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(bf)
    k = torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf)
    v = torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf)
    lengths = torch.tensor([256 - 16 * i for i in range(B)], dtype=torch.int32, device=dev)
    got, again = ops.decode_gqa(q, k, v, lengths), ops.decode_gqa(q, k, v, lengths)
    torch.cuda.synchronize()
    assert _rel_err(got, gqa.decode_gqa_plain(q, k, v, lengths)) <= 1e-2
    assert torch.equal(got, again)


@pytest.mark.parametrize("H,KV,hd", [(16, 16, 64), (56, 8, 128)])
def test_decode_gqa_at_seamless_and_arctic_decode_shapes(dev, H, KV, hd):
    """SeamlessM4T-Large v2's decoder self-attention (16 heads of 64 on 16,
    G 1) and Arctic-480B's (56 on 8, G 7: 7 virtual groups of 1), B 8,
    C 576, bf16, at the step's lengths 256 − 16i: against the plain
    version, a second call the same bits."""
    B, C, bf = 8, 576, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(H + KV)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(bf)
    k = torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf)
    v = torch.randn(B, C, KV, hd, generator=g, device=dev).to(bf)
    lengths = torch.tensor([256 - 16 * i for i in range(B)], dtype=torch.int32, device=dev)
    got, again = ops.decode_gqa(q, k, v, lengths), ops.decode_gqa(q, k, v, lengths)
    torch.cuda.synchronize()
    assert _rel_err(got, gqa.decode_gqa_plain(q, k, v, lengths)) <= 1e-2
    assert torch.equal(got, again)


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
                                     (2, 1, 40, 128), (2, 9, 42, 256)])
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
    assert counts["masked_ffn_dw_tc"] == 0          # fp32: the FFMA kernels
    gy = 2 * y.detach()
    args = (x.detach(), w_in.detach(), w_out.detach(), mask)
    assert _rel_err(x.grad, ffn.masked_ffn_dx_plain(gy, *args, None, "gelu")) <= 1e-4
    want_in, want_out, _ = ffn.masked_ffn_dw_plain(gy, *args, None, "gelu")
    assert _rel_err(w_in.grad, want_in) <= 1e-4
    assert _rel_err(w_out.grad, want_out) <= 1e-4


def _dw_masks(C, M, F, g, dev):
    """_train_masks, with every third client's rows 8-15 dropped as well:
    a skipped m-tile inside a kept f-block."""
    mask = _train_masks(C, M, F, g, dev)
    mask[::3, 8:16] = 0.0
    return mask.contiguous()


def _dw_case(C, M, dtype, gated, dev, d=64, F=256):
    g = torch.Generator(device=dev).manual_seed(C * M + d + gated)
    r = lambda *s, fan: (torch.randn(*s, generator=g, device=dev)
                         / math.sqrt(fan)).to(dtype)
    x, gy = r(C, M, d, fan=1), r(C, M, d, fan=1)
    w_in, w_out = r(C, d, F, fan=d), r(C, F, d, fan=F)
    w_gate = r(C, d, F, fan=d) if gated else None
    return gy, x, w_in, w_out, _dw_masks(C, M, F, g, dev), w_gate


def _check_dw(got, want, mask, dtype):
    C, _, F = mask.shape
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == dtype
        assert _rel_err(a, b) <= _tol(dtype)
    cols = (mask.amax(dim=1).view(C, F // 128, 128).amax(dim=2) == 0
            ).repeat_interleave(128, dim=1)                       # dropped f-blocks
    assert (got[0].transpose(1, 2)[cols] == 0).all() and (got[1][cols] == 0).all()
    if got[2] is not None:
        assert (got[2].transpose(1, 2)[cols] == 0).all()


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [5, 64])
@pytest.mark.parametrize("M", [1, 7, 8, 9, 490, 1100])
def test_masked_ffn_dw_splits_m_tiles_at_femnist_attn_widths(dev, M, C, dtype, gated):
    """d 64, F 256, gelu: the dW kernel against its plain version, with the
    m-tiles split as dw_launch_geometry says; dropped f-blocks exactly 0."""
    gy, x, w_in, w_out, mask, w_gate = _dw_case(C, M, dtype, gated, dev)
    before = ffn.dw_launches.n
    got = ffn.masked_ffn_dw(gy, x, w_in, w_out, mask, w_gate, act="gelu")
    torch.cuda.synchronize()
    assert ffn.dw_launches.n == before + 1
    want = ffn.masked_ffn_dw_plain(gy, x, w_in, w_out, mask, w_gate, "gelu")
    _check_dw(got, want, mask, dtype)


@pytest.mark.parametrize("groups", [1, 2, 5, 16])
@pytest.mark.parametrize("C,M", [(5, 490), (5, 10), (64, 10), (3, 1100)])
def test_masked_ffn_dw_any_split_of_the_m_tiles(dev, monkeypatch, groups, C, M):
    """However many blocks share a pair's m-tiles (one block: dW written
    directly; more: partials through the scratch, added in block order), at
    the training paths' shapes, fp32 and gated bf16, against the plain
    version."""
    def geometry(C_, M_, d_, F_, n_sm=132):
        nmt = -(-M_ // 8)
        per = -(-nmt // min(groups, nmt))
        return {"groups": -(-nmt // per)}
    monkeypatch.setattr(ffn, "dw_launch_geometry", geometry)
    for dtype, gated in ((torch.float32, False), (torch.bfloat16, True)):
        gy, x, w_in, w_out, mask, w_gate = _dw_case(C, M, dtype, gated, dev)
        got = ffn.masked_ffn_dw(gy, x, w_in, w_out, mask, w_gate, act="gelu")
        torch.cuda.synchronize()
        want = ffn.masked_ffn_dw_plain(gy, x, w_in, w_out, mask, w_gate, "gelu")
        _check_dw(got, want, mask, dtype)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,M,d,F", [(3, 13, 200, 384), (2, 490, 130, 256), (1, 64, 512, 1024)])
def test_masked_ffn_dw_core_pass_matches_plain(dev, C, M, d, F, dtype, gated):
    """d > 64: the dW blocks split d, and a first kernel computes each kept
    tile's (hm, dzh, dzg) once for all of them (a ragged last m-tile, d not
    a multiple of 64): against the plain version, dropped f-blocks exactly
    0, and two calls bitwise equal."""
    gy, x, w_in, w_out, mask, w_gate = _dw_case(C, M, dtype, gated, dev, d=d, F=F)
    assert ffn.dw_launch_geometry(C, M, d, F)["core_pass"]
    got = ffn.masked_ffn_dw(gy, x, w_in, w_out, mask, w_gate, act="silu")
    again = ffn.masked_ffn_dw(gy, x, w_in, w_out, mask, w_gate, act="silu")
    torch.cuda.synchronize()
    _check_dw(got, ffn.masked_ffn_dw_plain(gy, x, w_in, w_out, mask, w_gate, "silu"), mask, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.parametrize("C", [5, 64])
def test_masked_ffn_dw_repeats_bitwise_at_m490(dev, C):
    """Two calls on the same inputs give the same bits (fixed-order sums,
    no atomics)."""
    gy, x, w_in, w_out, mask, w_gate = _dw_case(C, 490, torch.float32, False, dev)
    a = ffn.masked_ffn_dw(gy, x, w_in, w_out, mask, w_gate, act="gelu")
    b = ffn.masked_ffn_dw(gy, x, w_in, w_out, mask, w_gate, act="gelu")
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _check_fd(gy, x, w_in, w_out, mask, w_gate, dtype, act="gelu"):
    """The forward and dx kernels against their plain versions; rows that
    no f-block keeps come out exactly 0."""
    y = ffn.masked_ffn_train_fwd(x, w_in, w_out, mask, w_gate, act=act)
    dx = ffn.masked_ffn_dx(gy, x, w_in, w_out, mask, w_gate, act=act)
    torch.cuda.synchronize()
    assert y.dtype == dtype and dx.dtype == dtype
    assert _rel_err(y, ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, act)) <= _tol(dtype)
    assert _rel_err(dx, ffn.masked_ffn_dx_plain(gy, x, w_in, w_out, mask, w_gate, act)) <= _tol(dtype)
    dead = mask.sum(dim=2) == 0
    assert (y[dead] == 0).all() and (dx[dead] == 0).all()


@pytest.mark.parametrize("groups", [1, 2, 5, 16])
@pytest.mark.parametrize("C,M", [(5, 490), (5, 10), (64, 10), (3, 1100)])
def test_masked_ffn_fwd_dx_any_split_of_the_m_tiles(dev, monkeypatch, groups, C, M):
    """However many blocks share a pair's m-tiles, at the training paths'
    shapes, fp32 and gated bf16, the forward and dx equal their plain
    versions."""
    def geometry(C_, M_, d_, F_, n_sm=132):
        nmt = -(-M_ // 8)
        per = -(-nmt // min(groups, nmt))
        return {"groups": -(-nmt // per)}
    monkeypatch.setattr(ffn, "fwd_dx_launch_geometry", geometry)
    for dtype, gated in ((torch.float32, False), (torch.bfloat16, True)):
        _check_fd(*_dw_case(C, M, dtype, gated, dev), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,F,gated,resident", [(64, 256, False, True), (64, 256, True, True),
                                                (42, 256, True, True), (200, 384, False, False),
                                                (200, 384, True, False)])
def test_masked_ffn_fwd_dx_resident_and_restaged_slab(dev, dtype, d, F, gated, resident):
    """The weight slab kept resident for a block's m-tiles (d 64; d 42, not
    a multiple of a 16-byte vector) or restaged 32 rows of d at a time
    (d 200, F 384: 310 KB gated): both equal the plain versions."""
    C, M = 3, 13
    groups = ffn.fwd_dx_launch_geometry(C, M, d, F)["groups"]
    for bwd in (False, True):
        assert ffn.fd_slab_resident(M, d, F, gated, bwd, groups) == resident
    _check_fd(*_dw_case(C, M, dtype, gated, dev, d=d, F=F), dtype)


@pytest.mark.parametrize("C", [5, 64])
def test_masked_ffn_fwd_dx_repeat_bitwise_at_m490(dev, C):
    """Two calls on the same inputs give the same bits (the f-blocks'
    partials added in f order, no atomics)."""
    gy, x, w_in, w_out, mask, w_gate = _dw_case(C, 490, torch.float32, False, dev)
    for run in (lambda: ffn.masked_ffn_train_fwd(x, w_in, w_out, mask, w_gate, act="gelu"),
                lambda: ffn.masked_ffn_dx(gy, x, w_in, w_out, mask, w_gate, act="gelu")):
        a, b = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,M,d,F,gated", [(5, 490, 64, 256, False), (5, 10, 64, 1024, False),
                                           (3, 13, 200, 384, True)])
def test_masked_ffn_fwd_dx_read_no_skipped_block(dev, dtype, C, M, d, F, gated):
    """Every weight of the f-blocks that no row of a client keeps is NaN:
    the forward and dx stay finite and equal the plain versions on the
    clean weights, so no skipped byte is read."""
    gy, x, w_in, w_out, mask, w_gate = _dw_case(C, M, dtype, gated, dev, d=d, F=F)
    want_y = ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, "gelu")
    want_dx = ffn.masked_ffn_dx_plain(gy, x, w_in, w_out, mask, w_gate, "gelu")
    cols = (mask.amax(dim=1).view(C, F // 128, 128).amax(dim=2) == 0
            ).repeat_interleave(128, dim=1)                       # (C, F) dropped f-blocks
    assert cols.any()
    for c in range(C):
        w_in[c][:, cols[c]] = math.nan
        w_out[c][cols[c]] = math.nan
        if w_gate is not None:
            w_gate[c][:, cols[c]] = math.nan
    y = ffn.masked_ffn_train_fwd(x, w_in, w_out, mask, w_gate, act="gelu")
    dx = ffn.masked_ffn_dx(gy, x, w_in, w_out, mask, w_gate, act="gelu")
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(dx.float()).all()
    assert _rel_err(y, want_y) <= _tol(dtype) and _rel_err(dx, want_dx) <= _tol(dtype)


_TC_COUNTED = ("masked_ffn_train_fwd", "masked_ffn_dx", "masked_ffn_dw")


def _tc_counts():
    return {k: ops.LAUNCHES[k].n for k in _TC_COUNTED + tuple(k + "_tc" for k in _TC_COUNTED)}


def _tc_fd(gy, x, w_in, w_out, mask, w_gate, act, tc):
    """The forward, dx and dW, each call counted once, and on the tensor
    cores (the _tc counters) where ``tc``."""
    before = _tc_counts()
    y = ffn.masked_ffn_train_fwd(x, w_in, w_out, mask, w_gate, act=act)
    dx = ffn.masked_ffn_dx(gy, x, w_in, w_out, mask, w_gate, act=act)
    dws = ffn.masked_ffn_dw(gy, x, w_in, w_out, mask, w_gate, act=act)
    torch.cuda.synchronize()
    assert ffn.tc_route(x) is tc
    assert {k: v - before[k] for k, v in _tc_counts().items()} == {
        **dict.fromkeys(_TC_COUNTED, 1), **{k + "_tc": int(tc) for k in _TC_COUNTED}}
    return y, dx, dws


@pytest.mark.parametrize("M", [1024, 1000])
def test_masked_ffn_tc_route_at_stablelm_width(dev, M):
    """B1's training form, B2 and B3 on the tensor cores at StableLM-2-12B's
    FFN (d 5120, F 13824, silu gated, bf16, 81 of 108 blocks kept by every
    row) and a ragged M: within 1e-2 of the plain versions, the same bits on
    a second call, and the same bits with every weight of the dropped blocks
    NaN (no dropped byte is read); the dropped blocks' dW exactly 0."""
    d, F, nb = 5120, 13824, 108
    g = torch.Generator(device=dev).manual_seed(M)
    r = lambda *s, fan: (torch.randn(*s, generator=g, device=dev) / math.sqrt(fan)).to(
        torch.bfloat16)
    x, gy = r(1, M, d, fan=1), r(1, M, d, fan=1)
    w_in, w_gate, w_out = r(1, d, F, fan=d), r(1, d, F, fan=d), r(1, F, d, fan=F)
    keep = torch.zeros(nb, device=dev)
    keep[torch.randperm(nb, generator=g, device=dev)[:81]] = 1.0
    mask = keep.repeat_interleave(128).expand(1, M, F).contiguous()
    y, dx, dws = _tc_fd(gy, x, w_in, w_out, mask, w_gate, "silu", True)
    assert _rel_err(y, ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, "silu")) <= 1e-2
    assert _rel_err(dx, ffn.masked_ffn_dx_plain(gy, x, w_in, w_out, mask, w_gate, "silu")) <= 1e-2
    _check_dw(dws, ffn.masked_ffn_dw_plain(gy, x, w_in, w_out, mask, w_gate, "silu"), mask,
              torch.bfloat16)
    y2, dx2, dws2 = _tc_fd(gy, x, w_in, w_out, mask, w_gate, "silu", True)
    same = lambda a, b: all(torch.equal(s, t) for s, t in zip(a, b))
    assert torch.equal(y, y2) and torch.equal(dx, dx2) and same(dws, dws2)
    cols = (keep == 0).repeat_interleave(128)
    w_in[0][:, cols] = math.nan
    w_gate[0][:, cols] = math.nan
    w_out[0][cols] = math.nan
    y3, dx3, dws3 = _tc_fd(gy, x, w_in, w_out, mask, w_gate, "silu", True)
    assert torch.equal(y, y3) and torch.equal(dx, dx3) and same(dws, dws3)


@pytest.mark.parametrize("C,M,d,F,act,gated", [(5, 200, 128, 512, "gelu", True),
                                               (5, 128, 64, 256, "relu2", False),
                                               (4, 300, 192, 384, "silu", True)])
def test_masked_ffn_tc_route_per_row_masks(dev, C, M, d, F, act, gated):
    """The tensor-core route under per-row masks (all kept, half the blocks,
    scattered neurons, row by row with an all-zero row, nothing), a ragged
    last row tile and d not a multiple of 128 (nor, for dW's 256-row tiles,
    of 256): within 1e-2 of the plain versions; rows that keep nothing
    exactly 0, and so is the dW of f-blocks that no row keeps."""
    gy, x, w_in, w_out, _, w_gate = _dw_case(C, M, torch.bfloat16, gated, dev, d=d, F=F)
    mask = _train_masks(C, M, F, torch.Generator(device=dev).manual_seed(M), dev)
    y, dx, dws = _tc_fd(gy, x, w_in, w_out, mask, w_gate, act, True)
    assert _rel_err(y, ffn.masked_ffn_batch_plain(x, w_in, w_out, mask, w_gate, act)) <= 1e-2
    assert _rel_err(dx, ffn.masked_ffn_dx_plain(gy, x, w_in, w_out, mask, w_gate, act)) <= 1e-2
    _check_dw(dws, ffn.masked_ffn_dw_plain(gy, x, w_in, w_out, mask, w_gate, act), mask,
              torch.bfloat16)
    dead = mask.sum(dim=2) == 0
    assert dead.any() and (y[dead] == 0).all() and (dx[dead] == 0).all()


@pytest.mark.parametrize("dtype,M,d", [(torch.float32, 10, 64), (torch.float32, 490, 64),
                                       (torch.bfloat16, 127, 64), (torch.bfloat16, 490, 200)])
def test_masked_ffn_tc_route_not_taken(dev, dtype, M, d):
    """The fleet's fp32 shapes, a bf16 client of fewer than 128 rows and a d
    that is not a multiple of 64 run the present kernels: the _tc counters
    (masked_ffn_dw_tc among them) do not move."""
    C, F = 3, 256
    gy, x, w_in, w_out, mask, w_gate = _dw_case(C, M, dtype, True, dev, d=d, F=F)
    y, dx, dws = _tc_fd(gy, x, w_in, w_out, mask, w_gate, "gelu", False)
    args = (x, w_in, w_out, mask, w_gate, "gelu")
    assert _rel_err(y, ffn.masked_ffn_batch_plain(*args)) <= _tol(dtype)
    assert _rel_err(dx, ffn.masked_ffn_dx_plain(gy, *args)) <= _tol(dtype)
    _check_dw(dws, ffn.masked_ffn_dw_plain(gy, *args), mask, dtype)


def _head_masks(C, H, dev):
    """Per-client head masks: all kept, one head dropped, half dropped, one
    kept, all dropped."""
    rows = [[1] * H, [1] * (H - 1) + [0], [1, 0] * (H // 2) + [1] * (H % 2),
            [0] * (H - 1) + [1], [0] * H]
    return torch.tensor([rows[c % 5] for c in range(C)], dtype=torch.float32,
                        device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,M,width,H,hd", [(5, 490, 64, 4, 16), (7, 37, 24, 4, 6),
                                            (2, 300, 96, 2, 64), (3, 1, 64, 8, 8),
                                            (2, 300, 256, 4, 64), (1, 130, 512, 8, 64)])
def test_masked_attn_kernels_match_plain(dev, dtype, C, M, width, H, hd):
    """The six head-masked kernels against their plain versions; a dropped
    head's output slab, da slab and dW slab exactly 0. Widths 256 and 512
    are those where the slab and sum kernels once staged the whole weight
    and refused to launch."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [5, 64])
@pytest.mark.parametrize("M", [1, 127, 128, 129, 490, 1100])
def test_head_dw_kernels_split_m_tiles_across_a_cluster(dev, dtype, C, M):
    """The two dW kernels at femnist_attn's widths, at M from one row to 9
    m-tiles (the last ragged, more than one cluster of 8): each against
    its plain version, dropped slabs and all-dropped clients exactly 0,
    two calls bitwise equal, one launch a call; and the launch geometry,
    a cluster of min(m-tiles, 8) blocks per (client, head)."""
    g = torch.Generator(device=dev).manual_seed(C + M)
    d, H, hd = 64, 4, 16
    r = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    x, gy_p, a, gy_m = r(C, M, d), r(C, M, H * hd), r(C, M, H * hd), r(C, M, d)
    mask = _head_masks(C, H, dev)
    dropped = (mask == 0).repeat_interleave(hd, dim=1)                 # (C, N)
    dead = mask.sum(1) == 0
    for name, kern, plain, args, slabs in (
            ("masked_head_proj_dw", attn.proj_dw, attn.masked_head_proj_dw_plain,
             (gy_p, x), lambda t: t.transpose(1, 2)),
            ("masked_head_merge_dw", attn.merge_dw, attn.masked_head_merge_dw_plain,
             (gy_m, a), lambda t: t)):
        before = ops.LAUNCHES[name].n
        got = kern(*args, mask)
        again = kern(*args, mask)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name].n == before + 2
        want = plain(*args, mask)
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel_err(got, want) <= _tol(dtype), name
        assert (slabs(got)[dropped] == 0).all(), name
        assert (got[dead] == 0).all(), name
        assert torch.equal(got, again), name
    T = -(-M // 128)
    for I, J in ((d, hd), (hd, d)):
        assert attn.dw_launch_geometry(C, M, H, I, J) == {
            "cluster": min(T, 8), "blocks": min(T, 8) * H * C, "m_tiles": T}


SLAB_SUM = ("masked_head_proj", "masked_head_proj_dx", "masked_head_merge",
            "masked_head_merge_da")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [5, 64])
@pytest.mark.parametrize("M", [1, 31, 32, 33, 490, 1100])
def test_head_slab_and_sum_kernels_at_femnist_attn_widths(dev, dtype, C, M):
    """The slab kernels (projection, merge da) and sum kernels (projection
    dx, merge) at femnist_attn's widths, at M from one row across the row
    tiles' edges to 1100: each against its plain version, dropped heads'
    slabs and all-dropped clients' sums exactly 0, two calls bitwise equal,
    one launch a call. At C 5, M 490 the launch has at least one block for
    each of the card's 132 SMs."""
    g = torch.Generator(device=dev).manual_seed(3 * C + M)
    d, H, hd = 64, 4, 16
    N = H * hd
    r = lambda *s, fan=1: (torch.randn(*s, generator=g, device=dev)
                           / math.sqrt(fan)).to(dtype)
    x, gy_p, w_p = r(C, M, d), r(C, M, N), r(C, d, N, fan=d)
    a, gy_m, w_m = r(C, M, N), r(C, M, d), r(C, N, d, fan=N)
    mask = _head_masks(C, H, dev)
    dropped = (mask == 0).repeat_interleave(hd, dim=1)                 # (C, N)
    dead = mask.sum(1) == 0
    runs = {"masked_head_proj": (attn.proj_fwd, attn.masked_head_proj_plain, (x, w_p)),
            "masked_head_proj_dx": (attn.proj_dx, attn.masked_head_proj_dx_plain, (gy_p, w_p)),
            "masked_head_merge": (attn.merge_fwd, attn.masked_head_merge_plain, (a, w_m)),
            "masked_head_merge_da": (attn.merge_da, attn.masked_head_merge_da_plain, (gy_m, w_m))}
    for name, (kern, plain, args) in runs.items():
        before = ops.LAUNCHES[name].n
        got = kern(*args, mask)
        again = kern(*args, mask)
        torch.cuda.synchronize()
        assert ops.LAUNCHES[name].n == before + 2
        want = plain(*args, mask)
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel_err(got, want) <= _tol(dtype), name
        assert torch.equal(got, again), name
        if name in ("masked_head_proj", "masked_head_merge_da"):
            assert (got.transpose(1, 2)[dropped] == 0).all(), name
        else:
            assert (got[dead] == 0).all(), name
    if C == 5 and M == 490:
        for name in SLAB_SUM:
            assert attn.mm_launch_geometry(name, C, M, d, H, hd)["blocks"] >= 132, name


@pytest.mark.parametrize("name", SLAB_SUM)
def test_head_slab_and_sum_shared_memory_does_not_grow_with_width(dev, name):
    """A slab or sum block stages a row tile of one head and one head's
    weight slab, in chunks of the reduction: its shared memory is the same
    at widths 128, 256 and 512, and far under the 227 KB a block may use."""
    smem = {w: attn.mm_launch_geometry(name, 2, 300, w, 4, 64)["smem"]
            for w in (128, 256, 512)}
    assert len(set(smem.values())) == 1, smem
    assert smem[512] <= 96 * 1024, smem


def test_masked_ffn_block_mask_entry_matches_plain(dev):
    """The block-masked ``masked_ffn`` on the card (the training kernels at
    C = 1, each launched once) against the same entry on CPU tensors (the
    plain versions): forward and gradients; dropped blocks' dW exactly 0."""
    g = torch.Generator().manual_seed(11)
    M, d, F = 200, 64, 512
    x = torch.randn(M, d, generator=g)
    w_in, w_gate = (torch.randn(d, F, generator=g) / 8 for _ in range(2))
    w_out = torch.randn(F, d, generator=g) / 16
    block_mask = torch.tensor([1, 0, 1, 1])
    cpu = [t.clone().requires_grad_() for t in (x, w_in, w_out, w_gate)]
    gpu = [t.to(dev).requires_grad_() for t in (x, w_in, w_out, w_gate)]
    y_cpu = ops.masked_ffn(cpu[0], cpu[1], cpu[2], block_mask, w_gate=cpu[3], act="silu")
    ops.reset_launch_counts()
    y_gpu = ops.masked_ffn(gpu[0], gpu[1], gpu[2], block_mask.to(dev), w_gate=gpu[3],
                           act="silu")
    y_cpu.square().sum().backward()
    y_gpu.square().sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert [counts[k] for k in ("masked_ffn_train_fwd", "masked_ffn_dx",
                                "masked_ffn_dw")] == [1, 1, 1]
    assert _rel_err(y_gpu.cpu(), y_cpu) <= 1e-4
    for tg, tc in zip(gpu, cpu):
        assert _rel_err(tg.grad.cpu(), tc.grad) <= 1e-4
    assert (gpu[1].grad[:, 128:256] == 0).all() and (gpu[2].grad[128:256] == 0).all()
    assert (gpu[3].grad[:, 128:256] == 0).all()


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


def _rwkv_inputs(B, S, H, N, dtype, dev, seed, logw=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, N, generator=g, device=dev).to(dtype)
               for _ in range(3))
    if logw is None:           # the model's decay range, -exp(w) for w in [-6, -1] + noise
        logw = -torch.exp(torch.rand(B, S, H, N, generator=g, device=dev) * 5 - 6
                          + 0.5 * torch.randn(B, S, H, N, generator=g, device=dev))
    else:
        logw = torch.full((B, S, H, N), logw, device=dev)
    u = 0.3 * torch.randn(H, N, generator=g, device=dev)
    return r, k, v, logw, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,S,H,N,chunk", [(2, 32, 3, 16, 8), (1, 24, 2, 32, 12),
                                           (3, 16, 1, 64, 16), (1, 512, 4, 64, 128),
                                           (2, 200, 3, 32, 100), (1, 512, 3, 64, 256),
                                           (2, 16, 3, 32, 1), (1, 1024, 2, 16, 512)])
def test_rwkv_chunk_kernel_matches_plain(dev, dtype, with_state, B, S, H, N, chunk):
    """y and the final state against the plain chunked version: both fp32
    inside, only the order of the sums differs (1e-4 relative ∞-norm)."""
    r, k, v, logw, u = _rwkv_inputs(B, S, H, N, dtype, dev, S * N + B)
    state = (0.5 * torch.randn(B, H, N, N, device=dev) if with_state else None)
    before = rwkv.launches.n
    y, st = ops.rwkv_chunk_scan(r, k, v, logw, u, chunk=chunk, state=state)
    torch.cuda.synchronize()
    assert rwkv.launches.n == before + 1
    yp, sp = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=chunk, state=state)
    assert y.dtype == st.dtype == torch.float32
    assert y.shape == (B, S, H, N) and st.shape == (B, H, N, N)
    assert _rel_err(y, yp) <= 1e-4 and _rel_err(st, sp) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_chunk_kernel_strong_decay_finite(dev, dtype):
    """logw = -8 over 128-token chunks: exponents down to -1016, no overflow."""
    r, k, v, logw, u = _rwkv_inputs(1, 256, 2, 64, dtype, dev, 8, logw=-8.0)
    y, st = ops.rwkv_chunk_scan(r, k, v, logw, u, chunk=128)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yp, sp = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=128)
    assert _rel_err(y, yp) <= 1e-4 and _rel_err(st, sp) <= 1e-4


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_chunk_kernel_repeats_bitwise_at_prefill_shape(dev, with_state):
    """B 1, S 512, H 40, N 64, chunk 128, bf16: two calls give the same bits
    (fixed-order sums, no atomics)."""
    r, k, v, logw, u = _rwkv_inputs(1, 512, 40, 64, torch.bfloat16, dev, 5)
    state = 0.5 * torch.randn(1, 40, 64, 64, device=dev) if with_state else None
    y0, s0 = ops.rwkv_chunk_scan(r, k, v, logw, u, chunk=128, state=state)
    y1, s1 = ops.rwkv_chunk_scan(r, k, v, logw, u, chunk=128, state=state)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1) and torch.equal(s0, s1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 128), (300, 200), (1024, 96), (17, 384),
                                   (1, 1), (33, 129), (2560, 8960), (1024, 1023),
                                   (2560, 8961)])
def test_invariant_stats_kernel_matches_plain(dev, dtype, shape):
    """Ragged d_in and n included, and rows whose stride is not a multiple
    of 16 bytes (narrower loads: (1024, 1023), (2560, 8961), (33, 129));
    fp32 sums in another order than the plain version's (1e-5); one
    counted launch a call."""
    g = torch.Generator(device=dev).manual_seed(shape[0] + shape[1])
    w0 = torch.randn(*shape, generator=g, device=dev)
    w1 = (w0 + 0.02 * torch.randn(*shape, generator=g, device=dev)).to(dtype)
    w0 = w0.to(dtype)
    before = stats.launches.n
    got = ops.invariant_stats(w0, w1)
    torch.cuda.synchronize()
    assert stats.launches.n == before + 1
    want = stats.invariant_stats_plain(w0, w1)
    assert got.dtype == torch.float32 and got.shape == (shape[1],)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d_in,n,dtype", [(1024, 1024, torch.float32),
                                           (1024, 1024, torch.bfloat16),
                                           (2560, 8960, torch.bfloat16)])
def test_invariant_stats_kernel_repeats_bitwise(dev, d_in, n, dtype):
    """Two calls give the same bits: the row groups' and the cluster's
    blocks' partials are added in a fixed order, with no atomics."""
    g = torch.Generator(device=dev).manual_seed(d_in + n)
    w0 = torch.randn(d_in, n, generator=g, device=dev).to(dtype)
    w1 = (w0.float() + 0.02 * torch.randn(d_in, n, generator=g, device=dev)).to(dtype)
    assert torch.equal(ops.invariant_stats(w0, w1), ops.invariant_stats(w0, w1))


def test_rwkv_and_stats_wrappers_refuse_what_the_kernels_do_not_take(dev):
    r, k, v, logw, u = _rwkv_inputs(1, 16, 2, 32, torch.float32, dev, 0)
    with pytest.raises(ValueError, match="on cpu"):
        ops.rwkv_chunk_scan(r, k, v, logw, u.cpu(), chunk=8)
    with pytest.raises(ValueError, match="on cpu"):
        ops.rwkv_chunk_scan(r, k, v, logw, u, chunk=8,
                            state=torch.zeros(1, 2, 32, 32))
    with pytest.raises(ValueError, match="dtype"):
        ops.rwkv_chunk_scan(r, k, v, logw.bfloat16(), u, chunk=8)
    r48, k48, v48, logw48, u48 = _rwkv_inputs(1, 16, 2, 48, torch.float32, dev, 0)
    with pytest.raises(ValueError, match="head size"):
        ops.rwkv_chunk_scan(r48, k48, v48, logw48, u48, chunk=8)
    r, k, v, logw, u = _rwkv_inputs(1, 2048, 1, 16, torch.float32, dev, 0)
    with pytest.raises(ValueError, match=f"chunk <= {rwkv.MAX_CHUNK}"):
        ops.rwkv_chunk_scan(r, k, v, logw, u, chunk=2048)
    w = torch.zeros(8, 16, device=dev)
    with pytest.raises(ValueError, match="on cpu"):
        ops.invariant_stats(w, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        ops.invariant_stats(w.T, w.T)


def test_rwkv_prefill_launches_the_kernel_once_per_layer(dev):
    """A smoke RWKV-6 model's prefill on the card: one B12 launch per layer,
    logits within 1e-4 of the same model on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config("rwkv6-3b").smoke(), dtype="float32")
    cpu = model.init_params(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 32)))
    ops.reset_launch_counts()
    lg, caches, _ = model.forward_seq(gpu, cfg, {"tokens": toks.to(dev)}, want_cache=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rwkv_chunk_scan"] == cfg.n_layers
    lc, _, _ = model.forward_seq(cpu, cfg, {"tokens": toks}, want_cache=True)
    assert _rel_err(lg.cpu(), lc) <= 1e-4


@pytest.fixture
def fp32_convs(dev):
    """True fp32 on the card: no TF32 in cuBLAS or cuDNN (cuDNN's convs
    default to TF32), restored afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield dev
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("name", ["femnist_cnn", "cifar_vgg9", "shakespeare_lstm",
                                  "synth_mlp"])
def test_paper_models_forward_backward_match_cpu(fp32_convs, name):
    """The paper's models on the card against the same call on the CPU,
    no kernel launched (they reach none, as in the reference): fp32
    logits within 1e-4 relative; make_loss gradients in fp64 within
    1e-10. In fp32 a max-pool window whose two largest inputs lie within
    the two devices' rounding of each other sends the gradient to another
    input (the CNN's conv grads then differ by ~3e-3 relative on this
    batch): a discontinuity of max pooling, not of the port, which fp64
    moves out of reach."""
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.fl.client import make_loss
    from repro_torch.models.small import MODELS
    cls = MODELS[name]
    rng = np.random.RandomState(1)
    if name == "shakespeare_lstm":
        x = torch.from_numpy(rng.randint(0, cls.vocab, (16, cls.seq_len)).astype(np.int32))
    else:
        x = torch.from_numpy(rng.randn(16, *cls.input_shape).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, cls.num_classes, 16))
    cpu = cls.init(0, device="cpu")
    ops.reset_launch_counts()
    with torch.no_grad():
        lc = cls.apply(cpu, x)
        lg = cls.apply(tree_map(lambda t: t.to(fp32_convs), cpu), x.to(fp32_convs))
    assert _rel_err(lg.cpu(), lc) <= 1e-4
    x64 = x if name == "shakespeare_lstm" else x.double()
    grads = []
    for d in ("cpu", fp32_convs):
        p = tree_map(lambda t: t.double().to(d).requires_grad_(True), cpu)
        loss = make_loss(cls)(p, x64.to(d), y.to(d))
        grads.append([g.cpu() for g in torch.autograd.grad(loss, tree_leaves(p))])
    torch.cuda.synchronize()
    assert set(ops.launch_counts().values()) == {0}
    for a, b in zip(*grads):
        assert _rel_err(b, a) <= 1e-10


@pytest.mark.parametrize("workload", ["femnist", "cifar10", "shakespeare", "synth"])
def test_sequential_round_matches_dense_fleet_round(fp32_convs, workload):
    """One round on the card, a straggler at rate 0.5: the sequential
    backend (extracted sub-model) and the dense fleet (masked params under
    vmap) give the same sim times, masks, deltas (2e-5, the reference's
    tolerance) and aggregate."""
    from repro_torch.core.dropout import get_policy
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.partition import partition_non_iid
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.fl import client, rounds, simulation
    from repro_torch.models.small import MODELS
    ds_name, model_name, lr, bs = simulation.WORKLOADS[workload]
    cls = MODELS[model_name]
    ds = make_dataset(ds_name, n=200, n_test=40, n_partitions=16)
    parts = partition_non_iid(ds, 4)
    speeds = simulation.default_speeds(4, (0,))

    def backend(name, client_cls):
        cs = [client_cls(i, cls, ds.x[parts[i]], ds.y[parts[i]], speed=speeds[i],
                         batch_size=bs, lr=lr) for i in range(4)]
        return rounds.make_backend(name, cls, cs, cls.UNIT_SPECS, device=fp32_convs)
    params = cls.init(0, device=fp32_convs)
    keep = {0: get_policy("random", cls.UNIT_SPECS, seed=2).keep_map(0.5)}
    ops.reset_launch_counts()
    seq = backend("sequential", client.SimClient).run_round(params, keep, {0: 0.5})
    flt = backend("fleet", client.FleetClient).run_round(params, keep, {0: 0.5})
    torch.cuda.synchronize()
    assert set(ops.launch_counts().values()) == {0}
    assert flt.sim_times == seq.sim_times
    for a, b in zip(seq.updates(), flt.updates()):
        assert (a.client_id, a.n_samples) == (b.client_id, b.n_samples)
        assert (a.mask is None) == (b.mask is None)
        for x, z in zip(tree_leaves(a.delta), tree_leaves(b.delta)):
            assert float((x - z).abs().max()) <= 2e-5
        if a.mask is not None:
            assert all(torch.equal(x, z) for x, z in
                       zip(tree_leaves(a.mask), tree_leaves(b.mask)))
    for x, z in zip(tree_leaves(seq.aggregate(params)), tree_leaves(flt.aggregate(params))):
        assert float((x - z).abs().max()) <= 2e-5


# ---------------------------------------------------------------------------
# the population and async layer on the card

def _pop_cfg(dev, **over):
    from repro_torch.fl.population import PopulationConfig
    kw = dict(n_clients=2000, cohort_size=16, workload="femnist_kernel",
              backend="fleet", use_kernels=True, n_partitions=16,
              samples_per_partition=40, straggler_frac_pop=0.2, seed=3,
              device=str(dev))
    kw.update(over)
    return PopulationConfig(**kw)


def test_zero_spread_async_equals_kernel_fleet_bitwise(dev):
    """buffer_k = concurrency = cohort 16, pass-through arrivals, kernels
    on: the async run is the kernel fleet's bit for bit (params, store,
    plans), and each clock is the running sum of the barrier times."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl.async_rounds import AsyncConfig, build_async_population
    from repro_torch.fl.population import build_population
    ops.reset_launch_counts()
    sync = build_population(_pop_cfg(dev))
    sync.run(3)
    asy = build_async_population(_pop_cfg(dev), AsyncConfig(buffer_k=16,
                                                            concurrency=16))
    asy.run(3)
    torch.cuda.synchronize()
    assert ops.launch_counts()["masked_ffn_dw"] == 4 * 3 * 2   # 4 steps a round, 2 runs
    for a, b in zip(tree_leaves(sync.server.params), tree_leaves(asy.server.params)):
        assert torch.equal(a, b)
    for f in ("speed_ema", "speed_hist", "straggler_ema", "dropout_rate",
              "rounds_participated", "in_flight"):
        assert np.array_equal(getattr(sync.store, f), getattr(asy.store, f),
                              equal_nan=True), f
    hs, ha = sync.server.history, asy.server.history
    assert [(h.stragglers, h.rates, h.round_time, h.threshold) for h in hs] == \
        [(h.stragglers, h.rates, h.round_time, h.threshold) for h in ha]
    assert any(h.stragglers for h in hs)
    # each clock is the barrier times added left to right (Python's sum of
    # floats compensates, so it can differ in the last place)
    assert [h.clock for h in ha] == list(itertools.accumulate(h.round_time for h in hs))


@pytest.mark.parametrize("workload", ["femnist_kernel", "femnist_attn"])
def test_padded_async_group_kernels_match_plain(dev, workload):
    """A dispatch group padded with 5 empty slots through the kernels: the
    pads' deltas are exactly 0 and the real clients' deltas match the
    plain versions' to 1e-4 relative."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl.population import build_population
    from repro_torch.fl.fleet import FleetEngine
    import dataclasses
    sim = build_population(_pop_cfg(dev, workload=workload))
    clients = sim._materialize(sim.cohort_ids())[:3]
    chunk = clients + [dataclasses.replace(clients[0], id=-(j + 1)) for j in range(5)]
    members = np.array([True] * 3 + [False] * 5)
    keep = {clients[1].id: sim.server.policy.keep_map(0.5)}

    def deltas(use_kernels):
        eng = FleetEngine(sim.model_cls, [dataclasses.replace(c) for c in chunk],
                          sim.model_cls.UNIT_SPECS, use_kernels=use_kernels,
                          device=dev)
        res = eng.run_cohort(sim.server.params, keep, {clients[1].id: 0.5},
                             members=members)
        return res, tree_leaves(res.deltas)
    ops.reset_launch_counts()
    res, got = deltas(True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["masked_ffn_train_fwd"] == res.engine.steps
    _, want = deltas(False)
    assert sorted(res.sim_times) == sorted(c.id for c in clients)
    for g, w in zip(got, want):
        assert not bool(g[3:].any())
        assert _rel_err(g[:3].cpu(), w[:3].cpu()) <= 1e-4


def test_sharded_partials_sum_to_numerator_bitwise_on_the_card(dev):
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.fl.population import build_population
    from repro_torch.fl.rounds import make_backend
    sim = build_population(_pop_cfg(dev, backend="sharded_fleet", n_shards=4))
    sim.run(2)
    clients = sim._materialize(sim.cohort_ids())
    ops.reset_launch_counts()
    be = make_backend("sharded_fleet", sim.model_cls, clients,
                      sim.model_cls.UNIT_SPECS, n_shards=4, use_kernels=True,
                      device=dev)
    res = be.run_round(sim.server.params, {}, {})
    torch.cuda.synchronize()
    assert ops.launch_counts()["masked_ffn_dx"] == 4 * be.engine.steps
    pr_num, pr_w = res.shard_partials
    num = tree_map(lambda a: ((a[0] + a[1]) + a[2]) + a[3], pr_num)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(num), tree_leaves(res.num)))
    assert torch.equal(((pr_w[0] + pr_w[1]) + pr_w[2]) + pr_w[3], res.w_per_mask)


# ---------------------------------------------------------------------------
# the MoE FFN and the encoder-decoder (plain torch, as in the reference)

def _moe_case(cfg, T, seed):
    """A DeepSeek-V2-Lite smoke MoE layer's params and T tokens whose
    router favours expert 0, so it overflows its capacity."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(seed)
    p = moe.init_moe(g, cfg, "cpu", torch.float32)
    p["router"][:, 0] += 0.5
    x = torch.randn(T, cfg.d_model, generator=g).abs() * 0.5
    return p, x


@pytest.mark.parametrize("case", ["overflow", "expert_mask_ties"])
def test_moe_tokens_card_matches_cpu(dev, case):
    """_moe_tokens on the card against the CPU port, fp32 with TF32 off:
    the same routing (picks per expert, sorted order; ties at probability 0
    under an expert mask broken by the lower expert) and outputs within
    1e-5; two calls on the card give the same bits."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").smoke(), dtype="float32")
    p, x = _moe_case(cfg, 40, seed=7)
    em = torch.tensor([1.0, 0.0, 0.0, 0.0]) if case == "expert_mask_ties" else None
    nm = (torch.rand(cfg.n_experts, cfg.moe_ff, generator=torch.Generator().manual_seed(1))
          > 0.3).float()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pd = {k: v.to(dev) for k, v in p.items() if k != "shared"}
        want = moe._moe_tokens(p, x, cfg, nm, em)
        got = moe._moe_tokens(pd, x.to(dev), cfg, nm.to(dev), None if em is None else em.to(dev))
        again = moe._moe_tokens(pd, x.to(dev), cfg, nm.to(dev), None if em is None else em.to(dev))
        r_cpu = moe._route(p, x, cfg, em)
        r_dev = moe._route(pd, x.to(dev), cfg, None if em is None else em.to(dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert int(r_cpu[2].max()) > moe.capacity(40, cfg)
    for a, b in zip(r_cpu[:3], r_dev[:3]):
        assert torch.equal(a, b.cpu())
    assert _rel_err(got[0].cpu(), want[0]) <= 1e-5
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "seamless-m4t-large-v2"])
def test_moe_and_encdec_prefill_then_decode_card_matches_cpu(dev, arch):
    """The smoke model in fp32 (TF32 off) on the card against the CPU: a
    prefill into a 14-slot cache (SeamlessM4T with frames) and two greedy
    decode steps (SeamlessM4T's self-attention through the GQA kernel),
    logits within 1e-3."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    cpu = model.init_params(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(dev), cpu)
    rng = np.random.RandomState(0)
    B, S = 3, 12
    toks = torch.from_numpy(rng.randint(0, 256, (B, S)))
    frames = torch.from_numpy((rng.randn(B, S, cfg.d_model) * 0.1).astype(np.float32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {}
        for name, params, d in (("cpu", cpu, "cpu"), ("cuda", gpu, dev)):
            batch = {"tokens": toks.to(d)}
            if cfg.is_encdec:
                batch["frames"] = frames.to(d)
            _, caches, _ = model.forward_seq(params, cfg, batch, want_cache=True, cache_len=14)
            tok, pos = toks[:, -1:].to(d), torch.full((B,), S, device=d)
            out = []
            for _ in range(2):
                logits, caches = model.decode_step(params, cfg, caches, tok, pos)
                out.append(logits.float().cpu())
                tok, pos = torch.argmax(logits[:, -1], -1)[:, None], pos + 1
            res[name] = out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(res["cpu"], res["cuda"]):
        assert bool(torch.isfinite(b).all())
        assert float((a - b).abs().max()) <= 1e-3


# ---------------------------------------------------------------------------
# the zoo train step: the masked FFN through the training kernels at C = 1

@pytest.mark.parametrize("M,d,F", [(1024, 5120, 13824), (48, 256, 512)])
def test_train_route_c1_matches_plain(dev, M, d, F):
    """apply_ffn's train-kernel route in bf16 (StableLM-2-12B's FFN at
    batch 4 x 256, and a small 128-aligned one): one layer mask of 3/4 of
    the blocks expanded to every row. B1's training form, B2 and B3 launch
    once each, each within 1e-2 of its plain version, and a dropped block's
    dW columns and rows are exactly 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import apply_ffn
    cfg = get_config("stablelm-12b").with_overrides(d_model=d, d_ff=F)
    g = torch.Generator(device=dev).manual_seed(M + F)
    r = lambda *s, fan: torch.randn(*s, generator=g, device=dev) / math.sqrt(fan)
    p = {"w_in": r(d, F, fan=d), "w_gate": r(d, F, fan=d), "w_out": r(F, d, fan=F)}
    p = {k: w.requires_grad_() for k, w in p.items()}
    x = r(2, M // 2, d, fan=1).to(torch.bfloat16).requires_grad_()
    nb = F // 128
    keep = torch.ones(nb, device=dev)
    keep[torch.randperm(nb, generator=g, device=dev)[:nb - round(nb * 0.75)]] = 0
    mask = keep.repeat_interleave(128)
    ops.reset_launch_counts()
    y = apply_ffn(p, x, cfg, neuron_mask=mask, kernels=True)
    gy = r(*y.shape, fan=1).to(torch.bfloat16)
    y.backward(gy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert [counts[k] for k in ("masked_ffn_train_fwd", "masked_ffn_dx", "masked_ffn_dw")] == [1, 1, 1]
    args = (x.detach().reshape(1, M, d), *(p[k].detach().to(torch.bfloat16)[None]
                                          for k in ("w_in", "w_out")),
            mask.expand(1, M, F).contiguous(), p["w_gate"].detach().to(torch.bfloat16)[None])
    gy1 = gy.reshape(1, M, d)
    assert _rel_err(y.detach().reshape(1, M, d), ffn.masked_ffn_batch_plain(*args, "silu")) <= 1e-2
    assert _rel_err(x.grad.reshape(1, M, d), ffn.masked_ffn_dx_plain(gy1, *args, "silu")) <= 1e-2
    dw_in, dw_out, dw_gate = ffn.masked_ffn_dw_plain(gy1, *args, "silu")
    for got, want in ((p["w_in"].grad, dw_in), (p["w_out"].grad, dw_out),
                      (p["w_gate"].grad, dw_gate)):
        assert got.dtype == torch.float32
        assert _rel_err(got, want[0]) <= 1e-2
    dropped = mask == 0
    assert (p["w_in"].grad[:, dropped] == 0).all() and (p["w_gate"].grad[:, dropped] == 0).all()
    assert (p["w_out"].grad[dropped] == 0).all()


def test_train_step_kernels_against_dense_on_the_card(dev):
    """A smoke-size StableLM (bf16 compute, fp32 params, block remat)
    masked step from the same params and batch with and without the
    kernels: with them B1's training form launches 2L times (forward and
    recompute), B2 and B3 L times; without, none. Loss within 1e-2, the FFN
    gradients within 2e-2 (relative 2-norm)."""
    from repro_torch.configs import get_config
    from repro_torch.core.transformer_hooks import full_masks
    from repro_torch.core.tree import tree_map
    from repro_torch.launch import steps
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import model
    cfg = get_config("stablelm-12b").smoke()
    params = model.init_params(cfg, seed=0, device=dev)
    masks = tree_map(lambda m: m.to(dev), full_masks(cfg))
    masks[0]["l0"]["ffn"][:, 128:256] = 0
    batch = synth_batch(np.random.RandomState(0), cfg, 4, 65, device=dev)
    res = {}
    for kernels in (True, False):
        ops.reset_launch_counts()
        (loss, _), grads = steps.make_grads_fn(cfg, kernels)(params, batch, masks)
        torch.cuda.synchronize()
        res[kernels] = (float(loss), grads["stack"]["seg0"]["l0"]["ffn"], ops.launch_counts())
    L = cfg.n_layers
    assert [res[True][2][k] for k in ("masked_ffn_train_fwd", "masked_ffn_dx",
                                      "masked_ffn_dw")] == [2 * L, L, L]
    assert set(res[False][2].values()) == {0}
    assert abs(res[True][0] - res[False][0]) <= 1e-2 * abs(res[False][0])
    for k in ("w_in", "w_gate", "w_out"):
        a, b = res[True][1][k], res[False][1][k]
        assert float((a - b).norm() / b.norm()) <= 2e-2, k
        assert (a[:, :, 128:256] == 0).all() if k != "w_out" else (a[:, 128:256] == 0).all()


def test_run_fluid_calibration_statistics_are_nonzero_on_the_card(dev, monkeypatch):
    """run_fluid on the card at smoke size: every calibration's unit
    statistics are positive (a snapshot, not an alias of the params the
    optimizer updates in place), its masks keep 3/4 of the blocks, and the
    losses are finite."""
    from repro_torch.configs import get_config
    from repro_torch.core import transformer_hooks as hooks
    from repro_torch.launch import train
    cfg = get_config("stablelm-12b").smoke()
    stats, masks = [], []
    for name, out in (("ffn_unit_stats", stats), ("build_masks", masks)):
        fn = getattr(hooks, name)
        monkeypatch.setattr(hooks, name, lambda *a, _fn=fn, _out=out, **kw:
                            _out.append(_fn(*a, **kw)) or _out[-1])
    _, log = train.run_fluid(cfg, 6, 2, 32, calibrate_every=3, log_every=100, device="cuda")
    assert len(stats) == len(masks) == 2
    for st, ms in zip(stats, masks):
        assert bool((st[0]["l0"]["ffn"] > 0).all())
        kept = ms[0]["l0"]["ffn"].reshape(cfg.n_layers, -1, 128).amax(-1).sum(-1)
        assert (kept == round(cfg.d_ff // 128 * 0.75)).all()
    assert all(np.isfinite(loss) for loss, _, _ in log)


def test_rwkv_chunk_kernel_refuses_autograd(dev):
    """B12 has no backward: on the card, the wrapper given an input that
    requires grad with grad mode on raises. Training takes the plain chunked
    form in tmix_seq (no launch), whose gradients are the CPU's; under
    no_grad the same tmix_seq launches, and matches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import rwkv6
    g = torch.Generator(device=dev).manual_seed(0)
    r, k, v = (torch.randn(1, 16, 2, 64, generator=g, device=dev) for _ in range(3))
    logw = -torch.rand(1, 16, 2, 64, generator=g, device=dev) - 0.1
    u = torch.randn(2, 64, generator=g, device=dev)
    with pytest.raises(ValueError, match="no backward"):
        ops.rwkv_chunk_scan(r.clone().requires_grad_(), k, v, logw, u, chunk=8)
    cfg = dataclasses.replace(get_config("rwkv6-3b").smoke(), dtype="float32",
                              param_dtype="float32", rwkv_chunk=8)
    cpu = rwkv6.init_tmix(torch.Generator().manual_seed(0), cfg, "cpu", torch.float32)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, cfg.d_model)
                         .astype(np.float32))
    grads, ys = [], []
    ops.reset_launch_counts()
    for d in ("cpu", dev):
        p = tree_map(lambda t: t.to(d).requires_grad_(True), cpu)
        y, _, st = rwkv6.tmix_seq(p, x.to(d), cfg)
        grads.append([t.cpu() for t in torch.autograd.grad(
            y.square().sum() + st.sum(), tree_leaves(p))])
        ys.append(y.detach().cpu())
    assert ops.launch_counts()["rwkv_chunk_scan"] == 0
    assert _rel_err(ys[1], ys[0]) <= 1e-4
    assert all(_rel_err(a, b) <= 1e-4 for a, b in zip(*grads) if float(b.norm()) > 0)
    with torch.no_grad():
        y2, _, _ = rwkv6.tmix_seq(tree_map(lambda t: t.to(dev), cpu), x.to(dev), cfg)
    assert ops.launch_counts()["rwkv_chunk_scan"] == 1
    assert bool(torch.isfinite(y2).all()) and _rel_err(y2.cpu(), ys[0]) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,N,chunk,with_state", [
    (1, 512, 40, 64, 128, False), (2, 96, 3, 32, 48, False), (1, 40, 2, 16, 40, False),
    (1, 256, 2, 64, 256, False), (1, 512, 40, 64, 128, True), (2, 96, 3, 32, 48, True),
    (2, 256, 3, 16, 128, True), (1, 256, 4, 16, 64, False), (1, 1024, 2, 16, 512, False),
    (1, 1024, 1, 64, 1024, True), (2, 16, 3, 32, 1, True)])
def test_rwkv_chunk_bf16_form_matches_plain(dev, dtype, B, S, H, N, chunk, with_state):
    """B12's bf16 chunk form (rwkv_out_bf16_kernel) against its plain form:
    relative 2-norm <= 5e-4 and ∞-norm <= 1e-2 (a score whose bf16
    rounding flips between the two is a sparse error: a 1e-7 relative
    change of logw moves the plain form by ~3e-5 in 2-norm, while the fp32
    form lies ~2e-3 away), the state as the fp32 form's (1e-4); its own
    launch counter; two calls the same bits. Chunks past 128 take several
    key tiles; a non-zero state feeds the inter term."""
    g = torch.Generator(device=dev).manual_seed(S + N)
    r, k, v = (torch.randn(B, S, H, N, generator=g, device=dev).to(dtype) for _ in range(3))
    u = 0.1 * torch.randn(H, N, generator=g, device=dev)
    logw = -torch.exp(torch.rand(H, N, generator=g, device=dev) * 5 - 6
                      + 0.1 * torch.randn(B, S, H, N, generator=g, device=dev))
    state = 0.5 * torch.randn(B, H, N, N, generator=g, device=dev) if with_state else None
    ops.reset_launch_counts()
    with torch.no_grad():
        y, st = ops.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=chunk, state=state)
        y2, _ = ops.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=chunk, state=state)
    assert ops.launch_counts()["rwkv_chunk_scan_bf16"] == 2
    assert ops.launch_counts()["rwkv_chunk_scan"] == 0
    yp, sp = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=chunk, state=state,
                                        chunk_dtype=torch.bfloat16)
    assert torch.equal(y, y2)
    assert float((y - yp).norm() / yp.norm()) <= 5e-4
    assert _rel_err(y, yp) <= 1e-2 and _rel_err(st, sp) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rwkv_chunk_bf16_form_strong_decay_finite(dev, dtype):
    """logw = -8 over 128-token chunks in the bf16 form: the masked pairs
    (j >= t) have exponents up to +1016, whose e^x is inf; the kernel
    selects 0 for them, so y is finite and within the bf16 form's bounds."""
    r, k, v, logw, u = _rwkv_inputs(1, 256, 2, 64, dtype, dev, 8, logw=-8.0)
    y, st = ops.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=128)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yp, sp = rwkv.rwkv_chunk_scan_plain(r, k, v, logw, u, chunk=128,
                                        chunk_dtype=torch.bfloat16)
    assert float((y - yp).norm() / yp.norm()) <= 5e-4
    assert _rel_err(y, yp) <= 1e-2 and _rel_err(st, sp) <= 1e-4


def test_rwkv_chunk_bf16_form_graphs_on_two_streams(dev):
    """The bf16 form keeps no state between launches: two CUDA graphs of it
    (captured on one capture stream) replayed at once on two streams, while
    an eager call runs on the current stream, each give the eager call's
    bits."""
    r, k, v, logw, u = _rwkv_inputs(1, 512, 8, 64, torch.bfloat16, dev, 5)
    with torch.no_grad():
        want, _ = ops.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=128)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):              # warm-up off the capture
            ops.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=128)
        torch.cuda.current_stream().wait_stream(side)
        graphs, outs = [], []
        for _ in range(2):
            graphs.append(torch.cuda.CUDAGraph())
            with torch.cuda.graph(graphs[-1]):
                outs.append(ops.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=128)[0])
        streams = [torch.cuda.Stream() for _ in graphs]
        for s, graph in zip(streams, graphs):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                for _ in range(4):
                    graph.replay()
        eager, _ = ops.rwkv_chunk_scan_bf16(r, k, v, logw, u, chunk=128)
        for s in streams:
            torch.cuda.current_stream().wait_stream(s)
        torch.cuda.synchronize()
    assert torch.equal(eager, want)
    for out in outs:
        assert torch.equal(out, want)


def test_rwkv_bf16_packed_product_rounds_as_fp32(dev):
    """rwkv_out_bf16_kernel forms bf16(r)·bf16(k) with mul.rn.bf16x2 (the
    exact product rounded once); the plain form multiplies in fp32 and
    rounds to bf16. Over every pair of bf16 values but NaNs, subnormals
    included, the two give the same bits."""
    res = rwkv.bf16_product_check()
    assert res["pairs_differing"] == 0, res


# ---------------------------------------------------------------------------
# repro_torch.analysis on the card: the dropped-dW NaN poison through B1-B9
# at the zoo's widths, host-sync regions, mask-as-data

def _zoo_ffn_shapes():
    from repro_torch.configs.base import all_configs
    out = {}
    for arch, cfg in sorted(all_configs().items()):
        for F in sorted({cfg.d_ff, cfg.moe_ff}):
            out.setdefault((cfg.d_model, F), (cfg.ffn_kind, arch))
    return [(d, F, kind) for (d, F), (kind, _) in sorted(out.items())]


def _zoo_head_layouts():
    from repro_torch.analysis.kernel_contracts import head_layouts
    return sorted(head_layouts())


@pytest.mark.parametrize("d,F,kind", _zoo_ffn_shapes() + [(64, 1024, "gelu"), (64, 256, "gelu")])
def test_ffn_poisoned_dropped_blocks_at_zoo_widths(dev, d, F, kind):
    """B1-B3 through ops.masked_ffn, bf16, M 8, every other 128-block of
    w_in / w_out / w_gate NaN: a finite forward, the dropped dW exactly 0,
    the rest within 1e-2 of the plain versions on clean weights; a width
    that is not 128-aligned (DeepSeek-V2-Lite's dense 10944) refused."""
    from repro_torch.analysis import contracts
    res = contracts.ffn_poison_case(F, kind, "cuda", d=d, M=8, dtype=torch.bfloat16)
    if F % 128:
        assert "multiple of BLOCK_NEURONS=128" in res["refused"]
        return
    assert contracts.ffn_case_violations("x", res, torch.bfloat16) == []
    assert all(res["dropped_zero"].values())


@pytest.mark.parametrize("H,hd,d", _zoo_head_layouts())
def test_attention_poisoned_dropped_heads_at_zoo_layouts(dev, H, hd, d):
    """B4-B9 through ops.masked_attention at C 1, bf16, B 1, S 8, every
    other head's Q/K/V columns and O rows NaN: a finite forward, the dropped
    dW exactly 0, the rest within 1e-2 of the plain versions on clean
    weights. (64, 128, 8192) needs the dW kernels' chunks on the grid's x
    axis (65536 blocks along y would exceed its 65535)."""
    from repro_torch.analysis import contracts
    res = contracts.attn_poison_case(H, "cuda", B=1, S=8, d=d, hd=hd, dtype=torch.bfloat16)
    assert contracts.attn_case_violations("x", res, torch.bfloat16) == []
    assert all(res["dropped_zero"].values())


def test_head_dw_kernels_take_more_than_65535_chunks_a_client(dev):
    """The dW slab of (H 64, hd 128, d 8192): 16 x 64 chunks a head, 65536
    (client, head, chunk) blocks, against the plain versions in fp32."""
    C, M, H, hd, d = 1, 8, 64, 128, 8192
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(C, M, d, generator=g, device=dev)
    gy = torch.randn(C, M, H * hd, generator=g, device=dev)
    a = torch.randn(C, M, H * hd, generator=g, device=dev)
    gd = torch.randn(C, M, d, generator=g, device=dev)
    mask = (torch.arange(H, device=dev) % 3 != 1).float()[None]
    assert _rel_err(attn.proj_dw(gy, x, mask), attn.masked_head_proj_dw_plain(gy, x, mask)) <= 1e-4
    assert _rel_err(attn.merge_dw(gd, a, mask), attn.masked_head_merge_dw_plain(gd, a, mask)) <= 1e-4


def test_analysis_contracts_clean_on_the_card(dev):
    from repro_torch.analysis import contracts
    assert contracts.run_contracts(device="cuda", only=["dw-zero-ffn", "dw-zero-attn",
                                                        "no-host-sync"]) == []


def test_mask_as_data_contracts_clean_on_the_card(dev):
    from repro_torch.analysis import contracts
    names = [n for n in contracts.CHECKS if n.startswith("mask-as-data")]
    assert contracts.run_contracts(device="cuda", only=names) == []
