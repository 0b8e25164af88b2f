"""The arithmetic of the masked-FFN training forward (B1), dx (B2) and dW
(B3) on the tensor-core route, on the CPU.

bf16 calls with at least ``masked_ffn.TC_ROWS`` (128) rows a client and d a
multiple of ``TC_DEPTH`` (64) run ``csrc/masked_ffn_train_tc.cu``
(``masked_ffn.tc_route``). Its up kernel takes a (128-row tile, 128-neuron
f-block) when some row of the tile keeps some neuron of the block, computes
the pre-activations as MMAs 16 deep, in k order, applies the exact per-row
mask and the activation, and writes the hidden activation rounded to bf16
(forward) or dzh and dzg in fp32, each split into three bf16 terms hi + mid
+ lo (dx; dW also hm). Its down kernel sums over the tile's kept f-blocks
in f order, 64 neurons a stage (dx: W_in's stage, then W_gate's), 16 deep a
step, dx's three terms of a step against the one weight fragment, all into
one fp32 accumulator an output element, rounded once to bf16. dW's product
kernel sums xᵀ·dzh, xᵀ·dzg and gyᵀ·hm (dW_out transposed) over the f-block's
kept row tiles in row order, 16 rows a step, the hi, mid and lo terms of a
step against the one x (or gy) fragment, into one fp32 accumulator an
element, rounded once to bf16.

A torch emulation of that order is held here to the Pallas ``_fwd_impl``,
``_dx_impl`` and ``_dw_impl`` (interpret mode, 128-row blocks, per-row
masks, a client at a time) to 1e-2 relative ∞-norm, as
``tests/test_torch_ffn_fwd_dx_split.py`` holds the FFMA route's bf16 order:
both round the output to bf16, and the forward's hidden activation to bf16
where a near tie may round either way. Its fp32 accumulators are held to
1e-5 of fp64 sums of the same terms: the forward's is the sum of the
bf16-rounded hidden activation's products (not the unrounded one's), dx's
the sum of fp32 dzh's and dzg's products, dW's of fp32 dzh's, dzg's and
hm's (dz or hm rounded to one bf16 term would be ~1e-3 off). The split is
shown exact.
M 128 and a ragged 200, d 64 and 128, F 256 and 512, gated and ungated,
silu and gelu; a client drops an f-block everywhere, one keeps
neurons row by row with its first 40 rows keeping nothing and its second
row tile dropping f-block 0 (a partly kept tile, a skipped tile beside a
kept one), one keeps nothing.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.masked_ffn import _dw_impl, _dx_impl, _fwd_impl  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import masked_ffn as ffn  # noqa: E402

TC, BN, KC, KS = ffn.TC_ROWS, 128, 64, 16   # row tile, f-block, stage depth, MMA depth


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trunc(v):
    """The bf16 whose bits are the top 16 of v's (round toward zero)."""
    return (v.contiguous().view(torch.int32) & -65536).view(torch.float32)


def split3(v):
    """The kernel's split of fp32 v into three bf16-valued terms."""
    finite = torch.isfinite(v)
    hi = _trunc(v)
    r1 = torch.where(finite, v - hi, 0.0)
    mid = _trunc(r1)
    lo = _trunc(r1 - mid)
    hi = torch.where(finite, hi, v.bfloat16().float())
    return hi, mid, lo


def _mma_sum(a, b, acc=None):
    """acc + a·b as MMAs KS deep add it: each step's product in fp32, added
    in k order."""
    acc = torch.zeros(a.shape[0], b.shape[1]) if acc is None else acc
    for k in range(0, a.shape[1], KS):
        acc = acc + a[:, k:k + KS] @ b[k:k + KS]
    return acc


def _up_tiles(kind, x, w_in, w_out, mask, w_gate, act, gy):
    """The up kernel: each kept (client, row tile, f-block)'s scratch (the
    hidden activation; or the split dzh [, dzg], and for dW then hm's), and
    how many times each tile was computed."""
    C, M, d = x.shape
    F = w_in.shape[2]
    nrt, nfb = -(-M // TC), F // BN
    taken = np.zeros((C, nrt, nfb), int)
    scratch = {}
    for c in range(C):
        for rt in range(nrt):
            rows = slice(rt * TC, min(rt * TC + TC, M))
            xs, rm = x[c, rows], mask[c, rows]
            for fb in range(nfb):
                f = slice(fb * BN, fb * BN + BN)
                r = rm[:, f]
                if not bool((r != 0).any()):
                    continue
                taken[c, rt, fb] += 1
                zh = _mma_sum(xs, w_in[c][:, f])
                zg = None if w_gate is None else _mma_sum(xs, w_gate[c][:, f])
                if kind == "fwd":
                    v = ffn._ACTS[act](zh) if zg is None else ffn._ACTS[act](zg) * zh
                    scratch[c, rt, fb] = [torch.where(r != 0, v * r, 0.0).bfloat16().float()]
                    continue
                gh = _mma_sum(gy[c, rows], w_out[c][f].T)
                if zg is None:
                    parts = [gh * r * ffn._DACTS[act](zh)]
                    hm = ffn._ACTS[act](zh) * r
                else:
                    ghm, a = gh * r, ffn._ACTS[act](zg)
                    parts = [ghm * a, ghm * zh * ffn._DACTS[act](zg)]
                    hm = a * zh * r
                scratch[c, rt, fb] = [split3(v) for v in parts + [hm] * (kind == "dw")]
    return scratch, taken


def emulate(kind, x, w_in, w_out, mask, w_gate, act, gy=None):
    """The forward (kind "fwd") or dx as the tensor-core route sums it: the
    bf16 output, the fp32 accumulator before that rounding, each kept
    block's scratch (the hidden activation, or the split dzh [, dzg]), and
    how many times each (client, row tile, f-block) was computed."""
    C, M, d = x.shape
    F = w_in.shape[2]
    nrt, nfb = -(-M // TC), F // BN
    acc_all = torch.zeros(C, M, d)
    scratch, taken = _up_tiles(kind, x, w_in, w_out, mask, w_gate, act, gy)
    for c in range(C):
        for rt in range(nrt):
            rows = slice(rt * TC, min(rt * TC + TC, M))
            kept = [fb for fb in range(nfb) if (c, rt, fb) in scratch]
            acc = torch.zeros(rows.stop - rows.start, d)
            for fb in kept:                       # the down kernel, f order
                for sub in range(0, BN, KC):
                    if kind == "fwd":
                        h, k = scratch[c, rt, fb][0], slice(fb * BN + sub, fb * BN + sub + KC)
                        acc = _mma_sum(h[:, sub:sub + KC], w_out[c][k], acc)
                        continue
                    for mat, w in enumerate((w_in, w_gate)[:len(scratch[c, rt, fb])]):
                        terms = scratch[c, rt, fb][mat]
                        for kk in range(sub, sub + KC, KS):
                            wk = w[c][:, fb * BN + kk:fb * BN + kk + KS].T
                            for t in terms:       # hi, mid, lo against one fragment
                                acc = acc + t[:, kk:kk + KS] @ wk
            acc_all[c, rows] = acc
    return acc_all.bfloat16().float(), acc_all, scratch, taken


def _dw_operands(x, gy, parts):
    """dW's products as (a, terms) pairs: xᵀ·dzh [, xᵀ·dzg], gyᵀ·hm (the
    last dW_out transposed)."""
    return [(gy if i == len(parts) - 1 else x, t) for i, t in enumerate(parts)]


def emulate_dw(x, gy, w_in, w_out, mask, w_gate, act):
    """dW as the tensor-core route sums it: (dW_in, dW_out, dW_gate) in
    bf16 (dW_gate None ungated), the fp32 accumulators of dW_in [, dW_gate],
    dW_outᵀ (each (C, d, F)) before that rounding, the up kernel's scratch
    and how many times each (client, row tile, f-block) was computed."""
    C, M, d = x.shape
    F = w_in.shape[2]
    nrt, nfb = -(-M // TC), F // BN
    scratch, taken = _up_tiles("dw", x, w_in, w_out, mask, w_gate, act, gy)
    accs = [torch.zeros(C, d, F) for _ in range(2 if w_gate is None else 3)]
    for c in range(C):
        for fb in range(nfb):
            f = slice(fb * BN, fb * BN + BN)
            for rt in range(nrt):                 # the kept row tiles, in row order
                if (c, rt, fb) not in scratch:
                    continue
                m0, m1 = rt * TC, min(rt * TC + TC, M)
                for acc, (a, terms) in zip(accs, _dw_operands(x, gy, scratch[c, rt, fb])):
                    for k in range(m0, m1, KS):   # 16 rows a step: hi, mid, lo
                        ak = a[c, k:min(k + KS, m1)].T
                        for t in terms:
                            acc[c][:, f] += ak @ t[k - m0:k - m0 + KS]
    rounded = [t.bfloat16().float() for t in accs]
    dws = (rounded[0], rounded[-1].transpose(1, 2), None if w_gate is None else rounded[1])
    return dws, accs, scratch, taken


def _f64_dw(x, gy, scratch, shape, one_term_hm=False):
    """fp64 sums of dW's products over the same kept tiles, from fp32 dzh,
    dzg and hm (hm rounded to one bf16 term where ``one_term_hm``)."""
    M = x.shape[1]
    outs = None
    for (c, rt, fb), parts in scratch.items():
        outs = outs or [torch.zeros(shape, dtype=torch.float64) for _ in parts]
        rows, f = slice(rt * TC, min(rt * TC + TC, M)), slice(fb * BN, fb * BN + BN)
        for i, (out, (a, terms)) in enumerate(zip(outs, _dw_operands(x, gy, parts))):
            v = sum(t.double() for t in terms)
            if one_term_hm and i == len(parts) - 1:
                v = v.float().bfloat16().double()
            out[c][:, f] += a[c, rows].double().T @ v
    return outs


def _inputs(M, d, F, gated, seed):
    """Three clients: 0 drops f-block 1 everywhere; 1 keeps neurons row by
    row (0.6), its rows 0-39 keep nothing and its rows from 128 on drop
    f-block 0; 2 keeps nothing. Values on the bf16 grid, x at half scale."""
    rng = np.random.RandomState(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float()
    C = 3
    x = bf(0.5 * rng.randn(C, M, d))
    gy = bf(rng.randn(C, M, d))
    w_in = bf(rng.randn(C, d, F) / np.sqrt(d))
    w_out = bf(rng.randn(C, F, d) / np.sqrt(F))
    w_gate = bf(rng.randn(C, d, F) / np.sqrt(d)) if gated else None
    mask = np.ones((C, M, F), np.float32)
    mask[0, :, BN:2 * BN] = 0.0
    mask[1] = (rng.rand(M, F) < 0.6)
    mask[1, :40] = 0.0
    mask[1, TC:, :BN] = 0.0
    mask[2] = 0.0
    return x, gy, w_in, w_out, w_gate, torch.from_numpy(mask)


@functools.lru_cache(maxsize=None)
def _pallas(kind, act):
    def fwd(x, wi, wo, wg, m):
        return _fwd_impl(x, wi, wo, wg, m, act=act, block_m=TC, interpret=True, per_row=True)

    def dx(gy, x, wi, wo, wg, m):
        return _dx_impl(gy, x, wi, wo, wg, m, act=act, block_m=TC, interpret=True, per_row=True)

    def dw(gy, x, wi, wo, wg, m):
        return _dw_impl(gy, x, wi, wo, wg, m, act=act, block_m=TC, interpret=True, per_row=True)
    return jax.jit({"fwd": fwd, "dx": dx, "dw": dw}[kind])


def _reference(kind, x, gy, w_in, w_out, w_gate, mask, act):
    fn, out = _pallas(kind, act), []
    j = lambda t: jnp.asarray(t.numpy(), jnp.bfloat16)
    for c in range(x.shape[0]):
        args = (j(x[c]), j(w_in[c]), j(w_out[c]), None if w_gate is None else j(w_gate[c]),
                jnp.asarray(mask[c].numpy()))
        y = fn(*args) if kind == "fwd" else fn(j(gy[c]), *args)
        out.append([None if t is None else np.asarray(t.astype(jnp.float32))
                    for t in (y if kind == "dw" else [y])])
    return [None if o[0] is None else np.stack(o) for o in zip(*out)]


def _f64_acc(kind, x, gy, w_in, w_out, w_gate, scratch, mask, act, round_h=True):
    """fp64 sums of the down kernel's terms: the forward's of the scratch's
    (rounded) hidden activation, or of it unrounded; dx's of fp32 dzh, dzg."""
    C, M, d = x.shape
    out = torch.zeros(C, M, d, dtype=torch.float64)
    for (c, rt, fb), parts in scratch.items():
        rows, f = slice(rt * TC, min(rt * TC + TC, M)), slice(fb * BN, fb * BN + BN)
        if kind == "fwd":
            h = parts[0].double()
            if not round_h:
                r = mask[c, rows, f]
                zh = x[c, rows].double() @ w_in[c][:, f].double()
                v = (ffn._ACTS[act](zh) if w_gate is None else
                     ffn._ACTS[act](x[c, rows].double() @ w_gate[c][:, f].double()) * zh)
                h = torch.where(r != 0, v * r.double(), 0.0)
            out[c, rows] += h @ w_out[c][f].double()
            continue
        for mat, w in enumerate((w_in, w_gate)[:len(parts)]):
            dz = sum(t.double() for t in parts[mat])
            out[c, rows] += dz @ w[c][:, f].double().T
    return out


CASES = [(128, 64, 256, "silu", True), (200, 128, 512, "gelu", False),
         (200, 64, 256, "gelu", True), (128, 128, 512, "silu", False)]


@pytest.mark.parametrize("kind", ["fwd", "dx"])
@pytest.mark.parametrize("M,d,F,act,gated", CASES)
def test_tc_order_matches_pallas(kind, M, d, F, act, gated):
    x, gy, w_in, w_out, w_gate, mask = _inputs(M, d, F, gated, seed=M + d + F + gated)
    got, acc, scratch, taken = emulate(kind, x, w_in, w_out, mask, w_gate, act, gy=gy)
    want, = _reference(kind, x, gy, w_in, w_out, w_gate, mask, act)
    nrt = -(-M // TC)
    kept = (np.pad(mask.numpy(), ((0, 0), (0, nrt * TC - M), (0, 0)))
            .reshape(3, nrt, TC, F // BN, BN).max(axis=(2, 4)) != 0)
    assert (taken == kept).all()                   # each kept tile once, no skipped one
    assert not kept[0, :, 1].any() and not kept[2].any()
    assert kept[1, 0, 0] and (M <= TC or not kept[1, 1, 0])
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-2, (kind, err)
    dead = mask.amax(dim=2) == 0                   # rows no f-block keeps
    assert dead[1, :40].all() and dead[2].all()
    assert (got[dead] == 0).all() and (acc[dead] == 0).all()
    # the accumulator against fp64 sums of the same terms
    exact = _f64_acc(kind, x, gy, w_in, w_out, w_gate, scratch, mask, act)
    scale = float(exact.abs().max())
    assert float((acc.double() - exact).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("M,d,F,act,gated", CASES[:2])
def test_tc_forward_rounds_h_before_the_down_sum(M, d, F, act, gated):
    """The forward's accumulator is the sum over the bf16-rounded hidden
    activation: within 1e-5 of that sum in fp64, and ~1e-3 from the sum
    over the unrounded one."""
    x, gy, w_in, w_out, w_gate, mask = _inputs(M, d, F, gated, seed=7)
    _, acc, scratch, _ = emulate("fwd", x, w_in, w_out, mask, w_gate, act)
    for parts in scratch.values():
        assert torch.equal(parts[0], parts[0].bfloat16().float())
    rounded = _f64_acc("fwd", x, gy, w_in, w_out, w_gate, scratch, mask, act)
    unrounded = _f64_acc("fwd", x, gy, w_in, w_out, w_gate, scratch, mask, act, round_h=False)
    scale = float(rounded.abs().max())
    assert float((acc.double() - rounded).abs().max()) <= 1e-5 * scale
    assert float((acc.double() - unrounded).abs().max()) >= 1e-4 * scale


def test_tc_dx_split_keeps_fp32_products():
    """dx's accumulator is within 1e-5 of the fp64 sum of fp32 dzh·W_inᵀ +
    dzg·W_gateᵀ; dz rounded to a single bf16 term would be ~1e-3 off."""
    M, d, F, act = 200, 64, 256, "silu"
    x, gy, w_in, w_out, w_gate, mask = _inputs(M, d, F, True, seed=11)
    _, acc, scratch, _ = emulate("dx", x, w_in, w_out, mask, w_gate, act, gy=gy)
    exact = _f64_acc("dx", x, gy, w_in, w_out, w_gate, scratch, mask, act)
    one_term = {k: [[sum(t.double() for t in p).float().bfloat16().float()] for p in v]
                for k, v in scratch.items()}
    coarse = _f64_acc("dx", x, gy, w_in, w_out, w_gate, one_term, mask, act)
    scale = float(exact.abs().max())
    assert float((acc.double() - exact).abs().max()) <= 1e-5 * scale
    assert float((coarse - exact).abs().max()) >= 1e-4 * scale


@pytest.mark.parametrize("M,d,F,act,gated", CASES)
def test_tc_dw_order_matches_pallas(M, d, F, act, gated):
    """dW summed as the product kernel sums it against the Pallas
    ``_dw_impl`` (1e-2 relative ∞-norm); its fp32 accumulators within 1e-5
    of fp64 sums of the same terms; each kept tile computed once by the up
    kernel; the dW of an f-block that no row keeps exactly 0."""
    x, gy, w_in, w_out, w_gate, mask = _inputs(M, d, F, gated, seed=M + d + F + gated)
    got, accs, scratch, taken = emulate_dw(x, gy, w_in, w_out, mask, w_gate, act)
    want = _reference("dw", x, gy, w_in, w_out, w_gate, mask, act)
    nrt = -(-M // TC)
    kept = (np.pad(mask.numpy(), ((0, 0), (0, nrt * TC - M), (0, 0)))
            .reshape(3, nrt, TC, F // BN, BN).max(axis=(2, 4)) != 0)
    assert (taken == kept).all()
    assert len(got) == len(want) == 3 and (got[2] is None) is (want[2] is None) is not gated
    for a, b in zip(got, want):
        if b is not None:
            err = np.abs(a.numpy() - b).max() / np.abs(b).max()
            assert err <= 1e-2, err
    dropped = torch.from_numpy(~kept.any(axis=1)).repeat_interleave(BN, dim=1)   # (C, F)
    assert dropped[0, BN:2 * BN].all() and dropped[2].all() and not dropped[1].any()
    for acc in accs:                       # dW_in [, dW_gate], dW_outᵀ: (C, d, F)
        assert (acc.transpose(1, 2)[dropped] == 0).all()
    for a, f_first in zip(got, (False, True, False)):   # dW_out is (C, F, d)
        if a is not None:
            assert ((a if f_first else a.transpose(1, 2))[dropped] == 0).all()
    exact = _f64_dw(x, gy, scratch, accs[0].shape)
    for acc, ex in zip(accs, exact):
        scale = float(ex.abs().max())
        assert float((acc.double() - ex).abs().max()) <= 1e-5 * scale


def test_tc_dw_split_keeps_fp32_products():
    """dW_out's accumulator is within 1e-5 of the fp64 sum of gyᵀ·fp32 hm;
    hm rounded to a single bf16 term would be ~1e-3 off, so hm is split as
    dzh and dzg are."""
    M, d, F, act = 200, 64, 256, "silu"
    x, gy, w_in, w_out, w_gate, mask = _inputs(M, d, F, True, seed=13)
    _, accs, scratch, _ = emulate_dw(x, gy, w_in, w_out, mask, w_gate, act)
    exact = _f64_dw(x, gy, scratch, accs[0].shape)[-1]
    coarse = _f64_dw(x, gy, scratch, accs[0].shape, one_term_hm=True)[-1]
    scale = float(exact.abs().max())
    assert float((accs[-1].double() - exact).abs().max()) <= 1e-5 * scale
    assert float((coarse - exact).abs().max()) >= 1e-4 * scale


def test_split3_is_exact():
    """hi + mid + lo == v, each term a bf16, for random, tiny (down to
    2^-110) and huge (up to the largest fp32) values of both signs; inf and
    NaN go whole into hi. Below 2^-110 what is lost is under 2^-133."""
    rng = np.random.RandomState(0)
    parts = [rng.randn(4096), rng.randn(2048) * 1e-30, rng.randn(2048) * 1e30,
             rng.randn(1024) * 2.0 ** -109, rng.uniform(0.5, 1.0, 512) * 3.4028234e38,
             -rng.uniform(0.5, 1.0, 512) * 3.4028234e38, np.array([0.0, -0.0, 2.0 ** -110])]
    v = torch.from_numpy(np.concatenate(parts).astype(np.float32))
    v = torch.cat([v, v.nextafter(torch.full_like(v, np.inf)),
                   (v * 3).nextafter(torch.zeros_like(v))])
    v = v[torch.isfinite(v) & ((v.abs() >= 2.0 ** -110) | (v == 0))]
    hi, mid, lo = split3(v)
    for t in (hi, mid, lo):
        assert torch.equal(t, t.bfloat16().float())
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())
    assert torch.equal(hi + mid + lo, v)
    tiny = torch.from_numpy((rng.randn(4096) * 2.0 ** -120).astype(np.float32))
    hi, mid, lo = split3(tiny)
    lost = hi.double() + mid.double() + lo.double() - tiny.double()
    assert float(lost.abs().max()) < 2.0 ** -133
    odd = torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float32)
    hi, mid, lo = split3(odd)
    assert hi[0] == np.inf and hi[1] == -np.inf and torch.isnan(hi[2])
    assert (mid == 0).all() and (lo == 0).all()


@pytest.mark.parametrize("dtype,M,d,route", [
    (torch.bfloat16, 128, 64, True), (torch.bfloat16, 1024, 5120, True),
    (torch.bfloat16, 200, 128, True), (torch.bfloat16, 127, 64, False),
    (torch.bfloat16, 10, 64, False), (torch.bfloat16, 490, 96, False),
    (torch.bfloat16, 1024, 200, False), (torch.float32, 1024, 5120, False),
    (torch.float32, 490, 64, False)])
def test_route_rule(monkeypatch, dtype, M, d, route):
    """bf16 at M >= TC_ROWS with d % TC_DEPTH == 0 takes the tensor-core
    route; fp32, small M or another d the present kernels. The wrapper picks
    by the rule alone, for the forward, dx and dW."""
    C, F = 2, 256
    x = torch.zeros(C, M, d, dtype=dtype)
    assert ffn.tc_route(x) is route
    taken = []

    def tc(name, gy, *a):
        taken.append(("tc", name))
        return "tc"

    def tc_dw(*a):
        taken.append(("tc", "dw"))
        return "tc"

    class Present(Exception):
        pass

    def load(name):
        taken.append(("present", name))
        raise Present
    monkeypatch.setattr(ffn, "_launch_fd_tc", tc)
    monkeypatch.setattr(ffn, "_launch_dw_tc", tc_dw)
    monkeypatch.setattr(_build, "load", load)
    w_in, w_gate = torch.zeros(C, d, F, dtype=dtype), torch.zeros(C, d, F, dtype=dtype)
    w_out, mask = torch.zeros(C, F, d, dtype=dtype), torch.ones(C, M, F)
    for gy in (None, x):
        try:
            ffn._launch_fd("k", gy, x, w_in, w_out, mask, w_gate, "silu")
        except Present:
            pass
    try:
        ffn._launch_dw(x, x, w_in, w_out, mask, w_gate, "silu")
    except Present:
        pass
    assert taken == ([("tc", "k")] * 2 + [("tc", "dw")] if route
                     else [("present", "masked_ffn_train")] * 3)


def test_cpu_calls_run_the_plain_versions():
    """On the CPU both routes' inputs run the plain versions: no launch."""
    counters = {"fwd": ffn.train_fwd_launches, "dx": ffn.dx_launches, "dw": ffn.dw_launches,
                "fwd_tc": ffn.train_fwd_tc_launches, "dx_tc": ffn.dx_tc_launches,
                "dw_tc": ffn.dw_tc_launches}
    before = {k: c.n for k, c in counters.items()}
    x, gy, w_in, w_out, w_gate, mask = _inputs(128, 64, 256, True, seed=3)
    b = lambda t: t.bfloat16()
    assert ffn.tc_route(b(x))
    y = ffn.masked_ffn_train_fwd(b(x), b(w_in), b(w_out), mask, b(w_gate), act="silu")
    want = ffn.masked_ffn_batch_plain(b(x), b(w_in), b(w_out), mask, b(w_gate), "silu")
    assert torch.equal(y, want)
    ffn.masked_ffn_dx(b(gy), b(x), b(w_in), b(w_out), mask, b(w_gate), act="silu")
    dws = ffn.masked_ffn_dw(b(gy), b(x), b(w_in), b(w_out), mask, b(w_gate), act="silu")
    want = ffn.masked_ffn_dw_plain(b(gy), b(x), b(w_in), b(w_out), mask, b(w_gate), "silu")
    assert all(torch.equal(a, w) for a, w in zip(dws, want))
    assert {k: c.n for k, c in counters.items()} == before
