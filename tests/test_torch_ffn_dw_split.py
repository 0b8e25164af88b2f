"""The arithmetic of the masked-FFN dW kernel (B3), on the CPU.

``csrc/masked_ffn_train.cu``'s ``train_dw_kernel`` splits each (client,
f-block) pair's 8-row m-tiles over G blocks of contiguous m-tiles
(``masked_ffn.dw_launch_geometry``). A block skips the m-tiles that no row
keeps; for a kept one it recomputes the pre-activations as four partial
sums over slices of d (rows ks·8.. of every 32-row chunk), added in slice
order, applies the mask and activation, and adds the tile's rows in
order onto its fp32 partial of dW_in, dW_out and dW_gate. The blocks'
partials are then added in block order, which is m-tile order (p0 + p1 +
...), through an fp32 scratch and a second kernel.

A torch emulation of that, in fp32, is held here to the Pallas
``_dw_impl`` (interpret mode, 8-row m-tiles, per-row masks, as the fleet
runs it one client at a time) to 1e-5 relative ∞-norm, the card tests'
measure: a block adds up to 490 rows one at a time onto fp32 partials
(|dW| reaches ~30, and that serial sum drifts by ~2e-5 from the tiled
one), and XLA's fp32 tanh differs from torch's by up to 2.6e-7, which
gelu's derivative amplifies (x is drawn at half scale for that reason, as
in tests/test_torch_train_kernels.py). For the split the launch picks and
for other splits, ungated and gated, at femnist_attn's M 490 and the
fleet's M 10 and a ragged M 13. The
dW of an f-block that no m-tile keeps must be exactly 0, and the launch
must spread femnist_attn's shape over at least 80 blocks.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.masked_ffn import _dw_impl  # noqa: E402
from repro_torch.kernels import masked_ffn as ffn  # noqa: E402

REL_TOL = 1e-5
MT, BN, KC, KS = 8, 128, 32, 4    # m-tile rows, f-block neurons, d rows of a chunk, k-slices


@functools.lru_cache(maxsize=None)
def _pallas_dw(act, gated):
    def dw(gy, x, wi, wo, wg, m):
        return _dw_impl(gy, x, wi, wo, wg, m, act=act, block_m=MT, interpret=True,
                        per_row=True)
    return jax.jit(dw)


def _slice_rows(d):
    """Rows of d each of the KS k-slices sums: ks·8.. of every chunk."""
    kr = KC // KS
    return [[k for s0 in range(0, d, KC) for k in range(s0 + kr * q, min(s0 + kr * q + kr, d))]
            for q in range(KS)]


def _tile(x, gy, wi, wo, wg, m, act):
    """(hm, dzh, dzg) of one kept tile: k-slice partials added in order."""
    slices = _slice_rows(x.shape[1])

    def pre(a, w):
        out = 0
        for rows in slices:
            out = out + a[:, rows] @ w[rows]
        return out
    zh, gh = pre(x, wi), pre(gy, wo.T) * m
    if wg is not None:
        zg = pre(x, wg)
        a = ffn._ACTS[act](zg)
        return a * zh * m, gh * a, gh * zh * ffn._DACTS[act](zg)
    return ffn._ACTS[act](zh) * m, gh * ffn._DACTS[act](zh), None


def emulate_dw(gy, x, w_in, w_out, mask, w_gate, act, groups):
    """(dW_in, dW_out, dW_gate) as the kernel sums them with the m-tiles
    of each (client, f-block) split over ``groups`` blocks."""
    C, M, d = x.shape
    F = w_in.shape[2]
    nmt = -(-M // MT)
    per = -(-nmt // groups)
    gated = w_gate is not None
    outs = [torch.zeros_like(w_in), torch.zeros_like(w_out),
            torch.zeros_like(w_gate) if gated else None]
    for c in range(C):
        for f0 in range(0, F, BN):
            f = slice(f0, f0 + BN)
            wi, wo = w_in[c][:, f], w_out[c][f]
            wg = w_gate[c][:, f] if gated else None
            total = None
            for q in range(-(-nmt // per)):            # block q, in order
                part = [torch.zeros(d, BN), torch.zeros(BN, d), torch.zeros(d, BN)]
                for mt in range(q * per, min(q * per + per, nmt)):
                    rows = slice(MT * mt, min(MT * mt + MT, M))
                    m = mask[c, rows, f]
                    if not bool((m != 0).any()):       # skipped: no weight read
                        continue
                    xs, gs = x[c, rows], gy[c, rows]
                    hm, dzh, dzg = _tile(xs, gs, wi, wo, wg, m, act)
                    for r in range(xs.shape[0]):      # the tile's rows in order
                        part[0] = part[0] + torch.outer(xs[r], dzh[r])
                        part[1] = part[1] + torch.outer(hm[r], gs[r])
                        if gated:
                            part[2] = part[2] + torch.outer(xs[r], dzg[r])
                total = part if total is None else [a + b for a, b in zip(total, part)]
            outs[0][c][:, f], outs[1][c][f] = total[0], total[1]
            if gated:
                outs[2][c][:, f] = total[2]
    return tuple(outs)


def _inputs(C, M, d, F, gated, seed):
    """Client 0 drops f-block 1 (ordered-style), client 1 keeps scattered
    neurons and drops rows 8-15 everywhere (a skipped m-tile), the rest
    keep all."""
    rng = np.random.RandomState(seed)
    x = (0.5 * rng.randn(C, M, d)).astype(np.float32)
    gy = rng.randn(C, M, d).astype(np.float32)
    w_in = (rng.randn(C, d, F) / np.sqrt(d)).astype(np.float32)
    w_out = (rng.randn(C, F, d) / np.sqrt(F)).astype(np.float32)
    w_gate = (rng.randn(C, d, F) / np.sqrt(d)).astype(np.float32) if gated else None
    mask = np.ones((C, M, F), np.float32)
    mask[0, :, BN:2 * BN] = 0.0
    if C > 1:
        mask[1] = (rng.rand(F) < 0.75).astype(np.float32)[None]
        mask[1, 8:16] = 0.0
    return x, gy, w_in, w_out, w_gate, mask


def _pallas(x, gy, w_in, w_out, w_gate, mask, act):
    fn = _pallas_dw(act, w_gate is not None)
    out = []
    for c in range(x.shape[0]):
        wg = None if w_gate is None else jnp.asarray(w_gate[c])
        out.append([None if a is None else np.asarray(a) for a in
                    fn(jnp.asarray(gy[c]), jnp.asarray(x[c]), jnp.asarray(w_in[c]),
                       jnp.asarray(w_out[c]), wg, jnp.asarray(mask[c]))])
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("C,M,d,F,act", [(2, 490, 64, 256, "gelu"), (5, 10, 64, 1024, "gelu"),
                                         (3, 13, 40, 256, "silu")])
def test_split_partials_match_pallas_dw(C, M, d, F, act, gated):
    """The launch's own split, a single block and a cluster-sized split all
    give the Pallas kernel's dW; the dropped f-block's dW is exactly 0."""
    x, gy, w_in, w_out, w_gate, mask = _inputs(C, M, d, F, gated, seed=M + d)
    want = _pallas(x, gy, w_in, w_out, w_gate, mask, act)
    t = [None if a is None else torch.from_numpy(a)
         for a in (gy, x, w_in, w_out, mask, w_gate)]
    nmt = -(-M // MT)
    splits = {ffn.dw_launch_geometry(C, M, d, F)["groups"], 1, min(nmt, 8)}
    for groups in sorted(splits):
        got = emulate_dw(*t, act, groups)
        for c in range(C):
            for k in range(3 if gated else 2):
                err = np.abs(got[k][c].numpy() - want[c][k]).max() / np.abs(want[c][k]).max()
                assert err <= REL_TOL, (groups, c, k, err)
        assert (got[0][0][:, BN:2 * BN] == 0).all() and (got[1][0][BN:2 * BN] == 0).all()
        if gated:
            assert (got[2][0][:, BN:2 * BN] == 0).all()


def test_launch_geometry_spreads_femnist_attn_over_the_card():
    """C 5, M 490 (62 m-tiles), d 64, F 256: 10 (client, f-block) pairs,
    at least 80 blocks, each with contiguous m-tiles that cover M."""
    geo = ffn.dw_launch_geometry(5, 490, 64, 256)
    assert geo["blocks"] >= 80
    assert geo["m_tiles"] == 62
    g, per = geo["groups"], geo["m_tiles_per_block"]
    assert (g - 1) * per < 62 <= g * per
    assert geo["grid"] == (g, 2, 5) and geo["blocks"] == g * 10
    assert geo["route"] == "scratch"


@pytest.mark.parametrize("C,M,d,F,route,groups", [
    (5, 10, 64, 1024, "scratch", 2),      # femnist_kernel's 5 clients
    (64, 10, 64, 1024, "direct", 1),      # its 64-client cohort
    (5, 490, 64, 256, "scratch", 13),     # femnist_attn's FFN
    (1, 7, 200, 384, "direct", 1)])       # one m-tile
def test_launch_geometry_routes(C, M, d, F, route, groups):
    geo = ffn.dw_launch_geometry(C, M, d, F)
    assert (geo["route"], geo["groups"]) == (route, groups)
