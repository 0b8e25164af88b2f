"""The arithmetic of the masked-FFN training forward (B1) and dx (B2), on the CPU.

``csrc/masked_ffn_train.cu``'s ``train_fwd_kernel`` and ``train_dx_kernel``
split each (client, f-block) pair's 8-row m-tiles over G blocks of
contiguous m-tiles (``masked_ffn.fwd_dx_launch_geometry``). A block skips
the m-tiles that no row keeps. For a kept one, a group of 4 warps
(``masked_ffn.FD_WT``), a neuron a lane, sums each neuron's pre-activations
serially over k, applies the mask and activation (the forward rounds the
hidden activation to the input type); warp s sums the output serially over
its neurons 32s .. 32s + 31, and the group adds its warps' sums in warp
order and writes the f-block's fp32 partial. A second kernel adds the kept
f-blocks' partials in f order (0 + p0 + p1 + ...).

A torch emulation of that order of operations is held here to the Pallas
``_fwd_impl`` and ``_dx_impl`` (interpret mode, 8-row m-tiles, per-row
masks, one client at a time as the fleet runs them) to 1e-5 relative
∞-norm in fp32: the emulation rounds each product before it adds it where
the kernel fuses them, XLA sums its dots in another order, and XLA's fp32
tanh differs from torch's by up to 2.6e-7, which gelu's derivative
amplifies (x is drawn at half scale for that reason, as in
tests/test_torch_ffn_dw_split.py). bf16 inputs, where the rounding of the
hidden activation shows, to 1e-2. For the split the launch picks and for
other splits, ungated and gated, at femnist_attn's M 490, the fleet's M 10
and a ragged M 13; every m-tile a block takes is taken by no other block,
and a row that no f-block keeps comes out exactly 0.
"""
import functools

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.masked_ffn import _dx_impl, _fwd_impl  # noqa: E402
from repro_torch.kernels import masked_ffn as ffn  # noqa: E402

REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
MT, BN = 8, 128                   # m-tile rows, f-block neurons


@functools.lru_cache(maxsize=None)
def _pallas(kind, act):
    def fwd(x, wi, wo, wg, m):
        return _fwd_impl(x, wi, wo, wg, m, act=act, block_m=MT, interpret=True, per_row=True)

    def dx(gy, x, wi, wo, wg, m):
        return _dx_impl(gy, x, wi, wo, wg, m, act=act, block_m=MT, interpret=True, per_row=True)
    return jax.jit(fwd if kind == "fwd" else dx)


def _serial(a, w):
    """Σ_k a[:, k] w[k], added in k order: (rows, K) x (K, N)."""
    z = torch.zeros(a.shape[0], w.shape[1])
    for k in range(a.shape[1]):
        z = z + a[:, k:k + 1] * w[k]
    return z


def _tile_out(h, w, dg=None, wg=None):
    """A kept tile's output over the f-block: warp s sums its neurons 32s ..
    32s + 31 serially (h[:, n] w[n], then dg[:, n] wg[n] when gated); the
    group adds the warps' sums in warp order."""
    nw = BN // ffn.FD_WT
    total = None
    for s in range(ffn.FD_WT):
        acc = torch.zeros(h.shape[0], w.shape[1])
        for n in range(s * nw, s * nw + nw):
            acc = acc + h[:, n:n + 1] * w[n]
            if dg is not None:
                acc = acc + dg[:, n:n + 1] * wg[n]
        total = acc if total is None else total + acc
    return total


def emulate(kind, x, w_in, w_out, mask, w_gate, act, groups, gy=None, dtype=torch.float32):
    """The forward (kind "fwd") or dx as the kernels sum them, with the
    m-tiles of each (client, f-block) split over ``groups`` blocks; also
    how many times each (client, m-tile, f-block) tile was computed."""
    C, M, d = x.shape
    F = w_in.shape[2]
    nmt, nfb = -(-M // MT), F // BN
    per = -(-nmt // groups)
    out = torch.zeros(C, M, d)
    taken = np.zeros((C, nmt, nfb), int)
    for c in range(C):
        parts = [[None] * nmt for _ in range(nfb)]
        for fb in range(nfb):
            f = slice(fb * BN, fb * BN + BN)
            wi, wo = w_in[c][:, f], w_out[c][f]
            wg = None if w_gate is None else w_gate[c][:, f]
            for q in range(-(-nmt // per)):            # block q
                tiles = [mt for mt in range(q * per, min(q * per + per, nmt))
                         if bool((mask[c, MT * mt:MT * mt + MT, f] != 0).any())]
                for mt in tiles:                      # the groups' m-tiles
                    taken[c, mt, fb] += 1
                    rows = slice(MT * mt, min(MT * mt + MT, M))
                    xs, rm = x[c, rows], mask[c, rows, f]
                    zh = _serial(xs, wi)
                    zg = None if wg is None else _serial(xs, wg)
                    if kind == "fwd":
                        v = ffn._ACTS[act](zh) if wg is None else ffn._ACTS[act](zg) * zh
                        h = torch.where(rm != 0, v * rm, torch.zeros(()))
                        parts[fb][mt] = _tile_out(h.to(dtype).float(), wo)
                        continue
                    ghm = _serial(gy[c, rows], wo.T) * rm
                    if wg is None:
                        parts[fb][mt] = _tile_out(ghm * ffn._DACTS[act](zh), wi.T)
                    else:
                        a = ffn._ACTS[act](zg)
                        parts[fb][mt] = _tile_out(ghm * a, wi.T, ghm * zh * ffn._DACTS[act](zg),
                                                  wg.T)
        for mt in range(nmt):                         # the reduce: f order
            acc = torch.zeros(min(MT, M - MT * mt), d)
            for fb in range(nfb):
                if parts[fb][mt] is not None:
                    acc = acc + parts[fb][mt]
            out[c, MT * mt:MT * mt + MT] = acc
    return out.to(dtype), taken


def _inputs(C, M, d, F, gated, seed):
    """Client 0 drops f-block 1 (ordered-style), client 1 keeps scattered
    neurons and drops rows 8-15 everywhere (a skipped m-tile), client 2
    keeps nothing, the rest keep all."""
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
    if C > 2:
        mask[2] = 0.0
    return x, gy, w_in, w_out, w_gate, mask


def _reference(kind, x, gy, w_in, w_out, w_gate, mask, act, dtype):
    fn = _pallas(kind, act)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    out = []
    for c in range(x.shape[0]):
        wg = None if w_gate is None else jnp.asarray(w_gate[c], jd)
        args = (jnp.asarray(x[c], jd), jnp.asarray(w_in[c], jd), jnp.asarray(w_out[c], jd), wg,
                jnp.asarray(mask[c]))
        y = fn(*args) if kind == "fwd" else fn(jnp.asarray(gy[c], jd), *args)
        out.append(np.asarray(y.astype(jnp.float32)))
    return np.stack(out)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(kind, C, M, d, F, act, gated, dtype, splits):
    x, gy, w_in, w_out, w_gate, mask = _inputs(C, M, d, F, gated, seed=M + d + gated)
    if dtype == torch.bfloat16:        # the values both sides see
        x, gy, w_in, w_out = (np.asarray(torch.from_numpy(a).bfloat16().float())
                              for a in (x, gy, w_in, w_out))
        if w_gate is not None:
            w_gate = np.asarray(torch.from_numpy(w_gate).bfloat16().float())
    want = _reference(kind, x, gy, w_in, w_out, w_gate, mask, act, dtype)
    t = {k: None if a is None else torch.from_numpy(a) for k, a in
         dict(x=x, gy=gy, w_in=w_in, w_out=w_out, w_gate=w_gate, mask=mask).items()}
    nmt = -(-M // MT)
    kept = (np.pad(mask, ((0, 0), (0, nmt * MT - M), (0, 0)))
            .reshape(C, nmt, MT, F // BN, BN).max(axis=(2, 4)) != 0)
    for groups in sorted(splits):
        got, taken = emulate(kind, t["x"], t["w_in"], t["w_out"], t["mask"], t["w_gate"], act,
                             groups, gy=t["gy"], dtype=dtype)
        got = got.float().numpy()
        assert (taken == kept).all(), groups       # each kept tile once, no skipped one
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= REL_TOL[str(dtype)[6:]], (kind, groups, err)
        dead = mask.max(axis=2) == 0                 # rows no f-block keeps
        assert (got[dead] == 0).all()


@pytest.mark.parametrize("kind", ["fwd", "dx"])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("C,M,d,F,act", [(3, 490, 64, 256, "gelu"), (5, 10, 64, 1024, "gelu"),
                                         (3, 13, 40, 256, "silu")])
def test_split_matches_pallas(kind, C, M, d, F, act, gated):
    """The launch's own split, a single block and a block per m-tile all
    give the Pallas kernel's output."""
    nmt = -(-M // MT)
    splits = {ffn.fwd_dx_launch_geometry(C, M, d, F)["groups"], 1, nmt}
    _check(kind, C, M, d, F, act, gated, torch.float32, splits)


@pytest.mark.parametrize("kind", ["fwd", "dx"])
def test_split_matches_pallas_bf16(kind):
    """bf16 inputs: the forward rounds the hidden activation to bf16 before
    the down product, as the Pallas kernel does."""
    C, M, d, F = 3, 13, 64, 256
    _check(kind, C, M, d, F, "gelu", False, torch.bfloat16,
           {ffn.fwd_dx_launch_geometry(C, M, d, F)["groups"], 2})


def test_launch_geometry_spreads_femnist_attn_over_the_card():
    """C 5, M 490 (62 m-tiles), d 64, F 256: 10 (client, f-block) pairs,
    at least 80 blocks, each with contiguous m-tiles that cover M once."""
    geo = ffn.fwd_dx_launch_geometry(5, 490, 64, 256)
    assert geo["blocks"] >= 80
    assert geo["m_tiles"] == 62
    g, per = geo["groups"], geo["m_tiles_per_block"]
    assert (g - 1) * per < 62 <= g * per
    assert geo["grid"] == (g, 2, 5) and geo["blocks"] == g * 10


@pytest.mark.parametrize("C,M,d,F", [(5, 490, 64, 256), (64, 490, 64, 256), (5, 10, 64, 1024),
                                     (64, 10, 64, 1024), (3, 13, 200, 384), (1, 1, 40, 128),
                                     (3, 1100, 64, 256)])
def test_launch_geometry_covers_each_m_tile_once(C, M, d, F):
    geo = ffn.fwd_dx_launch_geometry(C, M, d, F)
    nmt, per, g = geo["m_tiles"], geo["m_tiles_per_block"], geo["groups"]
    assert nmt == -(-M // MT)
    taken = np.zeros(nmt, int)
    for q in range(g):
        taken[q * per:min(q * per + per, nmt)] += 1
    assert (taken == 1).all()
    assert 1 <= g <= nmt and geo["grid"][0] == g and geo["grid"][2] == C
    assert geo["blocks"] == g * geo["grid"][1] * C
