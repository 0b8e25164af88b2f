"""The arithmetic of decode_gqa's split kernel, on the CPU.

``csrc/decode_gqa.cu`` splits each row's valid cache prefix into splits of
TS positions (``decode_gqa.split_len``), computes each split's max m_s,
sum l_s = Σ e^(s − m_s) and acc_s = Σ e^(s − m_s)·v in fp32, and merges
the valid splits of a row in split order: m = max m_s, l = Σ l_s·e^(m_s −
m), acc = Σ acc_s·e^(m_s − m), out = acc / max(l, 1e-30). A torch
emulation of that split and merge, in fp32, is held here to the Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and to the
port's plain version, to 1e-6, at each split length the launch can pick,
with rows of 1 position, at and around split boundaries, and C not a
multiple of the split. The launch's choice of TS is checked against the
SM count it is meant to cover, as is the FFN kernel's cluster shape.
"""
import math

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.decode_gqa import decode_gqa as jax_decode_gqa  # noqa: E402
from repro_torch.kernels import decode_gqa as gqa  # noqa: E402
from repro_torch.kernels import masked_ffn as ffn  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
KV, HD = 2, 32                     # _inputs' K/V heads and head dim


def split_merge(q, k, v, lengths, ts):
    """The split kernel's partials and the merge kernel's in-order sum."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    out = torch.zeros_like(q)
    for b in range(B):
        L = int(lengths[b])
        qg = q[b].reshape(KV, G, hd)
        parts = []
        for t0 in range(0, L, ts):                 # only splits with positions
            kk, vv = k[b, t0:min(t0 + ts, L)], v[b, t0:min(t0 + ts, L)]
            s = torch.einsum("kgd,nkd->kgn", qg, kk) * scale
            m_s = s.amax(-1)
            p = torch.exp(s - m_s[..., None])
            parts.append((m_s, p.sum(-1), torch.einsum("kgn,nkd->kgd", p, vv)))
        m = parts[0][0]
        for m_s, _, _ in parts[1:]:
            m = torch.maximum(m, m_s)
        l, acc = 0.0, 0.0
        for m_s, l_s, acc_s in parts:
            w = torch.exp(m_s - m)
            l = l + l_s * w
            acc = acc + acc_s * w[..., None]
        out[b] = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(H, hd)
    return out


def _inputs(G, ts, seed):
    """Rows of 1, TS − 1, TS, TS + 1, 2·TS, 2·TS + 1 and C = 3·TS + 5
    valid positions; fp32 from numpy."""
    C = 3 * ts + 5
    lens = np.array([1, ts - 1, ts, ts + 1, 2 * ts, 2 * ts + 1, C], np.int32)
    rng = np.random.RandomState(seed)
    B = len(lens)
    q = rng.randn(B, KV * G, HD).astype(np.float32)
    k = rng.randn(B, C, KV, HD).astype(np.float32)
    v = rng.randn(B, C, KV, HD).astype(np.float32)
    return q, k, v, lens


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("ts", gqa.SPLITS)
def test_split_and_ordered_merge_match_pallas_and_plain(ts, G):
    q, k, v, lens = _inputs(G, ts, seed=ts + G)
    t = torch.from_numpy
    got = split_merge(t(q), t(k), t(v), t(lens), ts).numpy()
    pallas = np.asarray(jax_decode_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(lens), interpret=True))
    plain = gqa.decode_gqa_plain(t(q), t(k), t(v), t(lens)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("G", [1, 3, 6, 8, 12, 16, 48, 64])
def test_head_groups_split_any_group_into_blocks_of_at_most_8(G):
    """G query heads a K/V head go to rep split blocks of VG heads, VG the
    largest of GROUPS dividing G; rep is 1 exactly for the G the kernel
    took before virtual groups (its launches unchanged)."""
    vg, rep = gqa.head_groups(G)
    assert vg in gqa.GROUPS and vg * rep == G
    assert all(G % g for g in gqa.GROUPS if g > vg)
    assert (rep == 1) == (G in gqa.GROUPS)
    assert gqa.head_groups(48) == (8, 6)


@pytest.mark.parametrize("G", [6, 12, 48])
@pytest.mark.parametrize("ts", gqa.SPLITS)
def test_virtual_head_groups_match_pallas_and_plain(ts, G):
    """The kernel's virtual groups: each of a K/V head's rep groups is a
    split block reading that head's rows, so the split and merge run on
    K/V repeated rep times over KV·rep groups of VG heads. One K/V head, as
    Granite-20B's MQA, against the Pallas kernel (which takes any H/KV) and
    the plain version."""
    q, k, v, lens = _inputs(G, ts, seed=ts + G)
    q = np.ascontiguousarray(q[:, :G])                # KV 1: the first G heads
    k, v = k[:, :, :1].copy(), v[:, :, :1].copy()
    _, rep = gqa.head_groups(G)
    t = torch.from_numpy
    got = split_merge(t(q), t(k).repeat_interleave(rep, dim=2),
                      t(v).repeat_interleave(rep, dim=2), t(lens), ts).numpy()
    pallas = np.asarray(jax_decode_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(lens), interpret=True))
    plain = gqa.decode_gqa_plain(t(q), t(k), t(v), t(lens)).numpy()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("ts", gqa.SPLITS)
def test_single_position_row_is_its_value_row(ts):
    """A row of one valid position gets exactly v[0] of its head: the one
    split has p = e^0 = 1, l = 1, and the merge's weight is e^0 = 1."""
    q, k, v, lens = _inputs(4, ts, seed=1)
    t = torch.from_numpy
    got = split_merge(t(q), t(k), t(v), t(lens), ts)
    want = t(v)[0, 0].repeat_interleave(4, dim=0)       # (KV·G, hd)
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("B,KV_,C,n_sm", [(8, 8, 576, 132), (1, 1, 4096, 132),
                                          (5, 2, 300, 132), (8, 8, 4096, 132),
                                          (64, 8, 2048, 132), (8, 8, 576, 66)])
def test_split_len_covers_the_sms(B, KV_, C, n_sm):
    """The launch takes the longest split whose grid still gives every SM
    COVER blocks at full lengths, and the shortest where none does."""
    ts = gqa.split_len(B, KV_, C, n_sm)
    assert ts in gqa.SPLITS
    blocks = lambda s: B * KV_ * -(-C // s)
    if ts != gqa.SPLITS[-1]:
        assert blocks(ts) >= gqa.COVER * n_sm
    longer = [s for s in gqa.SPLITS if s > ts]
    assert all(blocks(s) < gqa.COVER * n_sm for s in longer)


@pytest.mark.parametrize("M,d,F", [(8, 5120, 13824), (13, 512, 1024), (1, 64, 128),
                                   (16, 2560, 8960 // 128 * 128),
                                   (8, 2560, 6400), (8, 4096, 12288), (8, 8192, 22528)])
def test_ffn_geometry_is_a_portable_cluster_covering_the_sms(M, d, F):
    n_sm = 132
    ks, fs = ffn.ffn_geometry(M, d, F, n_sm)
    assert 1 <= ks <= 8 and 1 <= fs <= 8
    assert ks <= -(-d // 64)                    # every block of a cluster has rows
    nmt = -(-M // 8)
    if ks < 8 and ks < -(-d // 64):
        assert (F // 128) * nmt * ks >= ffn.COVER * n_sm
    if fs < 8:
        assert -(-d // 128) * nmt * fs >= ffn.COVER * n_sm
