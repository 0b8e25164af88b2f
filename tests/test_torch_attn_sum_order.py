"""The order of the head-masked sums over heads, on the CPU.

``masked_head_proj_dx_plain`` and ``masked_head_merge_plain`` are what the
sum kernel of ``csrc/masked_attn.cu`` is held to on the card. Each output
is a sum over the kept heads of fp32 partials a[:, h]·W_h, added in head
order starting from the first kept head (acc = p_h0, then + p_h1, ...), as
the reference's Pallas accumulator adds them. These tests fix that order
bitwise: the plain versions must equal such an explicit sum, in fp32 and
from bf16 inputs, at 4 and 8 heads, for clients that keep every head, drop
the first, drop one in the middle, or drop them all. Floating-point
addition is not associative, so another order gives other bits: the last
test shows the check can tell the orders apart.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import masked_attn as attn

M, D, HD = 37, 64, 16


def _masks(H):
    """One client each: every head kept, the first dropped, a middle one
    dropped, all dropped."""
    rows = [[1.0] * H, [0.0] + [1.0] * (H - 1),
            [1.0] * (H // 2 - 1) + [0.0] + [1.0] * (H - H // 2), [0.0] * H]
    return torch.tensor(rows)


def _inputs(kind, H, dtype, seed):
    """(head-partitioned input, weight) of the proj dx or merge, from
    numpy: gy (C, M, N) and w (C, din, N), or a (C, M, N) and w (C, N, d)."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
    C, N = 4, H * HD
    w = mk(C, D, N) if kind == "proj_dx" else mk(C, N, D)
    return mk(C, M, N), w


def _partials(kind, a, w, H):
    """The fp32 partial a[:, h]·W_h of each head, in head order, as the
    plain version computes each one."""
    a, w = a.float(), w.float()
    parts = []
    for h in range(H):
        s = slice(h * HD, (h + 1) * HD)
        wh = w[..., s].transpose(-1, -2) if kind == "proj_dx" else w[..., s, :]
        parts.append(a[..., s] @ wh)
    return parts


def _summed(parts, mask, order):
    """Per client, the sum of its kept heads' partials in ``order``, from
    the first of them; exact zeros where it keeps none."""
    out = torch.zeros_like(parts[0])
    for c in range(mask.shape[0]):
        kept = [h for h in order if mask[c, h] != 0]
        if kept:
            acc = parts[kept[0]][c]
            for h in kept[1:]:
                acc = acc + parts[h][c]
            out[c] = acc
    return out


def _plain(kind, a, w, mask):
    fn = (attn.masked_head_proj_dx_plain if kind == "proj_dx"
          else attn.masked_head_merge_plain)
    return fn(a, w, mask)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [4, 8])
@pytest.mark.parametrize("kind", ["proj_dx", "merge"])
def test_plain_sums_kept_heads_in_head_order(kind, H, dtype):
    a, w = _inputs(kind, H, dtype, seed=H)
    mask = _masks(H)
    got = _plain(kind, a, w, mask)
    want = _summed(_partials(kind, a, w, H), mask, range(H)).to(dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert (got[3] == 0).all()                     # the client that keeps no head


@pytest.mark.parametrize("kind", ["proj_dx", "merge"])
def test_another_head_order_gives_other_bits(kind):
    a, w = _inputs(kind, 8, torch.float32, seed=7)
    mask = _masks(8)
    got = _plain(kind, a, w, mask)
    reverse = _summed(_partials(kind, a, w, 8), mask, range(7, -1, -1))
    assert not torch.equal(got, reverse)
    torch.testing.assert_close(got, reverse, rtol=1e-5, atol=1e-5)
