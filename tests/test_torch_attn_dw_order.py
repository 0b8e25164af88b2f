"""The order of the head-masked dW sums, on the CPU.

``masked_head_proj_dw_plain`` and ``masked_head_merge_dw_plain`` are what
the dW kernels of ``csrc/masked_attn.cu`` are held to on the card. Each
(client, head) slab is a sum over 128-row m-tiles of fp32 partials
L_tᵀ·R_t, added in m-tile order starting from the first (acc = p₀, then
+ p₁, + p₂, ...), as the reference's Pallas accumulator adds them. These
tests fix that order bitwise: the plain versions must equal such an
explicit sum, in fp32 and from bf16 inputs, at one row, one full m-tile,
one row past it, and 9 m-tiles with a ragged last one. Floating-point
addition is not associative, so another order gives other bits at 9
m-tiles: the last test shows the check can tell the orders apart.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import masked_attn as attn

C, H, HD, D = 3, 4, 16, 64
MASK = torch.tensor([[1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 1.0, 0.0],
                     [0.0, 0.0, 0.0, 0.0]])


def _inputs(kind, M, dtype, seed):
    """(gy, other operand) of the proj or merge dW, from numpy."""
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
    if kind == "proj":                 # gy (C, M, N), x (C, M, din)
        return mk(C, M, H * HD), mk(C, M, D)
    return mk(C, M, D), mk(C, M, H * HD)     # gy (C, M, d), a (C, M, N)


def _partials(L, R):
    """The fp32 partial L_tᵀ·R_t of each 128-row m-tile, in tile order."""
    L, R = L.float(), R.float()
    return [L[:, m0:m0 + 128].transpose(1, 2) @ R[:, m0:m0 + 128]
            for m0 in range(0, L.shape[1], 128)]


def _in_order(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _masked(kind, dw, dtype):
    keep = (MASK != 0).repeat_interleave(HD, dim=1)          # (C, N)
    keep = keep[:, None, :] if kind == "proj" else keep[:, :, None]
    return torch.where(keep, dw, 0).to(dtype)


def _plain_and_partials(kind, M, dtype, seed):
    gy, other = _inputs(kind, M, dtype, seed)
    if kind == "proj":
        return attn.masked_head_proj_dw_plain(gy, other, MASK), _partials(other, gy)
    return attn.masked_head_merge_dw_plain(gy, other, MASK), _partials(other, gy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 128, 129, 1100])
@pytest.mark.parametrize("kind", ["proj", "merge"])
def test_plain_dw_sums_m_tile_partials_in_tile_order(kind, M, dtype):
    got, parts = _plain_and_partials(kind, M, dtype, seed=M)
    assert len(parts) == -(-M // 128)
    want = _masked(kind, _in_order(parts), dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["proj", "merge"])
def test_another_tile_order_gives_other_bits(kind):
    got, parts = _plain_and_partials(kind, 1100, torch.float32, seed=7)
    reverse = _masked(kind, _in_order(parts[::-1]), torch.float32)
    assert not torch.equal(got, reverse)
    torch.testing.assert_close(got, reverse, rtol=1e-5, atol=1e-5)
