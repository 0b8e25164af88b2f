"""Single-token GQA flash-decode (port of ``repro/kernels/decode_gqa.py``).

``decode_gqa`` dispatches on where its tensors lie: on a CUDA tensor it
launches the hand-written kernel in ``csrc/decode_gqa.cu`` (which replaces
the Pallas ``_kernel``) and counts the launch; on a CPU tensor it runs
``decode_gqa_plain``; on a meta tensor (the dry-run's) it applies the
launch's checks, then runs ``decode_gqa_plain``. There is no fallback from
the card to the plain version.

The kernel splits the cache axis into splits of ``split_len(...)``
positions, one block each, and merges the splits' softmax partials in
split order (a launch of two kernels, counted once). The query heads of a
K/V head go to split blocks in virtual groups (``head_groups``), so the
kernel takes any H/KV, as the Pallas kernel does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG = -1e30
GROUPS = (1, 2, 4, 8)          # query heads a split block may take
SPLITS = (128, 64, 32)         # cache positions a split block may take
COVER = 4                      # split blocks wanted per SM, at full lengths

launches = _build.LaunchCounter()


def decode_gqa_plain(q, k, v, lengths):
    """Plain fp32 version (``repro/kernels/ref.py::decode_gqa_ref``).
    q: (B,H,hd); k,v: (B,C,KV,hd); lengths: (B,). Returns (B,H,hd)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k.float()) / math.sqrt(hd)
    C = k.shape[1]
    valid = (torch.arange(C, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", w, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def head_groups(G):
    """(VG, rep): the G query heads of a K/V head go to ``rep`` split blocks
    of VG heads each, VG the largest of ``GROUPS`` that divides G (a G of
    ``GROUPS`` takes one block of all G; Granite-20B's 48 take 6 of 8)."""
    vg = max(g for g in GROUPS if G % g == 0)
    return vg, G // vg


def split_len(B, KV, C, n_sm):
    """Cache positions a split block takes: the longest of ``SPLITS`` whose
    grid of B·KV·⌈C/TS⌉ blocks (KV counting each head's virtual groups)
    still covers the ``n_sm`` SMs ``COVER`` times over, else the shortest.
    Decided from C, not from the lengths, which lie on the card."""
    for ts in SPLITS:
        if B * KV * -(-C // ts) >= COVER * n_sm:
            return ts
    return SPLITS[-1]


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_gqa_scratch_floats.argtypes = [i] * 6
    lib.decode_gqa_scratch_floats.restype = ctypes.c_longlong
    lib.decode_gqa_launch.argtypes = ([p] * 6 + [i] * 7
                                      + [ctypes.c_float, i, p])
    lib.decode_gqa_launch.restype = i


_build.register_binding("decode_gqa", _bind)


def _check(q, k, v, lengths):
    """The launch's refusals (a ValueError), on the operands it is given."""
    hd, dtype, dev = q.shape[2], q.dtype, q.device
    if dtype not in _build.DTYPE_CODE:
        raise ValueError(f"decode_gqa kernel takes {list(_build.DTYPE_CODE)}, got {dtype}")
    lanes = hd * q.element_size() // 16
    if hd * q.element_size() % 16 or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"decode_gqa kernel needs hd·{q.element_size()} B to be "
                         f"16 B times a power of two <= 32, got hd={hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, t, dtype, dev)
    _build.check_operand("lengths", lengths, torch.int32, dev)


def _launch(q, k, v, lengths):
    B, H, hd = q.shape
    C, KV = k.shape[1], k.shape[2]
    dtype, dev = q.dtype, q.device
    lib = _build.load("decode_gqa")
    _, rep = head_groups(H // KV)
    ts = split_len(B, KV * rep, C, _build.sm_count(dev))
    out = torch.empty_like(q)
    scratch = torch.empty((lib.decode_gqa_scratch_floats(B, H, KV, C, hd, ts),),
                          dtype=torch.float32, device=dev)
    err = lib.decode_gqa_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), B, H, KV, C, hd, ts, rep,
        1.0 / math.sqrt(hd), _build.DTYPE_CODE[dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_gqa kernel launch failed: CUDA error {err}")
    launches.n += 1
    return out


def decode_gqa(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,C,KV,hd); lengths: (B,) valid prefix per row,
    in [1, C]. Returns (B,H,hd) in q.dtype: softmax over the first
    lengths[b] cache slots, scale 1/sqrt(hd), fp32 accumulation. CUDA
    tensors launch the kernel, CPU tensors run the plain version, meta
    tensors take the launch's checks and then the plain version."""
    B, H, hd = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != hd or k.shape != v.shape:
        raise ValueError(f"k, v must be (B={B}, C, KV, hd={hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"H={H} must be a multiple of KV={k.shape[2]}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be (B={B},), got {tuple(lengths.shape)}")
    if _build.checked_as_card(q):
        lengths = lengths.to(torch.int32).contiguous()
        _check(q, k, v, lengths)
    if _build.runs_plain(q):
        return decode_gqa_plain(q, k, v, lengths)
    return _launch(q, k, v, lengths)
