"""Static kernel-contract validator (port of
``repro/analysis/kernel_contracts.py``, pass 3 of ``repro_torch.analysis``).

Pure shape and grammar checking: no kernel launches. Every wrapper given a
meta tensor applies the card's launch checks (``kernels/_build.
checked_as_card``) and then runs its plain version on meta tensors, so the
whole zoo sweeps at REAL dimensions (d_model in the thousands, d_ff in the
tens of thousands) with no card and no allocation, and a layout the card
would refuse raises here as it would there:

  * **tile eligibility**: every FFN width in configs/ (d_ff and the MoE
    expert width) is classified against the BLOCK_NEURONS=128 grammar.
    Aligned widths must run through ``masked_ffn``, ``masked_ffn_batch``
    and ``masked_ffn_train`` (C 1), forward and backward, in fp32 and
    bf16; misaligned widths must raise ValueError — the loud-failure
    contract (never a silent dense fallback). Head layouts sweep the same
    way through ``masked_head_proj`` / ``masked_head_merge`` (C 1, the
    config's dtype, forward and backward). The port's head kernels are
    client-batched, x (C, M, din) where the reference's is (M, din).
  * **mask-shape rejection**: wrong block-mask lengths, wrong row-mask
    shapes, and non-dividing head masks must all raise ValueError.
  * **UNIT_SPECS grammar**: every (path, axis, tile) entry of every fleet
    model resolves against the model's init tree (on the meta device), the
    axis length equals size * |tile|, and ``expand_indices`` is a
    permutation — with tile < 0 additionally unit-major (each unit owns
    |tile| contiguous slots, the attention-head layout).
  * **constants**: ops.BLOCK_NEURONS == masked_ffn.BLOCK_NEURONS, and
    ``neuron_mask_to_block_mask`` keeps a block iff any neuron survives.

Not ported: ``_sds`` and ``_traces_ok``'s ``jax.eval_shape``; a meta
tensor stands in for a ShapeDtypeStruct, and ``_runs_ok`` for the trace.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.analysis.contracts import Violation

M = 8


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _runs_ok(fn, *args):
    """(ok, err): fn(*args) on meta tensors, and its backward where an
    argument requires grad; a ValueError -> (False, its message)."""
    try:
        y = fn(*args)
        leaves = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
        if leaves:
            torch.autograd.grad(y, leaves, torch.empty_like(y))
        return True, ""
    except ValueError as e:
        return False, str(e)


# ---------------------------------------------------------------------------
# FFN width sweep

def _ffn_widths():
    """{(F, d_model): [arch, ...]} over d_ff and MoE expert widths."""
    from repro_torch.configs.base import all_configs
    widths: Dict[tuple, list] = {}
    for arch, cfg in all_configs().items():
        for F in {cfg.d_ff, cfg.moe_ff}:
            widths.setdefault((F, cfg.d_model), []).append(arch)
    return widths


def ffn_verdicts(F, d, dtype):
    """{wrapper: (ok, err)} for one (F, d_model) in ``dtype``."""
    from repro_torch.kernels import ops
    nb = max(F // 128, 1)
    g = lambda *s: _meta(*s, dtype=dtype, grad=True)
    return {
        "masked_ffn": _runs_ok(lambda *a: ops.masked_ffn(*a, act="silu"),
                               g(M, d), g(d, F), g(F, d), _meta(nb)),
        "masked_ffn_batch": _runs_ok(lambda *a: ops.masked_ffn_batch(*a, act="silu"),
                                     _meta(M, d, dtype=dtype), _meta(d, F, dtype=dtype),
                                     _meta(F, d, dtype=dtype), _meta(M, F)),
        "masked_ffn_train": _runs_ok(lambda *a: ops.masked_ffn_train(*a, act="silu"),
                                     g(1, M, d), g(1, d, F), g(1, F, d), _meta(1, M, F)),
    }


def check_ffn_tile_eligibility() -> List[Violation]:
    from repro_torch.kernels.masked_ffn import BLOCK_NEURONS
    out = []
    for (F, d), archs in sorted(_ffn_widths().items()):
        aligned = F % BLOCK_NEURONS == 0
        for dtype in (torch.float32, torch.bfloat16):
            where = (f"d_ff={F}, d_model={d}, {str(dtype)[6:]} "
                     f"({', '.join(sorted(archs))})")
            verdicts = ffn_verdicts(F, d, dtype)
            if aligned:
                out += [Violation("kernel-ffn-tiles", where,
                                  f"128-aligned width rejected by {name}: {err}")
                        for name, (ok, err) in verdicts.items() if not ok]
            elif any(ok for ok, _ in verdicts.values()):
                # kernel-ineligible width: models must keep the dense masked
                # path; the kernels must refuse loudly
                out.append(Violation(
                    "kernel-ffn-tiles", where,
                    f"width is NOT {BLOCK_NEURONS}-aligned but a masked-FFN "
                    f"kernel accepted it — the silent-dense footgun"))
    return out


def head_layouts():
    """{(H, head_dim, d_model): (arch, dtype)}, one entry per layout."""
    from repro_torch.configs.base import all_configs
    from repro_torch.models.layers import cdtype
    out = {}
    for arch, cfg in sorted(all_configs().items()):
        out.setdefault((cfg.n_heads, cfg.head_dim, cfg.d_model), (arch, cdtype(cfg)))
    return out


def head_verdicts(H, hd, d, dtype):
    """{wrapper: (ok, err)} for one head layout, C 1, forward and backward."""
    from repro_torch.kernels import ops
    g = lambda *s: _meta(*s, dtype=dtype, grad=True)
    return {"masked_head_proj": _runs_ok(ops.masked_head_proj, g(1, M, d),
                                         g(1, d, H * hd), _meta(1, H)),
            "masked_head_merge": _runs_ok(ops.masked_head_merge, g(1, M, H * hd),
                                          g(1, H * hd, d), _meta(1, H))}


def check_head_layouts() -> List[Violation]:
    """Every config's (n_heads, head_dim) projection layout runs through
    the head-masked kernels' checks."""
    out = []
    for (H, hd, d), (arch, dtype) in head_layouts().items():
        where = f"H={H}, head_dim={hd}, d_model={d} ({arch})"
        out += [Violation("kernel-head-layout", where, f"{name} rejected the layout: {err}")
                for name, (ok, err) in head_verdicts(H, hd, d, dtype).items() if not ok]
    return out


def check_mask_shape_rejection() -> List[Violation]:
    """Malformed masks must raise ValueError before anything runs."""
    from repro_torch.kernels import ops
    out = []
    d, F = 16, 256
    ffn = lambda *a: ops.masked_ffn(*a, act="silu")
    batch = lambda *a: ops.masked_ffn_batch(*a, act="silu")
    cases = [
        ("block_mask wrong length", ffn,
         (_meta(M, d), _meta(d, F), _meta(F, d), _meta(F // 128 + 1))),
        ("neuron-granular mask passed to the block-mask entry", ffn,
         (_meta(M, d), _meta(d, F), _meta(F, d), _meta(F))),
        ("row_mask wrong row count", batch,
         (_meta(M, d), _meta(d, F), _meta(F, d), _meta(M + 1, F))),
        ("misaligned hidden dim (F=200)", ffn,
         (_meta(M, d), _meta(d, 200), _meta(200, d), _meta(1))),
        ("head mask not dividing the projection (H=3 into 64)", ops.masked_head_proj,
         (_meta(1, M, d), _meta(1, d, 64), _meta(1, 3))),
    ]
    for label, fn, args in cases:
        ok, _ = _runs_ok(fn, *args)
        if ok:
            out.append(Violation("kernel-mask-shapes", label,
                                 "malformed mask was accepted silently "
                                 "(expected a ValueError)"))
    return out


# ---------------------------------------------------------------------------
# UNIT_SPECS grammar

def _get_path(tree, path):
    node = tree
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def check_unit_specs() -> List[Violation]:
    from repro_torch.core.submodel import expand_indices
    from repro_torch.models.kernel_models import KERNEL_MODELS
    from repro_torch.models.small import MODELS
    out = []
    for name, cls in {**MODELS, **KERNEL_MODELS}.items():
        params = cls.init(0, device="meta")
        for g in cls.UNIT_SPECS:
            size = g["size"]
            for role in ("out", "in"):
                for path, axis, tile in g[role]:
                    where = f"{name}:{g['name']} ({role} {path} ax{axis})"
                    leaf = _get_path(params, path)
                    if leaf is None:
                        out.append(Violation("unit-specs", where,
                                             f"path '{path}' not found in the init tree"))
                        continue
                    if not -leaf.ndim <= axis < leaf.ndim:
                        out.append(Violation("unit-specs", where,
                                             f"axis {axis} out of range for shape "
                                             f"{tuple(leaf.shape)}"))
                        continue
                    t = abs(tile)
                    if leaf.shape[axis] != size * t:
                        out.append(Violation("unit-specs", where,
                                             f"axis length {leaf.shape[axis]} != "
                                             f"size*|tile| = {size}*{t}"))
                        continue
                    # full keep must expand to a permutation of the axis
                    full = expand_indices(np.arange(size), tile, size)
                    if not np.array_equal(np.sort(full), np.arange(size * t)):
                        out.append(Violation("unit-specs", where,
                                             f"expand_indices(all, tile={tile}) is not a "
                                             f"permutation of the axis"))
                        continue
                    if tile < 0:
                        # unit-major: each unit owns |tile| contiguous slots
                        # (the attention-head layout decode_gqa relies on)
                        for u in (0, size - 1):
                            got = expand_indices(np.array([u]), tile, size)
                            want = np.arange(u * t, (u + 1) * t)
                            if not np.array_equal(got, want):
                                out.append(Violation(
                                    "unit-specs", where,
                                    f"tile={tile} unit {u} expands to {got[:4]}... "
                                    f"(want the contiguous slab {u * t}..{(u + 1) * t - 1})"))
                                break
    return out


# ---------------------------------------------------------------------------
# constants / round trips

def check_block_constants() -> List[Violation]:
    from repro_torch.kernels import masked_ffn as mffn
    from repro_torch.kernels import ops
    out = []
    if ops.BLOCK_NEURONS != mffn.BLOCK_NEURONS:
        out.append(Violation("kernel-constants", "BLOCK_NEURONS",
                             f"ops.BLOCK_NEURONS={ops.BLOCK_NEURONS} != "
                             f"masked_ffn.BLOCK_NEURONS={mffn.BLOCK_NEURONS}"))
    rng = np.random.RandomState(0)
    F = 512
    neuron = (rng.rand(F) < 0.3).astype(np.float32)
    blocks = ops.neuron_mask_to_block_mask(neuron)
    want = neuron.reshape(-1, ops.BLOCK_NEURONS).max(axis=1) > 0
    if blocks.shape != (F // ops.BLOCK_NEURONS,) or not np.array_equal(
            blocks.astype(bool), want):
        out.append(Violation("kernel-constants", "neuron_mask_to_block_mask",
                             "block mask does not keep exactly the blocks with a "
                             "surviving neuron"))
    return out


# ---------------------------------------------------------------------------
# registry and runner

KERNEL_CHECKS: Dict[str, Callable[[], List[Violation]]] = {
    "kernel-ffn-tiles": check_ffn_tile_eligibility,
    "kernel-head-layout": check_head_layouts,
    "kernel-mask-shapes": check_mask_shape_rejection,
    "unit-specs": check_unit_specs,
    "kernel-constants": check_block_constants,
}


def run_kernel_contracts(progress=None) -> List[Violation]:
    out = []
    for name, fn in KERNEL_CHECKS.items():
        if progress:
            progress(name)
        try:
            out.extend(fn())
        except Exception as e:                       # noqa: BLE001
            out.append(Violation(name, fn.__name__,
                                 f"check crashed: {type(e).__name__}: {e}"))
    return out
