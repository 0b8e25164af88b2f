"""Three-term roofline model of a step on one NVIDIA H100 (port of
``repro/launch/roofline.py``, the card's constants in place of TPU v5e's).

  compute    = FLOPs                / peak FLOP/s of the compute dtype
  memory     = bytes                / HBM bandwidth
  collective = wire bytes           / NVLink bandwidth (0 on one card)

The reference reads FLOPs and "bytes accessed" from XLA's cost analysis of
the compiled, fused program, and parses collective wire bytes from its HLO
text. The port has no compiled program: ``count_terms(fn, *args)`` runs the
step (on the meta device in the dry-run) and counts what its aten ops do:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``: the matrix
  products (mm, bmm, addmm, baddbmm, convolutions, attention), 2 a
  multiply-add, forward and backward. Elementwise work is not counted, as
  XLA's flop count is dominated by the same dots.
* ``bytes_min`` (the floor): each argument read once, each new output
  written once, and what in-place ops write into the arguments (an
  optimizer's update, a decode step's cache slot), each argument at most
  once more. A perfectly fused step moves no fewer bytes.
* ``bytes_unfused`` (the ceiling): the sum over aten ops (views excepted)
  of their tensor inputs' and outputs' bytes: what an eager run with no
  fusion moves. XLA's fused "bytes accessed" lies between the two.
* ``peak_bytes``: the most bytes of live storages at any op, the
  arguments included (storages are tracked from their first op to their
  release): the memory a step needs, less the allocator's rounding and
  cache.

Where a hand-written kernel runs on the card, the meta run executes its
plain version: its FLOPs and temporaries are those of the plain version
(``kernels/*_plain``), which the kernel does not materialise.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM5 80GB (data sheet): dense tensor-core bf16, fp32 outside
# the tensor cores, HBM3, NVLink 4 one way (900 GB/s both ways)
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9
# exponentials: 16 a clock on each of 132 SMs, at the 1.98 GHz that the fp32
# peak implies (132 SMs x 128 lanes x 2 flops x 1.98 GHz = 67 TFLOP/s)
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# device memory when no card is present: the total_memory that torch reports
# for an H100 80GB HBM3 (cudaGetDeviceProperties; nvidia-smi says 81559 MiB)
HBM_CAPACITY = 85_017_493_504

PEAK_FLOPS = {torch.bfloat16: BF16_FLOPS, torch.float16: BF16_FLOPS,
              torch.float32: FP32_FLOPS}


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak for products computed in ``dtype``."""
    return PEAK_FLOPS.get(dtype, FP32_FLOPS)


@dataclass
class RooflineTerms:
    flops: float = 0.0
    bytes_accessed: float = 0.0     # the floor (bytes_min)
    wire_bytes: float = 0.0         # 0 on one card
    bytes_unfused: float = 0.0      # the ceiling
    peak: float = BF16_FLOPS        # FLOP/s of the compute dtype

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BYTES_PER_S

    @property
    def t_memory_unfused(self) -> float:
        return self.bytes_unfused / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / NVLINK_BYTES_PER_S

    def _worst(self, t_memory) -> str:
        terms = {"compute": self.t_compute, "memory": t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bottleneck(self) -> str:
        return self._worst(self.t_memory)

    @property
    def bottleneck_unfused(self) -> str:
        return self._worst(self.t_memory_unfused)

    def step_time(self) -> float:
        """No-overlap upper bound estimate, at the floor's bytes."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes_accessed,
                "bytes_unfused": self.bytes_unfused, "wire_bytes": self.wire_bytes,
                "peak_flops": self.peak,
                "t_compute": self.t_compute, "t_memory": self.t_memory,
                "t_memory_unfused": self.t_memory_unfused,
                "t_collective": self.t_collective,
                "bottleneck": self.bottleneck,
                "bottleneck_unfused": self.bottleneck_unfused}


def model_flops(cfg, shape, n_params_active: int) -> float:
    """6·N·D (training) / 2·N·D (inference) useful-FLOPs reference, global."""
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode" else 1)
    mult = 6.0 if shape.mode == "train" else 2.0
    return mult * n_params_active * tokens


# ---------------------------------------------------------------------------
# counting a step's aten ops

# in-place ops that write only their source into the mutated tensor
_SOURCE_ARG = {"index_put_": "values", "index_copy_": "source", "index_add_": "source",
               "scatter_": "src", "masked_scatter_": "source", "_index_put_impl_": "values"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _key(t) -> int:
    return t.untyped_storage()._cdata


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


class _ByteCounter(TorchDispatchMode):
    """Counts every aten op's bytes and tracks live storages (see the
    module's docstring)."""

    def __init__(self, args):
        super().__init__()
        self.unfused = 0
        self.live = 0
        self.peak = 0
        self._sizes: Dict[int, int] = {}
        self.arg_keys = set()
        self.arg_written: Dict[int, int] = {}
        for t in args:
            self.arg_keys.add(_key(t))
            self._track(t)

    def _track(self, t):
        st = t.untyped_storage()
        k = st._cdata
        if k in self._sizes:
            return
        self._sizes[k] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, k)

    def _free(self, k):
        self.live -= self._sizes.pop(k, 0)

    def _mutated(self, func, args, kwargs):
        """(mutated tensor, bytes it takes) of each argument an op writes."""
        out = []
        name = func._schema.name.split("::")[-1]
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            t = args[i] if i < len(args) else kwargs.get(a.name)
            if not isinstance(t, torch.Tensor):
                continue
            src = None
            if name in _SOURCE_ARG:
                j = next(n for n, b in enumerate(func._schema.arguments)
                         if b.name == _SOURCE_ARG[name])
                src = args[j] if j < len(args) else kwargs.get(_SOURCE_ARG[name])
            out.append((t, _nbytes(src) if isinstance(src, torch.Tensor) else _nbytes(t)))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        result = func(*args, **kwargs)
        if _is_view(func):
            return result
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(result) if isinstance(t, torch.Tensor)]
        self.unfused += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t, n in self._mutated(func, args, kwargs):
            k = _key(t)
            if k in self.arg_keys:
                self.arg_written[k] = min(self.arg_written.get(k, 0) + n, self._sizes[k])
        for t in outs:
            self._track(t)
        return result


def count_terms(fn, *args, peak=BF16_FLOPS, **kwargs):
    """Run ``fn(*args, **kwargs)`` and count its terms. Returns (result,
    RooflineTerms, memory), memory {'argument_bytes', 'output_bytes' (new
    outputs), 'written_bytes' (into the arguments), 'peak_bytes'}. Works on
    any device; the dry-run passes meta tensors."""
    arg_t = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
    fc = FlopCounterMode(display=False)
    with fc, _ByteCounter(arg_t) as bc:
        result = fn(*args, **kwargs)
    arg_bytes, seen = 0, set()
    for t in arg_t:
        k = _key(t)
        if k not in seen:
            seen.add(k)
            arg_bytes += t.untyped_storage().nbytes()
    out_bytes = 0
    for t in tree_leaves(result):
        if isinstance(t, torch.Tensor) and _key(t) not in bc.arg_keys and _key(t) not in seen:
            seen.add(_key(t))
            out_bytes += t.untyped_storage().nbytes()
    written = sum(bc.arg_written.values())
    terms = RooflineTerms(flops=float(fc.get_total_flops()),
                          bytes_accessed=float(arg_bytes + out_bytes + written),
                          bytes_unfused=float(bc.unfused), peak=peak)
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "written_bytes": written, "peak_bytes": bc.peak}
    return result, terms, memory
