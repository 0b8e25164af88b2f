"""The masked-FFN training kernels' least time over their device time
(ffn_train_kernel_ms). A step calls the forward twice a layer (the forward
and block remat's recompute), dx and dW once; each call's least time is the
larger of its operations at the bf16 peak and its bytes at the HBM rate,
both counted from its shape and its mask's kept blocks (harness/counts.py)."""
import importlib.util
from pathlib import Path

from harness import counts
from harness.peaks import BF16_FLOPS, HBM_BYTES_PER_S

_spec = importlib.util.spec_from_file_location(
    "ffn_train_kernel_ms", Path(__file__).with_name("ffn_train_kernel_ms.py"))
_kern = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_kern)


def least_s(c, kept_blocks, M):
    total = 0.0
    for kb in kept_blocks:
        work = counts.train_kernel_work(c, kb, M)
        for name, calls in (("fwd", 2), ("dx", 1), ("dw", 1)):
            flops, nbytes = work[name]
            total += calls * max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    return total


def read(run):
    ms = _kern.read(run)
    if ms is None:
        return None
    return 100.0 * 1e3 * least_s(run.c, run.kept_blocks, run.rows_m) / ms
