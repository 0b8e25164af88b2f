"""B1's serving form's least time over its device time: per decode step and
layer, every FFN block that some live slot keeps, read once, the slots'
activations and the fp32 row mask, at the HBM rate (harness/counts.py),
from the masks of the requests live in each decode chunk."""
import importlib.util
from pathlib import Path

from harness import counts
from harness.peaks import HBM_BYTES_PER_S

_spec = importlib.util.spec_from_file_location(
    "ffn_serve_kernel_ms", Path(__file__).with_name("ffn_serve_kernel_ms.py"))
_kern = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_kern)


def read(run):
    ms = _kern.read(run)
    if ms is None:
        return None
    nbytes = sum(steps * counts.serve_ffn_bytes(run.c, blocks, run.t["slots"])
                 for steps, union in run.chunk_unions for blocks in union)
    least_ms_a_step = 1e3 * nbytes / HBM_BYTES_PER_S / run.decode_steps
    return 100.0 * least_ms_a_step / ms
