"""The traced window's model FLOPs (prefills and decoding of the completed
requests, as mfu counts them) over its length, as a share of the bf16 peak."""
from harness.peaks import BF16_FLOPS


def read(run):
    if run.kind != "serve" or run.trace is None:
        return None
    return 100.0 * run.flops / run.trace.window_s / BF16_FLOPS
