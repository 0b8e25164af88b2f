"""The traced window's model FLOPs (as mfu counts them) over its length, as
a share of the bf16 peak: the whole step's share, which bounds what any one
kernel's gain can show."""
from harness.peaks import BF16_FLOPS


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = run.trace.count("step")
    return 100.0 * steps * run.step_flops / run.trace.window_s / BF16_FLOPS if steps else None
