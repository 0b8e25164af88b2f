"""The model FLOPs of the window's completed requests (harness/counts.py:
each prompt's positions and the generated tokens fed back, kept FFN units
only, attention over the positions attended, the head once a generated
token; no embedding), over the window's time, as a share of the bf16 peak."""
from harness.peaks import BF16_FLOPS


def read(run):
    return 100.0 * run.flops / run.window_s / BF16_FLOPS if run.kind == "serve" else None
