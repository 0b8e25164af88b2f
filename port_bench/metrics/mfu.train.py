"""The model FLOPs of the window's train steps (harness/counts.py: kept FFN
units only, attention over the positions attended, the head; no
embedding, no recompute; 3x the forward), over the window's time, as a
share of the bf16 peak."""
from harness.peaks import BF16_FLOPS


def read(run):
    return 100.0 * run.flops / run.window_s / BF16_FLOPS if run.kind == "train" else None
