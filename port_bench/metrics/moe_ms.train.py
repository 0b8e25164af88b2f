"""Device time a window step charged to the program's MoE spans (``moe.*``:
the forward's and the remat recompute's route, dispatch, experts, combine
and shared experts, and ``moe.backward``), the union of those operations'
intervals; each operation charged by its launch (harness/attribution.py)."""
from harness.charged import charged_ms


def read(run):
    return charged_ms(run, lambda name: name.startswith("moe."))
