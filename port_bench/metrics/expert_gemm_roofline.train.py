"""The routed experts' least time over the device time charged to
``moe.experts`` (forward and remat recompute passes) in the traced window.
Each call's least time is the larger of its kept work at the bf16 peak and
its kept units' bf16 weights read once at the HBM rate
(harness/counts_mla_moe.py): its picks from the ``moe.route`` span that
precedes it, its kept units from the masks the driver handed the program
(``expert_units``: each MoE layer's, over all its experts). Every MoE layer
runs once in the forward and once in the recompute a step, and both terms
grow with the units, so each call takes the layers' mean."""
from harness import counts_mla_moe as counts
from harness.charged import _traced, charged_s, window_spans
from harness.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def least_s(c, routes, units):
    total = 0.0
    for p in routes:
        flops, nbytes = counts.expert_gemm_work(c, p.attrs["picks"], units)
        total += max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    return total


def read(run):
    units = getattr(run, "expert_units", None)
    if not _traced(run) or not units:
        return None
    tr = run.trace
    busy = charged_s(tr, lambda name: name == "moe.experts")
    routes = window_spans(tr, "moe.route")
    if busy <= 0 or not routes or len(routes) != len(window_spans(tr, "moe.experts")):
        return None
    return 100.0 * least_s(run.c, routes, sum(units) / len(units)) / busy
