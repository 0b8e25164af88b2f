"""Device time a window step charged to the program's MLA spans (``mla.*``:
the forward's and the remat recompute's projections and attention, and
``mla.backward``), the union of those operations' intervals."""
from harness.charged import charged_ms


def read(run):
    return charged_ms(run, lambda name: name.startswith("mla."))
