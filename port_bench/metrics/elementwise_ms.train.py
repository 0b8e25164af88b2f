"""Device time a step of PyTorch's own kernels (at::native: elementwise,
foreach, reductions, copies and casts), AdamW's arithmetic among them."""


def match(name):
    return "at::native::" in name


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    steps = run.trace.count("step")
    busy = run.trace.busy_s(match)
    return 1e3 * busy / steps if steps and busy > 0 else None
